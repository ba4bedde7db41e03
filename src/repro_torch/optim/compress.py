"""1-bit sign gradient compression with error feedback.

Each leaf travels as sign(g + e), packed 32 signs a word
(:func:`core.bitpack.pack_bits`), and one f32 scale, mean |g + e|; the
residual e keeps the quantization error, so the compressed sum tracks
the true one over steps (EF-signSGD, Karimireddy et al., 2019).  The
planes are bit for bit the JAX package's.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core import bitpack, verify


class CompressState(NamedTuple):
    error: dict   # residual per leaf (f32)


def init(params) -> CompressState:
    return CompressState(verify.tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params))


def abstract(params) -> CompressState:
    return CompressState(verify.tree_map(
        lambda p: torch.empty(p.shape, dtype=torch.float32, device="meta"),
        params))


def compress_leaf(g: torch.Tensor, e: torch.Tensor):
    """g -> (planes int32 words, scale f32 scalar, new error):
    approx = scale * sign(g + e), e' = (g + e) - approx."""
    corrected = g.float() + e
    scale = corrected.abs().mean()
    flat = corrected.reshape(-1)
    planes = bitpack.pack_bits(bitpack.pad_to_word(flat))
    approx = scale * torch.where(flat >= 0, 1.0, -1.0)
    return planes, scale, (flat - approx).reshape(g.shape)


def decompress_leaf(planes: torch.Tensor, scale: torch.Tensor, shape,
                    dtype) -> torch.Tensor:
    signs = bitpack.unpack_bits(planes, math.prod(shape))
    return (scale * signs).reshape(shape).to(dtype)


def _leaves(tree) -> list:
    return [leaf for _, leaf in verify.tree_flatten_with_path(tree)]


def compress_grads(grads, state: CompressState):
    """-> (a tree of (planes, scale) pairs shaped like ``grads``, the new
    state)."""
    out, errs = [], []
    for g, e in zip(_leaves(grads), _leaves(state.error)):
        planes, scale, ne = compress_leaf(g, e)
        out.append((planes, scale))
        errs.append(ne)
    it, eit = iter(out), iter(errs)
    return (verify.tree_map(lambda _: next(it), grads),
            CompressState(verify.tree_map(lambda _: next(eit), grads)))


def decompress_grads(compressed, like):
    """Inverse of :func:`compress_grads` into ``like``'s shapes and
    dtypes."""
    pairs = iter(_pairs(compressed))
    return verify.tree_map(
        lambda g: decompress_leaf(*next(pairs), g.shape, g.dtype), like)


def _pairs(tree) -> list:
    """The (planes, scale) pairs of a compressed tree in leaf order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _pairs(tree[k])]
    return [tree]
