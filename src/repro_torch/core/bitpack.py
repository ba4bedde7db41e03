"""Bit-plane packing: the data layout of the in-memory XOR engine.

32 sign bits per word, packed LSB-first along the last axis: bit ``j`` of
word ``w`` is source position ``32*w + j``, and ``bit = 1 <=> x >= 0``
(so ``-0.0`` packs to 1 and NaN to 0), the XNOR-Net binarization.

Words are held as ``torch.int32`` tensors carrying the uint32 bits: torch's
``uint32`` lacks shifts, ``~``, ``+`` and ``sum`` on the CPU, and torch has
no popcount.  :func:`to_numpy_u32` / :func:`from_numpy_u32` convert at the
boundary with a numpy ``.view``; :func:`popcount` is a SWAR popcount on
int64 masked to 32 bits (``>>`` on int32 would sign-extend).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

WORD = 32
_MASK = 0xFFFFFFFF


def packed_width(k: int) -> int:
    """Number of 32-bit words needed for ``k`` bits."""
    return (k + WORD - 1) // WORD


def pad_to_word(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Zero-pad ``axis`` up to a multiple of 32.

    Zero pads binarize to ``+1`` under the ``x >= 0`` rule; two operands
    padded alike XOR to 0 there, and ``valid_k`` accounting removes the
    pads' ``+1`` dot contribution.
    """
    axis = axis % x.ndim
    pad = (-x.shape[axis]) % WORD
    if pad == 0:
        return x
    widths = [0, 0] * (x.ndim - 1 - axis) + [0, pad]
    return F.pad(x, widths)


def as_int32(words: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 tensor with the same 32 bits."""
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def pack_bits(x: torch.Tensor) -> torch.Tensor:
    """Pack the sign bits of ``x`` (..., K), K % 32 == 0, into (..., K/32)
    int32 words (uint32 bits)."""
    k = x.shape[-1]
    if k % WORD != 0:
        raise ValueError(f"last axis {k} not a multiple of {WORD}; pad first")
    bits = x if x.dtype == torch.bool else x >= 0
    bits = bits.reshape(*x.shape[:-1], k // WORD, WORD).to(torch.int64)
    shifts = torch.arange(WORD, dtype=torch.int64, device=x.device)
    return as_int32((bits << shifts).sum(-1))


def unpack_bits(p: torch.Tensor, k: int | None = None, signed: bool = True,
                dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`pack_bits`: (..., Kw) words -> (..., k) values,
    ±1 (``signed``) or {0, 1}; ``k`` defaults to all ``32 * Kw`` bits."""
    full = p.shape[-1] * WORD
    k = full if k is None else k
    shifts = torch.arange(WORD, dtype=torch.int32, device=p.device)
    bits = (p.to(torch.int32)[..., :, None] >> shifts) & 1
    bits = bits.reshape(*p.shape[:-1], full)[..., :k]
    if signed:
        return (2 * bits - 1).to(dtype)
    return bits.to(dtype)


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Per-word popcount of int32 words (uint32 bits) -> int64 counts."""
    v = words.to(torch.int64) & _MASK
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & _MASK) >> 24


def mean_abs(x: torch.Tensor) -> torch.Tensor:
    """mean(|x|) over the last axis, in f32 (the XNOR-Net scale).

    Written as ``sum * (1/K)``, the form XLA's CPU mean takes, so the
    plain path matches the JAX reference bitwise wherever the two sums
    agree."""
    return x.abs().float().sum(-1) * (1.0 / x.shape[-1])


def binarize(x: torch.Tensor):
    """XNOR-Net binarization of the last axis -> (planes, f32 alpha) with
    ``alpha = mean(|x|)`` taken in ``x.dtype`` as the reference does."""
    alpha = mean_abs(x).to(x.dtype).float()
    return pack_bits(pad_to_word(x)), alpha


def to_numpy_u32(words: torch.Tensor) -> np.ndarray:
    """int32 word tensor -> numpy uint32 array with the same bits."""
    return words.detach().cpu().numpy().view(np.uint32)


def from_numpy_u32(words: np.ndarray) -> torch.Tensor:
    """numpy uint32 array -> int32 word tensor with the same bits."""
    return torch.from_numpy(np.ascontiguousarray(words, np.uint32)
                            .view(np.int32).copy())
