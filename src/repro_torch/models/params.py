"""Parameter declarations: one tree of :class:`ParamDef` per model, from
which :func:`init` draws real tensors, :func:`pack` derives the packed
serve form and :func:`pspecs` the placement over a mesh.  Trees are nested
dicts whose leaves are tensors (or
:class:`~repro_torch.core.xnor_layers.PackedLinear` after packing), with
the same key names and layouts as the JAX package's parameter trees.

Logical axes of a ``spec`` (mapped to mesh axes by the rules of
:mod:`repro_torch.distributed.sharding`):
  "fsdp"   parameter blocks over the data axis (ZeRO-3)
  "tp"     tensor parallel over the model axis (heads / d_ff / vocab)
  "ep"     expert parallel over the model axis
  None     whole

A leaf whose "tp" dim holds attention heads says so (``heads``); under
``head_aligned`` placements (the tensor-parallel serving steps) that dim
is split into whole heads (``sharding.Heads``), a dim of concatenated
pieces into each piece's block (``sharding.Parts``), and a packed plane
whose
K is split over the model axis packs each rank's K block on its own
(``sharding.Bits``).
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core import xnor_layers
from repro_torch.distributed.sharding import Bits, Heads, Parts


class ParamDef(NamedTuple):
    shape: tuple
    spec: tuple             # logical axis per dim ("fsdp"/"tp"/"ep"/None)
    dtype: Any = torch.float32
    init: str = "normal"    # "normal" | "zeros" | "ones" | "embed"
    scale: float | None = None  # None => 1/sqrt(fan_in)
    binarize: bool = False  # binarizable linear: packed to sign planes for
                            # serving under quant="xnor" (norms, embeddings
                            # and the lm head stay full precision)
    heads: tuple | None = None  # (n_heads, d_head, q heads an entry) of a
                            # "tp" dim of heads (q_per_kv for K / V)
    parts: int = 1          # a "tp" dim of this many equal pieces laid
                            # end to end (a GLU's a | g)


def tree_map(fn: Callable, tree, *rest):
    """Map over the leaves of nested dicts (``rest`` trees share keys)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def abstract(defs) -> dict:
    """The tree's shapes and dtypes as tensors on the ``meta`` device: a
    structure to restore into that allocates nothing."""
    return tree_map(lambda d: torch.empty(d.shape, dtype=d.dtype,
                                          device="meta"), defs)


def logical_specs(defs) -> dict:
    return tree_map(lambda d: d.spec, defs)


def _spec(d: ParamDef, rules: dict, head_aligned: bool) -> tuple:
    def one(a):
        if a is None:
            return None
        if a == "tp" and head_aligned and d.heads is not None:
            return Heads(rules.get(a), *d.heads)
        if a == "tp" and head_aligned and d.parts > 1:
            return Parts(rules.get(a), d.parts)
        return rules.get(a)
    return tuple(map(one, d.spec))


def pspecs(defs, rules: dict[str, Any], head_aligned: bool = False) -> dict:
    """Each leaf's placement: a tuple with one entry per dim, the mesh axis
    (a name, a tuple of names, or None for whole) that ``rules`` maps its
    logical axis to; the port's ``PartitionSpec``.  ``head_aligned``
    splits a dim of heads into whole heads."""
    return tree_map(lambda d: _spec(d, rules, head_aligned), defs)


def init(defs, generator: torch.Generator, device) -> dict:
    """Draw every parameter: normal * (1/sqrt(fan_in)) by default, 1.0 for
    embeddings and vectors, as the JAX package scales them.  Leaves are
    drawn in sorted-key order from ``generator``."""
    def one(d: ParamDef):
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=d.dtype, device=device)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=d.dtype, device=device)
        if d.scale is not None:
            s = d.scale
        elif d.init == "embed" or len(d.shape) < 2:
            s = 1.0
        else:
            s = 1.0 / math.sqrt(d.shape[-2])   # stacked weights: (n, K, N)
        w = torch.randn(d.shape, generator=generator, dtype=d.dtype,
                        device=device)
        return w.mul_(s)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        return one(t)
    return walk(defs)


def pack(defs, tree) -> dict:
    """Replace every ``binarize``-marked float leaf by its packed form; the
    float weight leaves the tree.  Leaves already packed pass through."""
    def one(d: ParamDef, w):
        if d.binarize and not isinstance(w, xnor_layers.PackedLinear):
            return xnor_layers.pack_linear(w)
        return w
    return tree_map(one, defs, tree)


def pack_abstract(defs) -> dict:
    """The tree :func:`pack` gives, as ``meta`` tensors: every
    ``binarize``-marked leaf a ``PackedLinear`` of (..., N, Kw) int32
    planes (the reference's uint32 words) and (..., N) f32 beta."""
    from repro_torch.core import bitpack

    def one(d: ParamDef):
        if not d.binarize:
            return torch.empty(d.shape, dtype=d.dtype, device="meta")
        *lead, k, n = d.shape
        kw = bitpack.packed_width(k)
        return xnor_layers.PackedLinear(
            torch.empty((*lead, n, kw), dtype=torch.int32, device="meta"),
            torch.empty((*lead, n), dtype=torch.float32, device="meta"), k)
    return tree_map(one, defs)


def shapes(defs, packed: bool = False) -> dict:
    """Each leaf's whole shape (a ``PackedLinear`` of the planes' and
    beta's shapes for a ``binarize`` leaf when ``packed``): the tree's
    geometry with no tensor, not even a ``meta`` one."""
    from repro_torch.core import bitpack

    def one(d: ParamDef):
        if not (packed and d.binarize):
            return tuple(d.shape)
        *lead, k, n = d.shape
        return xnor_layers.PackedLinear(
            (*lead, n, bitpack.packed_width(k)), (*lead, n), k)
    return tree_map(one, defs)


def pack_pspecs(defs, rules: dict[str, Any],
                head_aligned: bool = False) -> dict:
    """Placements of :func:`pack`'s tree: a packed leaf's planes (...,
    N, Kw) and beta (..., N) keep the float weight's axes for N and K;
    under ``head_aligned`` a K split over the model axis packs each
    block on its own (``sharding.Bits``)."""
    def one(d: ParamDef):
        spec = _spec(d, rules, head_aligned)
        if not d.binarize:
            return spec
        *lead, k, n = spec
        if head_aligned and d.spec[-2] == "tp":
            k = Bits(k, d.shape[-2])
        return xnor_layers.PackedLinear((*lead, n, k), (*lead, n),
                                        d.shape[-2])
    return tree_map(one, defs)


def count(defs) -> int:
    return sum(math.prod(d.shape) for d in leaves(defs))
