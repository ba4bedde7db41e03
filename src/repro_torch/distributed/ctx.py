"""Ambient activation rules: the tensor- and expert-parallel context of
the sharded serving steps (the reference's ``distributed/ctx.py``).

The reference pins activations at block boundaries with ``constrain``
under an ambient rule set ``{"batch": axes, "tp": "model", "ep":
"model"}``, and GSPMD then computes each block where its weights are
placed.  The port has no compiler to honour a pin, so the parallel
layers are written out (``layers.row_linear``, the vocab-parallel
``embed`` and ``logits``, the rank's heads in ``attention``, the rank's
experts in ``moe``); they read the model axis from this context, so
model code carries no mesh plumbing.  Outside a context ``tp_size()`` is
1 and every layer runs as on one device, dispatching the same ops.

The layers of a kind with no tensor-parallel form compute on leaves
gathered whole (:func:`layers_of`); inside them ``tp_size()`` is 1 too.
Parameters reach the layers through :class:`Segment` and
:class:`Leaves`, which gather a layer's blocks over the FSDP axes (and,
for such a kind, over ``model``) just before it runs; the gathered
leaves are dropped with the layer's parameter dict.

Every collective is one of ``sharding``'s two.  A sum over ``model`` of
float partials (:func:`reduce_sum`) is taken in rank order whatever the
row count: a ring all-reduce chunks its buffer by its size, so a slot's
bits would hang on the batch (hazard H2).  Within ``GATHER_BYTES`` it is
an all-gather and a fold; past it (a prefill's activations) the ring
all-reduce.  A sum whose every element has one non-zero term (the
vocab-parallel lookup, the experts' rows) is exact in any order
(:func:`sum_exact`).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, NamedTuple

import torch

from repro_torch.core.xnor_layers import PackedLinear
from repro_torch.distributed import sharding

# the largest float partial (all ranks' copies) summed in rank order;
# past it the ring all-reduce sums in its own order
GATHER_BYTES = 64 << 20

_STATE = threading.local()


class _Rules(NamedTuple):
    rules: dict
    mesh: Any
    group: Any          # the model axis's process group (None: one rank)
    rank: int
    size: int


def _ctx() -> _Rules | None:
    return getattr(_STATE, "ctx", None)


@contextlib.contextmanager
def activation_rules(rules: dict | None, mesh=None):
    """rules: logical axis -> mesh axis, e.g. ``{"batch": ("pod", "data"),
    "tp": "model", "ep": "model"}``, over ``mesh`` (a ``DeviceMesh``);
    ``None`` leaves no context."""
    prev, whole = _ctx(), getattr(_STATE, "whole", False)
    _STATE.whole = False
    if rules is None or mesh is None:
        _STATE.ctx = None
    else:
        tp = rules.get("tp")
        _STATE.ctx = _Rules(dict(rules), mesh, sharding.axis_group(mesh, tp),
                            sharding.axis_index(mesh, tp),
                            sharding.axis_size(mesh, tp))
    try:
        yield
    finally:
        _STATE.ctx, _STATE.whole = prev, whole


@contextlib.contextmanager
def layers_of(tensor_parallel: bool):
    """Around a segment's layers: a kind without a tensor-parallel form
    (``tensor_parallel`` False) computes on whole leaves, so
    :func:`tp_size` reads 1 inside."""
    prev = getattr(_STATE, "whole", False)
    _STATE.whole = _ctx() is not None and not tensor_parallel
    try:
        yield
    finally:
        _STATE.whole = prev


def rules() -> dict | None:
    c = _ctx()
    return None if c is None else c.rules


def tp_size() -> int:
    c = _ctx()
    return 1 if c is None or _STATE.whole else c.size


def tp_rank() -> int:
    return 0 if tp_size() == 1 else _ctx().rank


def tp_group():
    return None if tp_size() == 1 else _ctx().group


def extent(n: int) -> tuple[int, int, int]:
    """This rank's ceil-div block of a dim of ``n`` over the model axis
    -> (block length, start, stop)."""
    return sharding.extent(n, None, tp_size(), tp_rank())


class HeadBlock(NamedTuple):
    """This rank's attention heads: query heads [q0, q0 + nq) of a
    ``qb``-head block, KV heads from ``kv0`` in a ``kvb``-head block."""
    q0: int
    nq: int
    qb: int
    kv0: int
    kvb: int

    def groups(self, q_per_kv: int) -> list[tuple[int, int, int]]:
        """-> [(local KV head, first local q head, end)]: the runs of
        this rank's query heads that read one KV head."""
        out = []
        for j in range(self.nq):
            kv = (self.q0 + j) // q_per_kv - self.kv0
            if out and out[-1][0] == kv:
                out[-1] = (kv, out[-1][1], j + 1)
            else:
                out.append((kv, j, j + 1))
        return out


def heads(cfg) -> HeadBlock | None:
    """This rank's heads under tensor parallelism, None without it."""
    k = tp_size()
    if k == 1:
        return None
    i = tp_rank()
    qb, q0, q1 = sharding.head_blocks(cfg.n_heads, 1, k, i)
    kvb, kv0, _ = sharding.head_blocks(cfg.n_heads, cfg.q_per_kv, k, i)
    return HeadBlock(q0, q1 - q0, qb, kv0, kvb)


# -- the model axis's sums ---------------------------------------------------

def reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum ``x`` over the model axis: within ``GATHER_BYTES`` gathered and
    folded in rank order (the same order at every row count), past it by
    the ring all-reduce."""
    if tp_size() == 1:
        return x
    if x.numel() * x.element_size() * tp_size() > GATHER_BYTES:
        return sharding.all_reduce(x.contiguous(), tp_group())
    parts = sharding.all_gather(x, tp_group())
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def sum_exact(x: torch.Tensor) -> torch.Tensor:
    """Sum over the model axis, exact in any order, of a fresh integer
    tensor, or of a float tensor each of whose rows (the last dim) comes
    from one rank, the others' rows zero: an integer sum of its bits (a
    float sum would turn a -0.0 term into 0.0).  ``x`` is summed in
    place."""
    if tp_size() == 1:
        return x
    flat = x.reshape(-1)
    pad = (-flat.numel() * flat.element_size()) % 4 // flat.element_size()
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    words = sharding.all_reduce(flat.view(torch.int32), tp_group())
    return words.view(x.dtype)[:x.numel()].reshape(x.shape)


def gather_last(x: torch.Tensor) -> torch.Tensor:
    """Every rank's block of the last dim, concatenated in rank order."""
    if tp_size() == 1:
        return x
    return torch.cat(sharding.all_gather(x, tp_group()), dim=-1)


# -- parameters a layer at a time --------------------------------------------

def _split(spec, keep: tuple) -> tuple[tuple, tuple]:
    """-> (the entries to gather, the entries kept) of a placement."""
    kept = tuple(a if sharding._names(a) and set(sharding._names(a))
                 <= set(keep) else None for a in spec)
    return (tuple(None if k is not None else a for a, k in zip(spec, kept)),
            kept)


def gather_leaf(block, spec, shape, mesh, keep: tuple = ()):
    """A leaf (a tensor or a ``PackedLinear``) gathered over every axis
    of its placement but ``keep``: whole (its ``shape``) in those dims,
    this rank's block in the kept ones."""
    if isinstance(block, PackedLinear):
        return PackedLinear(
            gather_leaf(block.pb, spec.pb, shape.pb, mesh, keep),
            gather_leaf(block.beta, spec.beta, shape.beta, mesh, keep),
            block.k)
    gather, kept = _split(spec, keep)
    if all(sharding.axis_size(mesh, a) == 1 for a in gather):
        return block
    return sharding.gather(block, gather, mesh,
                           sharding.block_shape(shape, kept, mesh))


def _inner(spec):
    """A layer-stacked leaf's placement (or shape) without its layer
    axis."""
    if isinstance(spec, PackedLinear):
        return PackedLinear(tuple(spec.pb[1:]), tuple(spec.beta[1:]), spec.k)
    return tuple(spec[1:])


class Leaves:
    """A dict of this rank's blocks whose leaves are gathered at their
    use (``[key]``) over every axis but ``keep``; ``specs`` and
    ``shapes`` are the leaves' placements and whole shapes."""

    def __init__(self, blocks: dict, specs: dict, shapes: dict, mesh,
                 keep: tuple = ()):
        self.blocks, self.specs, self.shapes = blocks, specs, shapes
        self.mesh, self.keep = mesh, keep

    def __getitem__(self, key):
        return gather_leaf(self.blocks[key], self.specs[key],
                           self.shapes[key], self.mesh, self.keep)


class Segment(Leaves):
    """A segment's layer-stacked blocks: :meth:`layer` gathers layer
    ``i``'s leaves into a new dict, dropped with it."""

    def layer(self, i: int) -> dict:
        return {key: gather_leaf(b[i], _inner(self.specs[key]),
                                 _inner(self.shapes[key]), self.mesh,
                                 self.keep)
                for key, b in self.blocks.items()}
