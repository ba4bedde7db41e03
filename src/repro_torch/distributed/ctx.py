"""Ambient activation rules: the tensor- and expert-parallel context of
the sharded serving steps and the sharded train step (the reference's
``distributed/ctx.py``).

The reference pins activations at block boundaries with ``constrain``
under an ambient rule set ``{"batch": axes, "tp": "model", "ep":
"model"}``, and GSPMD then computes each block where its weights are
placed.  The port has no compiler to honour a pin, so the parallel
layers are written out (``layers.row_linear``, the vocab-parallel
``embed`` and ``logits``, the rank's heads in ``attention``, the rank's
experts in ``moe``, the recurrent and CNN kinds' blocks in ``blocks``
and ``bcnn``); they read the model axis from this context, so
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

Under autograd (the train step) the sums carry a gradient: a sum's
backward hands each rank the whole gradient, a replicated activation
enters a rank's share through :func:`enter` (whose backward sums over
``model`` in rank order, so replicated leaves keep the same bits on
every rank), and each gather's backward sums a leaf's gradient over the
batch axes alone and hands the rank its block.
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


def snapshot() -> tuple:
    """This thread's context (the rules and :func:`layers_of`'s state),
    for :func:`restored`."""
    return _ctx(), getattr(_STATE, "whole", False)


@contextlib.contextmanager
def restored(snap: tuple):
    """Run under a :func:`snapshot`: a layer's recompute in the backward
    pass runs on autograd's thread, which has no context of its own."""
    prev = snapshot()
    _STATE.ctx, _STATE.whole = snap
    try:
        yield
    finally:
        _STATE.ctx, _STATE.whole = prev


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
#
# Each is an autograd Function, so the tensor-parallel layers train (the
# sharded train step): a rank's graph holds the same nodes in the same
# order as every other rank's, so the collectives of the backward pass
# meet in one order everywhere (autograd runs a graph's nodes in the
# reverse of their creation order).  A backward may run on autograd's
# device thread, where this module's thread-local context is unset: each
# Function keeps the group it was made under.

def _fold(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """Sum ``x`` over ``group`` (the model axis, ``size`` ranks): within
    ``GATHER_BYTES`` gathered and folded in rank order, past it by the
    ring all-reduce; ``x`` is not written."""
    if x.numel() * x.element_size() * size > GATHER_BYTES:
        return sharding.all_reduce(
            x.clone(memory_format=torch.contiguous_format), group)
    parts = sharding.all_gather(x, group)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


class _ReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size):
        return _fold(x, group, size)

    @staticmethod
    def backward(ctx, grad):
        # every rank's partial gets the whole gradient of the sum
        return grad, None, None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size):
        ctx.group, ctx.size = group, size
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        # each rank's gradient holds only its own share
        return _fold(grad, ctx.group, ctx.size), None, None


class _SumExact(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        flat = x.reshape(-1)
        pad = (-flat.numel() * flat.element_size()) % 4 \
            // flat.element_size()
        flat = torch.nn.functional.pad(flat, (0, pad)) if pad \
            else flat.clone()
        words = sharding.all_reduce(flat.view(torch.int32), group)
        return words.view(x.dtype)[:x.numel()].reshape(x.shape)

    @staticmethod
    def backward(ctx, grad):
        # a rank's terms are its own rows; its forward zeroed the others
        return grad, None


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, rank):
        ctx.block = rank * x.shape[-1], x.shape[-1]
        return torch.cat(sharding.all_gather(x, group), dim=-1)

    @staticmethod
    def backward(ctx, grad):
        i, n = ctx.block
        return grad[..., i:i + n].contiguous(), None, None


def _graph(x: torch.Tensor) -> bool:
    """Whether autograd records an op on ``x``: the Functions run only
    then; without a graph the sums run as plain ops (in place where they
    can), so the serving steps dispatch what they did."""
    return x.requires_grad and torch.is_grad_enabled()


def reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum ``x`` over the model axis: within ``GATHER_BYTES`` gathered and
    folded in rank order (the same order at every row count), past it by
    the ring all-reduce (in place on ``x`` without a graph).  The
    backward hands each rank the whole gradient."""
    if tp_size() == 1:
        return x
    if _graph(x):
        return _ReduceSum.apply(x, tp_group(), tp_size())
    if x.numel() * x.element_size() * tp_size() > GATHER_BYTES:
        return sharding.all_reduce(x.contiguous(), tp_group())
    return _fold(x, tp_group(), tp_size())


def enter(x: torch.Tensor) -> torch.Tensor:
    """A tensor replicated over the model axis as it enters the rank's
    share of a tensor-parallel computation (its heads, ``d_ff`` block,
    experts or vocab block): the identity, whose backward sums the
    gradient over the model axis in rank order (each rank's holds only
    its share), so that every rank gets the same bits."""
    if tp_size() == 1 or not _graph(x):
        return x
    return _Enter.apply(x, tp_group(), tp_size())


def sum_exact(x: torch.Tensor) -> torch.Tensor:
    """Sum over the model axis, exact in any order, of an integer tensor,
    or of a float tensor each of whose rows (the last dim) comes from one
    rank, the others' rows +0.0: an integer sum of its bits (a float sum
    would turn a -0.0 term into 0.0).  Out of place under autograd,
    whose backward hands each rank the whole gradient; without a graph
    ``x`` is summed in place."""
    if tp_size() == 1:
        return x
    if _graph(x):
        return _SumExact.apply(x, tp_group())
    flat = x.reshape(-1)
    pad = (-flat.numel() * flat.element_size()) % 4 // flat.element_size()
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    words = sharding.all_reduce(flat.view(torch.int32), tp_group())
    return words.view(x.dtype)[:x.numel()].reshape(x.shape)


def max_over(x: torch.Tensor) -> torch.Tensor:
    """The elementwise max over the model axis (exact), with no
    gradient."""
    x = x.detach()
    if tp_size() == 1:
        return x
    return torch.stack(sharding.all_gather(x, tp_group())).amax(0)


def gather_last(x: torch.Tensor) -> torch.Tensor:
    """Every rank's block of the last dim, concatenated in rank order;
    the backward takes this rank's block."""
    if tp_size() == 1:
        return x
    if _graph(x):
        return _GatherLast.apply(x, tp_group(), tp_rank())
    return torch.cat(sharding.all_gather(x, tp_group()), dim=-1)


# -- parameters a layer at a time --------------------------------------------

def _split(spec, keep: tuple) -> tuple[tuple, tuple]:
    """-> (the entries to gather, the entries kept) of a placement."""
    kept = tuple(a if sharding._names(a) and set(sharding._names(a))
                 <= set(keep) else None for a in spec)
    return (tuple(None if k is not None else a for a, k in zip(spec, kept)),
            kept)


def gather_leaf(block, spec, shape, mesh, keep: tuple = (), sum_axes=None):
    """A leaf (a tensor or a ``PackedLinear``) gathered over every axis
    of its placement but ``keep``: whole (its ``shape``) in those dims,
    this rank's block in the kept ones.  Under autograd with
    ``sum_axes`` (the axes holding the batch's other blocks) the
    backward sums the gradient over them alone and hands this rank its
    block of the gathered dims (``sharding.gather``), also where nothing
    is gathered."""
    if isinstance(block, PackedLinear):
        return PackedLinear(
            gather_leaf(block.pb, spec.pb, shape.pb, mesh, keep),
            gather_leaf(block.beta, spec.beta, shape.beta, mesh, keep),
            block.k)
    gather, kept = _split(spec, keep)
    summed = sum_axes is not None and block.requires_grad \
        and torch.is_grad_enabled() \
        and sharding.axis_size(mesh, sum_axes) > 1
    if not summed and all(sharding.axis_size(mesh, a) == 1 for a in gather):
        return block
    return sharding.gather(block, gather, mesh,
                           sharding.block_shape(shape, kept, mesh), sum_axes)


def _inner(spec):
    """A layer-stacked leaf's placement (or shape) without its layer
    axis."""
    if isinstance(spec, PackedLinear):
        return PackedLinear(tuple(spec.pb[1:]), tuple(spec.beta[1:]), spec.k)
    return tuple(spec[1:])


class Leaves:
    """A dict of this rank's blocks whose leaves are gathered at their
    use (``[key]``) over every axis but ``keep``; ``specs`` and
    ``shapes`` are the leaves' placements and whole shapes,
    ``sum_axes`` as in :func:`gather_leaf`."""

    def __init__(self, blocks: dict, specs: dict, shapes: dict, mesh,
                 keep: tuple = (), sum_axes=None):
        self.blocks, self.specs, self.shapes = blocks, specs, shapes
        self.mesh, self.keep, self.sum_axes = mesh, keep, sum_axes

    def __getitem__(self, key):
        return gather_leaf(self.blocks[key], self.specs[key],
                           self.shapes[key], self.mesh, self.keep,
                           self.sum_axes)


class Segment(Leaves):
    """A segment's layer-stacked blocks: :meth:`layer` gathers layer
    ``i``'s leaves into a new dict, dropped with it."""

    def layer(self, i: int) -> dict:
        return {key: gather_leaf(b[i], _inner(self.specs[key]),
                                 _inner(self.shapes[key]), self.mesh,
                                 self.keep, self.sum_axes)
                for key, b in self.blocks.items()}
