"""Logical-axis -> mesh-axis rules, placements over a device mesh, and
the port's only collectives.

Mesh axes (:mod:`repro_torch.launch.mesh`):
  pod    inter-pod: pure data parallelism, and the axis the one-bit
         gradient exchange targets;
  data   intra-pod batch + FSDP (ZeRO-3 parameter and moment blocks);
  model  tensor and expert parallel in the reference's placements.

A placement (the port's ``PartitionSpec``) is a tuple with one entry per
dim of a tensor: ``None`` (the dim is whole on every rank), a mesh axis,
or a tuple of axes (the dim split over their product, the first axis
the major).  A dim of n split k ways is cut into blocks of ceil(n / k)
and the last blocks are padded with zeros, as GSPMD pads.  Two entries
are the port's own, for the tensor-parallel serving steps
(:mod:`repro_torch.distributed.ctx`): :class:`Heads` splits a dim of
attention heads so that no head is cut (the reference's ceil-div blocks
cut heads and GSPMD reshards at its ``constrain``; the port has no such
resharding), :class:`Parts` splits each of a dim's equal pieces laid
end to end (a GLU's ``a | g``) so that a rank holds its channels of
every piece, and :class:`Bits` splits a packed plane's words as its float
K was split, each block packed on its own.  Meshes are laid out as
``launch.mesh`` builds them (rank = the row-major index of its
coordinates), so a group's ranks are in coordinate order.

The collectives are :func:`all_gather` and :func:`all_reduce`, two of
the three that gloo runs on CUDA tensors (with ``broadcast``).  Each
takes a process group (``None``: a group of one rank, no traffic), so a
recording group (torch's ``fake`` backend) can stand in for a real one,
and counts its calls and the bytes this rank takes in from the others
(``.calls``, ``.bytes``, as the kernel wrappers count launches).  On
``meta`` tensors (a trace under ``cuda.dry_run``) they send nothing and
count nothing: they hand the collective, its group's ranks and its
result's bytes to ``cuda.record_collective``.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from repro_torch.core import bitpack
from repro_torch.kernels import cuda

DEFAULT_RULES = {"fsdp": "data", "tp": "model", "ep": "model"}


# -- collectives -----------------------------------------------------------

def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_gather(x: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's ``x`` (same shape and dtype on all), in group order."""
    n = group_size(group)
    if n == 1:
        return [x]
    x = x.contiguous()
    out = [torch.empty_like(x) for _ in range(n)]
    if x.is_meta:
        cuda.record_collective("all-gather", _ranks(group, x),
                               n * x.numel() * x.element_size())
        return out
    dist.all_gather(out, x, group=group)
    all_gather.calls += 1
    all_gather.bytes += (n - 1) * x.numel() * x.element_size()
    return out


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum ``x`` over the group, in place (``x`` must be contiguous)."""
    n = group_size(group)
    if n > 1 and x.is_meta:
        cuda.record_collective("all-reduce", _ranks(group, x),
                               x.numel() * x.element_size())
    elif n > 1:
        dist.all_reduce(x, group=group)
        all_reduce.calls += 1
        all_reduce.bytes += (n - 1) * x.numel() * x.element_size()
    return x


def _ranks(group, x: torch.Tensor) -> list:
    """The group's global ranks; a ``meta`` tensor only under
    ``cuda.dry_run``."""
    cuda.on_card(x)
    return dist.get_process_group_ranks(group)


def reset_counts() -> None:
    for f in (all_gather, all_reduce):
        f.calls = f.bytes = 0


reset_counts()


def pxor(x: torch.Tensor, group) -> torch.Tensor:
    """Bitwise-XOR all-reduce over a group: XOR has no collective, so
    all-gather the ranks' values and fold them locally, pairwise, in the
    reference's order.  The sharded engine reduces only its
    ``digest_width``-word digests this way (512 bytes at the default
    width): the buffer itself never moves."""
    g = torch.stack(all_gather(x, group))
    while g.shape[0] > 1:
        half = g.shape[0] // 2
        folded = g[:half] ^ g[half:2 * half]
        g = folded if g.shape[0] % 2 == 0 \
            else torch.cat([folded, g[2 * half:]])
    return g[0]


# -- mesh axes -------------------------------------------------------------

class Heads(NamedTuple):
    """A placement entry for a dim of whole heads split over ``axes``:
    ``n_heads`` query heads, the dim holding one entry of ``size``
    elements per ``per`` of them (``per`` 1 for queries, ``q_per_kv`` for
    keys and values).  Each rank takes ceil(n_heads / k) query heads, the
    tail ranks zero-padded; a K/V dim gives each rank the KV heads its
    query heads read, padded to the most any rank reads
    (:func:`head_blocks`)."""
    axes: Any
    n_heads: int
    size: int = 1
    per: int = 1


class Parts(NamedTuple):
    """A placement entry for a dim of ``parts`` equal pieces laid end to
    end (a GLU's concatenated ``a | g``): each piece is split over
    ``axes`` in ceil-div blocks, and a rank's block is its block of every
    piece in order, each zero-padded, so that it holds every piece of its
    channels."""
    axes: Any
    parts: int


class Bits(NamedTuple):
    """A placement entry for the word dim of packed planes whose float K
    (``k`` elements) is placed by ``inner`` (axes or :class:`Heads`):
    each rank's K block is packed on its own, into packed_width(block)
    words, its tail bits 1 as a whole plane's are."""
    inner: Any
    k: int


def head_blocks(n_heads: int, per: int, k: int, i: int) -> tuple:
    """-> (block, lo, hi) in entries of a :class:`Heads` dim for rank
    ``i`` of ``k``: its block length and the entries [lo, hi) it holds."""
    hpr = -(-n_heads // k)

    def heads(j):
        h0 = min(j * hpr, n_heads)
        return h0, min(h0 + hpr, n_heads)
    if per == 1:
        return (hpr, *heads(i))

    def kv(j):
        h0, h1 = heads(j)
        return (h0 // per, -(-h1 // per)) if h1 > h0 else (n_heads // per,) * 2
    return (max(hi - lo for lo, hi in map(kv, range(k))), *kv(i))


def _names(axes) -> tuple:
    if isinstance(axes, (Heads, Parts)):
        axes = axes.axes
    elif isinstance(axes, Bits):
        return _names(axes.inner)
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def without(axes, axis: str):
    """A placement entry with ``axis`` taken out (None if nothing is
    left)."""
    rest = tuple(a for a in _names(axes) if a != axis)
    if not rest:
        return None
    return rest[0] if len(rest) == 1 else rest


def axis_size(mesh, axes) -> int:
    return math.prod(mesh.size(mesh.mesh_dim_names.index(a))
                     for a in _names(axes))


def axis_index(mesh, axes) -> int:
    """This rank's row-major index over ``axes`` (the first the major)."""
    i = 0
    for a in _names(axes):
        i = i * axis_size(mesh, a) + mesh.get_local_rank(a)
    return i


def axis_group(mesh, axes):
    """The process group of the ranks that share this rank's coordinates
    on every axis but ``axes`` (None where that is this rank alone).  A
    group over several axes is made once per mesh, by every rank of the
    world together: take it before the first collective that needs it."""
    axes = tuple(a for a in _names(axes) if axis_size(mesh, a) > 1)
    if not axes:
        return None
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    made = mesh.__dict__.setdefault("_repro_axis_groups", {})
    if axes not in made:
        names = mesh.mesh_dim_names
        dims = [names.index(a) for a in axes]
        rest = [d for d in range(len(names)) if d not in dims]
        ranks = mesh.mesh.permute(*rest, *dims).reshape(
            -1, axis_size(mesh, axes))
        made[axes], _ = dist.new_subgroups_by_enumeration(ranks.tolist())
    return made[axes]


def batch_axes(mesh, global_batch: int):
    """Largest prefix of (pod, data) that divides the batch."""
    chosen, div = [], 1
    for a in ("pod", "data"):
        if a in mesh.mesh_dim_names:
            n = axis_size(mesh, a)
            if global_batch % (div * n) == 0:
                chosen.append(a)
                div *= n
    if not chosen:
        return None
    return tuple(chosen) if len(chosen) > 1 else chosen[0]


def data_specs(mesh, global_batch: int, has_ctx: bool = False) -> dict:
    """Placements of a train or prefill batch dict."""
    ba = batch_axes(mesh, global_batch)
    specs = {"tokens": (ba, None), "labels": (ba, None)}
    if has_ctx:
        specs["ctx"] = (ba, None, None)
    return specs


# -- placements ------------------------------------------------------------

def _extent(n: int, mesh, axes) -> tuple[int, int, int]:
    """-> (block length, start, stop) of this rank's block of a dim of
    ``n`` split over ``axes`` (or a :class:`Heads` entry); [start, stop)
    is its unpadded part."""
    return extent(n, axes, axis_size(mesh, axes), axis_index(mesh, axes))


def extent(n: int, axes, k: int, i: int) -> tuple[int, int, int]:
    """:func:`_extent` for rank ``i`` of ``k``; of a :class:`Parts` dim,
    its block of each piece (of ``n // parts``)."""
    if isinstance(axes, Parts):
        n //= axes.parts
    if isinstance(axes, Heads):
        bs, lo, hi = head_blocks(axes.n_heads, axes.per, k, i)
        return bs * axes.size, lo * axes.size, hi * axes.size
    bs = -(-n // k)
    start = min(i * bs, n)
    return bs, start, min(start + bs, n)


def _block_len(n: int, axes, mesh) -> int:
    if isinstance(axes, Bits):
        return bitpack.packed_width(_extent(axes.k, mesh, axes.inner)[0])
    return _extent(n, mesh, axes)[0] * getattr(axes, "parts", 1)


def copies(spec, mesh) -> int:
    """How many ranks hold each block: the mesh axes ``spec`` leaves out."""
    used = {a for axes in spec for a in _names(axes)}
    return math.prod(mesh.size(i) for i, a in enumerate(mesh.mesh_dim_names)
                     if a not in used)


def block_shape(shape, spec, mesh) -> tuple:
    """The shape of each rank's block of a tensor of ``shape`` (its
    padded length ``ceil(n / k)`` on every dim split ``k`` ways; a
    :class:`Heads`, :class:`Parts` or :class:`Bits` dim's own block)."""
    return tuple(_block_len(n, axes, mesh) for n, axes in
                 zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))))


def shard_bits(words: torch.Tensor, k: int, bs: int, start: int,
               stop: int) -> torch.Tensor:
    """The block of packed planes (..., Kw) of K = ``k`` whose signs are
    [start, stop) of K, padded to ``bs``, repacked on their own into
    packed_width(bs) words."""
    signs = bitpack.unpack_bits(words, k, dtype=torch.int8)
    block = signs.narrow(-1, start, stop - start)
    block = torch.nn.functional.pad(block, (0, bs - (stop - start)))
    return bitpack.pack_bits(bitpack.pad_to_word(block))


def _cut(t: torch.Tensor, dim: int, bs: int, start: int,
         stop: int) -> torch.Tensor:
    t = t.narrow(dim, start, stop - start)
    if stop - start < bs:
        pad = list(t.shape)
        pad[dim] = bs - (stop - start)
        t = torch.cat([t, t.new_zeros(pad)], dim)
    return t


def shard(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of ``t`` (a new tensor, zero-padded where the
    block runs past the end of a dim or of a :class:`Parts` piece)."""
    for dim, axes in enumerate(spec):
        if axis_size(mesh, axes) == 1:
            continue
        if isinstance(axes, Bits):
            t = shard_bits(t, axes.k, *_extent(axes.k, mesh, axes.inner))
            continue
        ext = _extent(t.shape[dim], mesh, axes)
        t = torch.cat([_cut(piece, dim, *ext) for piece in
                       t.chunk(getattr(axes, "parts", 1), dim)], dim)
    return t.clone(memory_format=torch.contiguous_format)


def unpad(block: torch.Tensor, shape, spec, mesh) -> torch.Tensor:
    """The part of this rank's block that lies inside a tensor of
    ``shape`` (a view; a :class:`Parts` dim is split in two there, the
    pieces and each piece's valid part)."""
    for dim, axes in reversed(list(enumerate(spec))):
        if axis_size(mesh, axes) > 1:
            bs, start, stop = _extent(shape[dim], mesh, axes)
            if isinstance(axes, Parts):
                block = block.unflatten(dim, (axes.parts, bs))
                dim += 1
            block = block.narrow(dim, 0, stop - start)
    return block


def _gather(block: torch.Tensor, spec, mesh, shape) -> torch.Tensor:
    x = block
    for dim, axes in enumerate(spec):
        if axis_size(mesh, axes) == 1:
            continue
        if isinstance(axes, (Heads, Parts, Bits)):
            raise NotImplementedError(
                f"a {type(axes).__name__} dim is never gathered: its "
                "ranks compute on their blocks")
        for a in reversed(_names(axes)):          # the minor axis first
            x = torch.cat(all_gather(x, axis_group(mesh, a)), dim)
        x = x.narrow(dim, 0, shape[dim])
    return x.contiguous()


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, block, spec, mesh, shape, sum_axes):
        ctx.meta = spec, mesh, sum_axes
        return _gather(block, spec, mesh, shape)

    @staticmethod
    def backward(ctx, grad):
        spec, mesh, sum_axes = ctx.meta
        g = grad.clone(memory_format=torch.contiguous_format)
        all_reduce(g, axis_group(mesh, sum_axes))
        return shard(g, spec, mesh), None, None, None, None


def gather(block: torch.Tensor, spec, mesh, shape,
           sum_axes=None) -> torch.Tensor:
    """The whole tensor of ``shape`` from every rank's block (all-gathers
    along each split dim).  Under autograd the backward sums the whole
    gradient over the ranks along ``sum_axes`` (those holding the batch's
    other blocks: each computed its share of the loss) and hands this
    rank its block of the sum."""
    return _Gather.apply(block, tuple(spec), mesh, tuple(shape), sum_axes)


class _BatchSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.clone(memory_format=torch.contiguous_format),
                          group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def batch_sum(mesh, sum_axes):
    """A function that sums a tensor over the ranks along ``sum_axes``:
    every rank gets the sum, and its gradient goes to its own summand
    alone.  A global mean built from it (``lm.loss_fn``) is the same on
    every rank, while each rank's backward yields the gradient of its own
    share; :func:`gather`'s backward then adds the shares."""
    group = axis_group(mesh, sum_axes)
    return lambda x: _BatchSum.apply(x, group)
