"""Three-term roofline of one rank's program, traced on the ``meta`` device.

  compute term    = sum over dispatches of its operations / its peak rate
  memory term     = bytes the dispatches move / HBM_BW
  collective term = sum over collectives of link bytes / the group's link

The port has no compiler to read costs from: :class:`Counter`, a
``TorchDispatchMode``, watches a callable run on ``meta`` tensors under
``cuda.dry_run`` (the branches the card takes, or the CPU's), allocating
and launching nothing.  For every aten op that moves data it counts one
dispatch, its FLOPs (``torch.utils.flop_counter``'s registry) and its
bytes (operands read plus results written); views, ``empty*`` and
metadata ops are not counted.  A kernel wrapper on ``meta`` hands it one
launch with the kernel's ``cost`` (one dispatch, as a ``pallas_call``
is one in the reference's ``dispatch_count``), and the collectives of
``distributed.sharding`` hand it their group and result bytes, which
take the reference's ring factors (:data:`_FACTORS`).  Live bytes are
followed through the storages' finalizers: the arguments' bytes, the
results', and the peak over the trace.

Hardware constants are module-level so a sweep can change them.  They
are NVIDIA's datasheet figures for the H100 SXM5 80GB HBM3 at its 700 W
power limit, not readings.
"""

from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import cuda

# H100 SXM5 80GB HBM3, 700 W, NVIDIA's datasheet (not readings): dense
# bf16 tensor-core peak
PEAK_FLOPS = 989e12
# the same card's peaks by operand type: "f32" is the CUDA-core rate (no
# TF32), also taken for the word-wise integer ops (XOR, multiply) of the
# streaming kernels; "int8" the tensor cores' rate, taken for the binary
# (XNOR-popcount) products
PEAK_OPS = {"bf16": 989e12, "f32": 67e12, "int8": 1979e12}
HBM_BW = 3.35e12              # bytes/s, the same datasheet
NVLINK_BW = 450e9             # bytes/s a direction a card, NVLink 4, for a
                              # group inside one 8-card node (datasheet)
NET_BW = 50e9                 # bytes/s a card (400 Gb/s), a group that
                              # spans nodes (datasheet's network port)
NODE_CARDS = 8                # cards a node: ranks r // 8 share NVLink
CARD_BYTES = 80 * 2 ** 30     # the card's 80 GB of HBM3 (datasheet)

# result-size multipliers per op for per-chip ring traffic, as a function of
# group size n:  bytes_moved = factor(n) * result_bytes
_FACTORS = {
    "all-reduce":         lambda n: 2.0 * (n - 1) / n,
    "all-gather":         lambda n: (n - 1) / n,       # result is gathered
    "reduce-scatter":     lambda n: float(n - 1),      # result is the shard
    "all-to-all":         lambda n: (n - 1) / n,
    "collective-permute": lambda n: 1.0,
}

_ALLOC = {"empty", "empty_like", "empty_strided", "new_empty",
          "new_empty_strided", "_unsafe_view", "lift_fresh", "alias",
          "set_", "resize_", "_reshape_alias", "detach", "detach_",
          "sym_size",
          "sym_stride", "sym_numel", "sym_storage_offset", "is_same_size",
          "_local_scalar_dense", "_has_compatible_shallow_copy_type",
          "record_stream"}
# read only what they pick: bytes = indices + picked values read + written
_GATHER = {"embedding", "index_select", "index", "gather", "take"}
# write into part of their first operand: it is not read
_SCATTER = {"index_put_", "_index_put_impl_", "index_copy_", "scatter_",
            "copy_", "fill_", "zero_", "masked_fill_"}
_PEAK_OF = {torch.bfloat16: "bf16", torch.float16: "bf16",
            torch.float32: "f32", torch.float64: "f32", torch.int8: "int8"}


def _nbytes(t: torch.Tensor) -> int:
    """Bytes a dispatch reads or writes of ``t``: its elements, at most
    its storage (a broadcast view is read once)."""
    n = t.numel() * t.element_size()
    return min(n, t.untyped_storage().nbytes())


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    if hasattr(tree, "__slots__"):             # PackedLinear
        return [t for s in tree.__slots__ for t in _tensors(getattr(tree, s))]
    return []


def tree_bytes(tree) -> int:
    """Bytes of the distinct storages under ``tree``."""
    seen = {}
    for t in _tensors(tree):
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


class Counter(TorchDispatchMode):
    """What one rank's program dispatches, traced on ``meta``: enter it
    (with ``cuda.recording(counter)``; :func:`trace` does both) around
    the call.  ``dispatches``, ``flops``, ``bytes``, ``compute_s`` (each
    op's time at its own peak), ``kernels`` (launches, bytes and
    operations a wrapper's kernel), ``collectives`` (count and link bytes
    a kind), ``collective_s``, and the live bytes: ``argument_bytes``,
    ``peak_bytes``, ``output_bytes`` (after :meth:`outputs`)."""

    def __init__(self, args=()):
        super().__init__()
        self.dispatches = 0
        self.flops = 0.0
        self.bytes = 0.0
        self.compute_s = 0.0
        self.ops: dict[str, int] = {}
        self.kernels: dict[str, dict] = {}
        self.collectives: dict[str, dict] = {}
        self.collective_s = 0.0
        self._live: dict[int, int] = {}
        self._arg_keys: set[int] = set()
        self.live_bytes = self.peak_bytes = 0
        for t in _tensors(args):
            self._arg_keys.add(self._track(t))
        self.argument_bytes = self.live_bytes
        self.peak_bytes = self.live_bytes
        self.output_bytes = 0

    # -- live bytes ----------------------------------------------------------

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def _track(self, t: torch.Tensor) -> int:
        st = t.untyped_storage()
        key = st._cdata
        if key not in self._live:
            n = st.nbytes()
            self._live[key] = n
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._free, key)
        return key

    def outputs(self, out) -> None:
        """Count the results' storages the trace made."""
        keys = {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
                for t in _tensors(out)}
        self.output_bytes = sum(n for k, n in keys.items()
                                if k not in self._arg_keys)

    # -- dispatches ----------------------------------------------------------

    def _op(self, name: str) -> None:
        self.dispatches += 1
        self.ops[name] = self.ops.get(name, 0) + 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        for t in outs:
            self._track(t)
        name = func._overloadpacket.__name__
        if func.is_view or name in _ALLOC:
            return out
        ins = _tensors((args, kwargs))
        if name in _GATHER:
            idx = [t for t in ins if not t.is_floating_point()
                   and t is not ins[0]]
            moved = sum(_nbytes(t) for t in idx) + 2 * sum(
                _nbytes(t) for t in outs)
        elif name in _SCATTER:
            moved = sum(_nbytes(t) for t in ins[1:]) + sum(
                _nbytes(t) for t in outs)
        else:
            moved = sum(_nbytes(t) for t in ins) + sum(
                _nbytes(t) for t in outs)
        self._op(name)
        self.bytes += moved
        packet = func._overloadpacket
        if packet in flop_registry:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
            self.flops += flops
            dtype = ins[0].dtype if ins else torch.float32
            self.compute_s += flops / PEAK_OPS[_PEAK_OF.get(dtype, "f32")]
        return out

    # -- the sink of cuda.recording --------------------------------------------

    def kernel(self, name: str, cost: cuda.Cost) -> None:
        self._op(name)
        k = self.kernels.setdefault(name, {"launches": 0, "bytes": 0.0,
                                           "ops": 0.0})
        k["launches"] += 1
        k["bytes"] += cost.bytes
        k["ops"] += cost.ops
        self.bytes += cost.bytes
        self.compute_s += cost.ops / PEAK_OPS[cost.kind]

    def collective(self, kind: str, ranks: list, result_bytes: int) -> None:
        n = len(ranks)
        if n <= 1:
            return
        moved = _FACTORS[kind](n) * result_bytes
        c = self.collectives.setdefault(kind, {"count": 0, "bytes": 0.0})
        c["count"] += 1
        c["bytes"] += moved
        one_node = len({r // NODE_CARDS for r in ranks}) == 1
        self.collective_s += moved / (NVLINK_BW if one_node else NET_BW)

    @property
    def collective_bytes(self) -> float:
        return sum(c["bytes"] for c in self.collectives.values())


def trace(fn, *args, card: bool = True, **kwargs):
    """Run ``fn(*args, **kwargs)`` on ``meta`` arguments under
    ``cuda.dry_run(card)`` and a :class:`Counter` -> (its result, the
    counter).  Nothing is allocated and nothing is launched."""
    counter = Counter((args, kwargs))
    with cuda.dry_run(card), cuda.recording(counter), counter:
        out = fn(*args, **kwargs)
    counter.outputs(out)
    return out, counter


def roofline(counter: Counter, model_flops: float | None = None) -> dict:
    """The three terms and the bottleneck of a traced program, under the
    reference's keys (its ``hlo_*`` are the traced dispatches': the aten
    ops' FLOPs and the kernels' operations), with the dispatch count and
    the kernels' launches beside them."""
    flops = counter.flops + sum(k["ops"] for k in counter.kernels.values())
    t_compute = counter.compute_s
    t_memory = counter.bytes / HBM_BW
    t_collective = counter.collective_s
    terms = {"compute": t_compute, "memory": t_memory,
             "collective": t_collective}
    bottleneck = max(terms, key=terms.get)
    out = {
        "hlo_flops_per_chip": flops,
        "hlo_bytes_per_chip": counter.bytes,
        "collective_bytes_per_chip": counter.collective_bytes,
        "collectives": {k: dict(v) for k, v in
                        sorted(counter.collectives.items())},
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_collective,
        "bottleneck": bottleneck,
        "bound_time_s": max(terms.values()),
        "memory_analysis": {
            "argument_bytes": counter.argument_bytes,
            "output_bytes": counter.output_bytes,
            "temp_bytes": counter.peak_bytes - counter.argument_bytes,
            "peak_bytes": counter.peak_bytes,
        },
        "dispatches": counter.dispatches,
        "kernels": {k: dict(v) for k, v in sorted(counter.kernels.items())},
    }
    if model_flops:
        out["model_flops_per_chip"] = model_flops
        out["useful_flops_frac"] = model_flops / flops if flops else 0.0
        # roofline fraction: useful work per chip over the machine-bound time
        out["roofline_frac"] = (model_flops / PEAK_FLOPS
                                / max(max(terms.values()), 1e-30))
    return out


def dispatch_count(fn, *args, card: bool = True, **kwargs) -> int:
    """Dispatches of ``fn(*args, **kwargs)`` traced on ``meta`` arguments:
    each aten op that moves data is one, and so is each kernel launch,
    however much work it folds in.  The metric behind "fused decode is
    one dispatch where the chain was N"."""
    return trace(fn, *args, card=card, **kwargs)[1].dispatches


def decode_roofline_bytes(*, param_bytes: int, widths: dict,
                          layers_per_class: dict, slots: int,
                          block_size: int, n_kv_heads: int, d_head: int,
                          kv_itemsize: int, io_bytes: int = 0) -> int:
    """Analytic minimum HBM bytes for one paged decode step.

    A decode step cannot move less than: every live parameter byte once
    (batch=slots shares one weight read), plus one streaming pass over the
    table-addressed K/V working set — per paged layer, ``slots`` tables of
    ``W`` blocks of ``block_size x n_kv_heads x d_head`` elements, K and V
    (the x2).  ``io_bytes`` covers tokens/logits/state I/O (small).  The
    achieved/roofline ratio compares the traced program's bytes against
    this floor — gather materialization, score round-trips and scatter
    copies all show up as achieved bytes above it.
    """
    kv = 0
    for cls, w in widths.items():
        kv += (layers_per_class.get(cls, 0) * slots * w * block_size
               * n_kv_heads * d_head * kv_itemsize * 2)
    return int(param_bytes + kv + io_bytes)


def format_row(name: str, r: dict) -> str:
    mf = r.get("roofline_frac")
    return (f"| {name} | {r['t_compute_s']*1e3:.2f} | {r['t_memory_s']*1e3:.2f}"
            f" | {r['t_collective_s']*1e3:.2f} | {r['bottleneck']}"
            f" | {r.get('useful_flops_frac', 0) * 100:.0f}%"
            f" | {(mf or 0) * 100:.1f}% |")
