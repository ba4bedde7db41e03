"""Multi-pod dry-run: every (arch x input shape x production mesh) cell
traced on the ``meta`` device as one rank's program of the card, with its
memory, cost and collective analyses: the proof that the distribution
config is coherent without the cards.

    python -m repro_torch.launch.dryrun                  # every cell, one pod
    python -m repro_torch.launch.dryrun --mesh both      # and two pods
    python -m repro_torch.launch.dryrun --arch whisper-tiny \\
        --shape decode_32k --mesh multi --out /tmp/dry

Each cell builds the production mesh (``launch.mesh.make_production_mesh``:
256 or 512 ranks) over torch's ``fake`` process group as rank 0, cuts
rank 0's block of every leaf as ``meta`` tensors, and traces the cell's
step (the sharded train step, or the sharded prefill / decode of
``train.serve_step``) under ``cuda.dry_run(card=True)`` and the counter of
:mod:`repro_torch.roofline.analysis`: every dispatch with its FLOPs and
bytes, the live bytes, every collective with its group.  Nothing is
allocated and nothing is launched.  The numbers are per rank, with the
model FLOPs divided by the world, as the reference reports them; a
cell whose peak exceeds ``analysis.CARD_BYTES`` still reports ``ok`` and
gains ``"fits_card": false``.  One JSON file a cell goes to ``--out``
(``experiments/dryrun_torch``); ``roofline.report`` renders them.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

import torch
import torch.distributed as dist

import repro_torch.configs as configs
from repro_torch.configs.base import SHAPES, shape_applicable
from repro_torch.core.xnor_layers import PackedLinear
from repro_torch.distributed import sharding
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import lm
from repro_torch.roofline import analysis
from repro_torch.train import serve_step
from repro_torch.train import train_step as train_mod

I32 = torch.int32


# ---------------------------------------------------------------------------
# input specs: meta stand-ins for every model input
# ---------------------------------------------------------------------------

def input_specs(cfg, shape) -> dict:
    """Abstract inputs for one (arch, shape) cell — no device allocation."""
    b, s = shape.global_batch, shape.seq_len

    def meta(*shp, dtype=I32):
        return torch.empty(shp, dtype=dtype, device="meta")
    if shape.kind == "train":
        out = {"tokens": meta(b, s), "labels": meta(b, s)}
    elif shape.kind == "prefill":
        out = {"tokens": meta(b, s)}
    else:  # decode: one new token against a seq_len-deep cache
        out = {"tokens": meta(b, 1)}
    if cfg.n_ctx_tokens and shape.kind != "decode":
        out["ctx"] = meta(b, cfg.n_ctx_tokens, cfg.d_model,
                          dtype=torch.float32)
    return out


def default_q_chunk(cfg, shape, unroll: bool = False) -> int:
    if shape.kind in ("train", "prefill") and shape.seq_len > 8192:
        # unrolled roofline runs use few big chunks (exact costs, bounded
        # HLO size); scan runs use small chunks (bounded VMEM claim).
        return shape.seq_len // 4 if unroll else 2048
    return 0


def _blocks(tree, specs, mesh):
    """``meta`` tensors of this rank's block of every leaf of ``tree``
    (the whole leaf without a mesh)."""
    if isinstance(tree, dict):
        return {k: _blocks(tree[k], specs[k], mesh) for k in tree}
    if isinstance(tree, PackedLinear):
        return PackedLinear(_blocks(tree.pb, specs.pb, mesh),
                            _blocks(tree.beta, specs.beta, mesh), tree.k)
    if tree is None:
        return None
    if isinstance(tree, (list, tuple)):
        kids = [_blocks(t, s, mesh) for t, s in zip(tree, specs)]
        return type(tree)(*kids) if hasattr(tree, "_fields") \
            else type(tree)(kids)
    shape = tree.shape if mesh is None else \
        sharding.block_shape(tree.shape, specs, mesh)
    return torch.empty(shape, dtype=tree.dtype, device="meta")


# ---------------------------------------------------------------------------
# cell builders: (fn, args, model FLOPs)
# ---------------------------------------------------------------------------

def build_cell(cfg, shape, mesh, *, rules=None, kv_shard="auto",
               q_chunk=None, microbatch=1, grad_compress="none",
               unroll=False, acc_bf16=False, fsdp_pods=False):
    """-> (fn, args, model FLOPs of the global step): ``fn(*args)`` is one
    rank's step of the cell on ``meta`` blocks (``mesh`` None: the
    single-device step on whole leaves).  Train cells trace the float
    state; prefill and decode the serve-resident parameters (packed for
    a ``quant="xnor"`` arch, as the port serves).  ``unroll`` has no
    effect: the port's layers are always a Python loop."""
    rules = dict(rules or sharding.DEFAULT_RULES)
    if fsdp_pods and mesh is not None and "pod" in mesh.mesh_dim_names:
        # ZeRO-3 across BOTH pod and data axes: halves the per-chip
        # param/grad/optimizer floor at the cost of inter-pod (DCN-class)
        # weight all-gathers per layer.
        rules["fsdp"] = ("pod", "data")
    if rules.get("fsdp") == "off":
        # serving configuration: no FSDP — params replicated over the data
        # axis (TP-only sharding).  Kills per-layer weight all-gathers; at
        # inference there is no optimizer state so the memory cost is just
        # params/TP per chip.
        rules["fsdp"] = None
    b = shape.global_batch
    ba = None if mesh is None else sharding.batch_axes(mesh, b)
    qc = default_q_chunk(cfg, shape, unroll) if q_chunk is None else q_chunk
    ins = input_specs(cfg, shape)
    kw = {} if mesh is None else {"mesh": mesh, "rules": rules}

    if shape.kind == "train":
        state = _blocks(train_mod.abstract_state(cfg),
                        train_mod.state_pspecs(cfg, rules), mesh)
        step = torch.empty((), dtype=I32, device="meta")

        def fn(state, batch, step):
            return train_mod.train_step(
                cfg, state, batch, step, q_chunk=qc, microbatch=microbatch,
                grad_compress=grad_compress,
                acc_dtype=torch.bfloat16 if acc_bf16 else torch.float32,
                **kw)
        tokens = b * shape.seq_len
        return fn, (state, ins, step), lm.model_flops(cfg, "train", tokens)

    params = _blocks(lm.packed_abstract_params(cfg),
                     lm.packed_param_pspecs(cfg, rules, head_aligned=True),
                     mesh)
    if shape.kind == "prefill":
        def fn(params, batch):
            return serve_step.prefill_step(cfg, params, batch,
                                           s_max=shape.seq_len, q_chunk=qc,
                                           **kw)
        tokens = b * shape.seq_len
        return fn, (params, ins), lm.model_flops(cfg, "prefill", tokens)

    # decode: one token against this rank's block of the resident state
    # of depth seq_len (its batch rows and, in a tensor-parallel layer's
    # cache, the KV heads its query heads read)
    state = _blocks(lm.decode_state_spec(cfg, b, shape.seq_len,
                                         device="meta"),
                    lm.decode_state_pspecs(cfg, ba, head_aligned=True), mesh)

    def fn(params, token, state):
        return serve_step.decode_step(cfg, params, token, state, **kw)
    return fn, (params, ins["tokens"], state), lm.model_flops(cfg, "decode",
                                                              b)


def trace_cell(cfg, shape, mesh, **overrides) -> dict:
    """Trace one cell's step on ``mesh`` (None: one device) -> the
    roofline dict with ``state_bytes`` (this rank's train state, or its
    parameters for prefill and decode), ``fits_card`` and the seconds to
    build (``t_lower_s``) and trace (``t_compile_s``) it."""
    t0 = time.time()
    fn, args, model_flops = build_cell(cfg, shape, mesh, **overrides)
    t_build = time.time() - t0
    t0 = time.time()
    world = 1 if mesh is None else mesh.size()
    ctx = torch.no_grad() if shape.kind != "train" else \
        contextlib.nullcontext()
    with ctx:
        _, counter = analysis.trace(fn, *args, card=True)
    roof = analysis.roofline(counter, model_flops=model_flops / world)
    return {"n_devices": world, "t_lower_s": round(t_build, 2),
            "t_compile_s": round(time.time() - t0, 2),
            "state_bytes": analysis.tree_bytes(args[0]),
            "fits_card": roof["memory_analysis"]["peak_bytes"]
            <= analysis.CARD_BYTES, **roof}


@contextlib.contextmanager
def fake_group(world: int, rank: int = 0):
    """A process group of torch's ``fake`` backend: ``world`` ranks, this
    process ``rank``, nothing sent."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", rank=rank, world_size=world,
                            store=FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# run one cell
# ---------------------------------------------------------------------------

def run_cell(arch: str, shape_name: str, multi_pod: bool, **overrides) -> dict:
    cfg = configs.get(arch)
    kv_dtype = overrides.pop("kv_dtype", None)
    if kv_dtype:
        cfg = dataclasses.replace(cfg, kv_cache_dtype=kv_dtype)
    cap = overrides.pop("capacity_factor", None)
    if cap:
        cfg = dataclasses.replace(cfg, capacity_factor=cap)
    mlstm_chunk = overrides.pop("mlstm_chunk", None)
    if mlstm_chunk:
        cfg = dataclasses.replace(cfg, mlstm_chunk=mlstm_chunk)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name,
                "mesh": "multi" if multi_pod else "single",
                "status": "skipped", "reason": why}

    with fake_group(512 if multi_pod else 256):
        mesh = mesh_mod.make_production_mesh(multi_pod=multi_pod,
                                             device="cpu")
        res = trace_cell(cfg, shape, mesh, **overrides)
    return {
        "arch": arch, "shape": shape_name,
        "mesh": "multi" if multi_pod else "single",
        "status": "ok",
        "params": lm.param_count(cfg),
        "active_params": lm.active_param_count(cfg),
        "overrides": {k: str(v) for k, v in overrides.items()},
        **res,
    }


ALL_SHAPES = list(SHAPES)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None, help="arch id (default: all)")
    ap.add_argument("--shape", default=None, choices=ALL_SHAPES)
    ap.add_argument("--mesh", default="single", choices=["single", "multi",
                                                         "both"])
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--kv-shard", default="auto",
                    choices=["auto", "heads", "seq"],
                    help="kept for the reference's CLI, no effect: the "
                         "port splits a tensor-parallel layer's cache by "
                         "the KV heads each rank's query heads read, and "
                         "holds other kinds' state whole over model")
    ap.add_argument("--q-chunk", type=int, default=None)
    ap.add_argument("--microbatch", type=int, default=1,
                    help="train cells: the global batch split into this "
                         "many parts run one after another, each over "
                         "the mesh")
    ap.add_argument("--grad-compress", default="none",
                    choices=["none", "onebit_pod"])
    ap.add_argument("--kv-dtype", default=None, choices=[None, "bf16", "i8"])
    ap.add_argument("--acc-bf16", action="store_true",
                    help="bf16 microbatch gradient accumulator")
    ap.add_argument("--fsdp-pods", action="store_true",
                    help="shard params/optimizer over pod axis too (ZeRO-3 "
                         "across pods)")
    ap.add_argument("--fsdp-off", action="store_true",
                    help="serving config: replicate params over data axis "
                         "(TP-only)")
    ap.add_argument("--capacity-factor", type=float, default=None)
    ap.add_argument("--mlstm-chunk", type=int, default=None)
    ap.add_argument("--unroll", action="store_true",
                    help="no effect in the port: its layers are always a "
                         "Python loop, traced op by op")
    ap.add_argument("--tag", default="")
    args = ap.parse_args()

    archs = [args.arch] if args.arch else sorted(configs.ALL)
    shapes = [args.shape] if args.shape else ALL_SHAPES
    meshes = {"single": [False], "multi": [True], "both": [False, True]}
    os.makedirs(args.out, exist_ok=True)

    failures = 0
    for arch in archs:
        for shape_name in shapes:
            for mp in meshes[args.mesh]:
                tagsuf = f"_{args.tag}" if args.tag else ""
                out_path = os.path.join(
                    args.out, f"{arch}_{shape_name}_"
                    f"{'multi' if mp else 'single'}{tagsuf}.json")
                try:
                    res = run_cell(arch, shape_name, mp,
                                   kv_shard=args.kv_shard,
                                   q_chunk=args.q_chunk,
                                   microbatch=args.microbatch,
                                   grad_compress=args.grad_compress,
                                   unroll=args.unroll,
                                   kv_dtype=args.kv_dtype,
                                   capacity_factor=args.capacity_factor,
                                   mlstm_chunk=args.mlstm_chunk,
                                   acc_bf16=args.acc_bf16,
                                   fsdp_pods=args.fsdp_pods,
                                   rules=(dict(sharding.DEFAULT_RULES,
                                               fsdp="off")
                                          if args.fsdp_off else None))
                except Exception as e:  # a failing cell is a bug: report it
                    res = {"arch": arch, "shape": shape_name,
                           "mesh": "multi" if mp else "single",
                           "status": "error", "error": repr(e),
                           "traceback": traceback.format_exc()}
                    failures += 1
                with open(out_path, "w") as f:
                    json.dump(res, f, indent=2)
                line = (f"{res['status']:8s} {arch} {shape_name} "
                        f"{res['mesh']}")
                if res["status"] == "ok":
                    peak = res["memory_analysis"]["peak_bytes"]
                    line += (f"  bottleneck={res['bottleneck']}"
                             f" t=({res['t_compute_s']*1e3:.1f},"
                             f"{res['t_memory_s']*1e3:.1f},"
                             f"{res['t_collective_s']*1e3:.1f})ms"
                             f" peak={peak / 2**30:.2f}GiB"
                             f"{'' if res['fits_card'] else ' over the card'}"
                             f" trace={res['t_compile_s']:.0f}s")
                elif res["status"] == "error":
                    line += "  " + res["error"][:120]
                print(line, flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
