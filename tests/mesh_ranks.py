"""What each gloo rank of the ``test_torch_mesh_*`` tests runs.

This module imports neither JAX nor the JAX package: ``launch.mesh.
run_ranks`` spawns processes that import it by name, and each returns
numpy arrays to the test, which holds them against the reference."""

from __future__ import annotations

import numpy as np
import torch

import repro_torch.configs as configs
from repro_torch import convert
from repro_torch.core import bitpack, verify
from repro_torch.core.engine import ShardedCimEngine
from repro_torch.distributed import sharding
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import params as pdefs
from repro_torch.optim import adamw
from repro_torch.train import train_step as ttrain


def _u32(t: torch.Tensor) -> np.ndarray:
    return bitpack.to_numpy_u32(t)


# -- the sharded engine ----------------------------------------------------

def engine_cases(seed: int = 0, n_random: int = 20) -> list[dict]:
    """The reference's 8-way property sweep (random sizes up to 200,000
    words, digest widths 32/96/128/256, counters anywhere in 2^32), then
    the edges: one word, a length that is no multiple of 128, a counter
    that wraps 2^32 inside the buffer, an empty buffer.  Every case also
    takes ``digest_chunks`` at a chunk that need not be a multiple of the
    width (the engine aligns it up), 1 to ~16 rows."""
    rng = np.random.default_rng(seed)
    sizes = [int(rng.integers(1, 200_000)) for _ in range(n_random)]
    cases = []
    for n in sizes + [1, 3 * 1024 + 5, 70_001, 0]:
        width = int(rng.choice([32, 96, 128, 256]))
        ctr = int(rng.integers(0, 2**32))
        cases.append(dict(
            n=n, width=width, ctr=ctr,
            a=rng.integers(0, 2**32, n, dtype=np.uint32),
            b=rng.integers(0, 2**32, n, dtype=np.uint32),
            key=rng.integers(0, 2**32, 2, dtype=np.uint32),
            chunk=int(rng.integers(n // 16 + 1, 3 * n // 2 + 2))))
    cases[-3]["ctr"] = 2**32 - 1000          # wraps inside the buffer
    cases[-2]["ctr"] = 2**32 - 3
    return cases


def engine_rank(rank: int, world: int, seed: int, device="cpu") -> dict:
    """Every case through a ``world``-rank ShardedCimEngine on ``device``
    -> this rank's chunks of xor / xnor / ciphertext, the digests, the
    digest rows, the round trip, the cycle model and the bytes that
    crossed ranks."""
    mesh = mesh_mod.make_engine_mesh(world, device=device)
    eng = ShardedCimEngine(mesh, device=device)
    assert eng.geometry.devices == world
    sharding.reset_counts()
    out = []
    for c in engine_cases(seed):
        a, b = (bitpack.from_numpy_u32(c[k]).to(device) for k in "ab")
        key = [int(k) for k in c["key"]]
        enc = eng.stream_cipher(a, key, counter=c["ctr"])
        start, stop = eng.local_range(c["n"])
        back = eng.stream_cipher_local(enc, key, c["n"], counter=c["ctr"])
        out.append(dict(
            range=(start, stop), xor=_u32(eng.xor(a, b)),
            xnor=_u32(eng.xnor(a, b)), cipher=_u32(enc),
            round_trip=bool(torch.equal(back, a[start:stop])),
            digest=_u32(eng.digest(a, c["width"])),
            chunks=_u32(eng.digest_chunks(a, c["chunk"], c["width"]))))
    return dict(cases=out, cycles=eng.cycles_for(1 << 22),
                digest_bytes=sharding.all_gather.bytes,
                other_bytes=sharding.all_reduce.bytes)


# -- the sharded train step ------------------------------------------------

def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _blocks(tree) -> dict:
    return {verify.leaf_key(p): _np(t)
            for p, t in verify.tree_flatten_with_path(tree)}


def train_rank(rank: int, cases: dict, step: int, schedule: dict) -> dict:
    """One sharded step of each arch of ``cases`` {arch: (config
    overrides, the reference's parameters, the batch)} (smoke, f32) on
    the (pod, data, model) = (2, 2, 2) mesh -> {arch: this rank's
    gradient and updated parameter blocks (zero-padded), the metrics and
    the bytes of its state}."""
    mesh = mesh_mod.make_smoke_mesh(8, device="cpu")
    return {arch: _train_case(mesh, arch, *case, step, schedule)
            for arch, case in cases.items()}


def _train_case(mesh, arch, over, params, batch, step, schedule) -> dict:
    cfg = configs.get(arch).smoke(dtype=torch.float32, **over)
    blocks = ttrain.shard_params(cfg, convert.from_jax(cfg, params), mesh)
    state = ttrain.TrainState(blocks, adamw.init(blocks))
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    _, _, grads, _, _ = ttrain._sharded_grads(
        cfg, state.params, batch, 0, mesh, sharding.DEFAULT_RULES, False)
    nbytes = sum(t.numel() * t.element_size()
                 for _, t in verify.tree_flatten_with_path(state))
    new, metrics = ttrain.train_step(cfg, state, batch, step, **schedule,
                                     mesh=mesh)
    return dict(coord=mesh.get_coordinate(), grads=_blocks(grads),
                params=_blocks(new.params), state_bytes=nbytes,
                metrics={k: float(v) for k, v in metrics.items()})


# -- the one-bit exchange --------------------------------------------------

def onebit_rank(rank: int, pods: list, split: list) -> dict:
    """On the (2, 2, 2) mesh, every rank of pod p holding ``pods[p]`` (a
    list of whole leaves): ``_onebit_pod_allreduce`` over the pod axis ->
    the voted leaves and the bytes that crossed.  Then ``split`` [(spec,
    [pod 0's leaf, pod 1's leaf])]: ``_pod_vote`` over this rank's blocks
    of them (a leaf's L1 scale summed over the pod's other axes first)
    -> this rank's voted blocks and its mesh coordinate."""
    mesh = mesh_mod.make_smoke_mesh(8, device="cpu")
    pod = mesh.get_local_rank("pod")
    leaves = [torch.from_numpy(g).to(getattr(torch, dt))
              for g, dt in pods[pod]]
    sharding.reset_counts()
    out = ttrain._onebit_pod_allreduce(
        leaves, sharding.axis_group(mesh, "pod"))
    crossed = sharding.all_gather.bytes
    specs = [spec for spec, _ in split]
    defs = [pdefs.ParamDef(gs[pod].shape, spec) for spec, gs in split]
    blocks = [sharding.shard(torch.from_numpy(gs[pod]), spec, mesh)
              for spec, gs in split]
    voted = ttrain._pod_vote(blocks, specs, defs, mesh)
    return dict(out=[_np(t) for t in out], bytes=crossed,
                coord=mesh.get_coordinate(), voted=[_np(t) for t in voted])


def onebit_step_rank(rank: int, arch: str, batch: dict, step: int,
                     schedule: dict) -> dict:
    """One ``grad_compress="onebit_pod"`` step on a (pod, data, model) =
    (2, 1, 1) mesh from seeded parameters -> the updated parameters, the
    metrics and the bytes that crossed the pod axis."""
    cfg = configs.get(arch).smoke(dtype=torch.float32)
    mesh = mesh_mod.make_mesh((2, 1, 1), ("pod", "data", "model"), "cpu")
    state = ttrain.init_state(cfg, 0, device="cpu", mesh=mesh)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    sharding.reset_counts()
    new, metrics = ttrain.train_step(cfg, state, batch, step, **schedule,
                                     mesh=mesh, grad_compress="onebit_pod")
    return dict(params=_blocks(new.params), bytes=sharding.all_gather.bytes,
                reduced=sharding.all_reduce.bytes,
                metrics={k: float(v) for k, v in metrics.items()})


# -- the sharded serving steps ---------------------------------------------

def serve_rank(rank: int, cases: dict, s_max: int) -> dict:
    """The sharded ``prefill_step`` and two ``decode_step``s of each case
    {name: (arch, packed, rules, batch)} (smoke, f32, parameters from seed
    0) on the (pod, data, model) = (2, 2, 2) mesh, the decode tokens
    teacher-forced from ``batch["next"]`` -> {name: this rank's logits
    rows of each step, its mesh coordinate}."""
    from repro_torch.models import lm
    from repro_torch.train import serve_step
    mesh = mesh_mod.make_smoke_mesh(8, device="cpu")
    out = {}
    for name, (arch, packed, rules, batch) in cases.items():
        cfg = configs.get(arch).smoke(dtype=torch.float32)
        params = lm.init_params(cfg, 0, device="cpu")
        if packed:
            params = lm.pack_params(cfg, params)
        blocks = serve_step.shard_params(cfg, params, mesh, rules)
        del params
        data = {k: torch.from_numpy(v) for k, v in batch.items()
                if k != "next"}
        with torch.inference_mode():
            logits, state = serve_step.prefill_step(
                cfg, blocks, data, s_max, mesh=mesh, rules=rules)
            steps = [_np(logits)]
            for tok in batch["next"]:
                logits, state = serve_step.decode_step(
                    cfg, blocks, torch.from_numpy(tok), state, mesh=mesh,
                    rules=rules)
                steps.append(_np(logits))
        out[name] = dict(coord=mesh.get_coordinate(), logits=steps)
    return out
