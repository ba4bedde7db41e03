"""``grad_compress="onebit_pod"`` over gloo ranks on the CPU.

- The exchange itself, ``train_step._onebit_pod_allreduce`` over the pod
  axis of the (pod, data, model) = (2, 2, 2) mesh, against the
  reference's on the same 2 x 2 x 2 grid of host devices (a subprocess,
  as ``tests/test_distributed.py`` runs it): bitwise on leaves whose
  values are multiples of 2^-6 (every order of their L1 sum is exact),
  signs bitwise and magnitudes within one f32 ulp (the L1 sums run in
  another order) on normal draws; f32 and bf16, a length that is no
  multiple of 32, exact zeros.  Only the planes and one scalar a leaf
  cross the pod axis.  In the same ranks, the vote over gradient blocks
  split across a pod's data and model axes (``_pod_vote``, ragged
  blocks) against the vote written out on the whole leaves.
- One step on a (2, 1, 1) mesh against the plain composition: each pod's
  gradients on its half of the batch from the single-process step,
  the majority vote written out with ``where`` and ``sign``, then
  AdamW; parameters and metrics bit for bit.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from mesh_ranks import onebit_rank, onebit_step_rank
import repro_torch.configs as configs
from repro_torch.data import synthetic
from repro_torch.launch import mesh as mesh_mod
from repro_torch.optim import adamw
from repro_torch.train import train_step as ttrain

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCHEDULE = dict(peak_lr=3e-3, warmup=10, total=100)
STEP = 12

# (shape, dtype, dyadic): dyadic leaves hold multiples of 2^-6
LEAVES = [((4, 64), "float32", True), ((256,), "bfloat16", True),
          ((5, 37), "float32", False), ((64, 16), "bfloat16", False),
          ((3, 32), "float32", False)]


def _pods(seed: int = 3) -> list:
    rng = np.random.default_rng(seed)
    pods = [[], []]
    for shape, dt, dyadic in LEAVES:
        for pod in pods:
            g = (rng.integers(-100, 101, shape) / 64.0 if dyadic
                 else rng.standard_normal(shape)).astype(np.float32)
            g.reshape(-1)[:3] = 0.0                  # sign(0) votes +1
            if dt == "bfloat16":                     # bf16-exact values
                g = torch.from_numpy(g).bfloat16().float().numpy()
            pod.append((g, dt))
    return pods


def _reference(pods, tmp_path) -> list:
    """The reference's exchange on 8 host devices -> pod 0's output."""
    src = tmp_path / "pods.npz"
    np.savez(src, **{f"p{p}_{i}": g for p, pod in enumerate(pods)
                     for i, (g, _) in enumerate(pod)})
    code = textwrap.dedent(f"""
        import jax, jax.numpy as jnp, numpy as np
        from jax.sharding import PartitionSpec as P
        from repro.distributed import sharding
        from repro.launch import mesh as mesh_mod
        from repro.train.train_step import _onebit_pod_allreduce
        d = np.load({str(src)!r})
        dts = {[dt for _, dt, _ in LEAVES]!r}
        grads = [jnp.stack([d[f"p0_{{i}}"], d[f"p1_{{i}}"]]).astype(dt)
                 for i, dt in enumerate(dts)]
        mesh = mesh_mod.make_smoke_mesh(8)
        f = sharding.shard_map(
            _onebit_pod_allreduce, mesh, in_specs=([P("pod")] * len(dts),),
            out_specs=[P("pod")] * len(dts),
            manual_axes=set(mesh.axis_names))
        with mesh:
            out = jax.jit(f)(grads)
        np.savez({str(tmp_path / "out.npz")!r},
                 **{{f"o{{i}}": np.asarray(o[0], np.float32)
                    for i, o in enumerate(out)}})
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable, "-c", code], env=env, timeout=600,
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-3000:]
    out = np.load(tmp_path / "out.npz")
    return [out[f"o{i}"] for i in range(len(LEAVES))]


# (spec, shape) of the leaves voted in blocks: ragged over both axes
SPLIT = [(("data", "model"), (5, 9)), ((None, "data"), (4, 7)),
         ((None,), (6,))]


def _split(seed: int = 4) -> list:
    rng = np.random.default_rng(seed)
    return [(spec, [rng.standard_normal(shape).astype(np.float32)
                    for _ in range(2)]) for spec, shape in SPLIT]


def _block(full: np.ndarray, spec, coord) -> np.ndarray:
    """The block of ``full`` that (pod, data, model) ``coord`` holds, on
    a mesh of 2 a side, zero-padded."""
    axes = {"pod": 0, "data": 1, "model": 2}
    for dim, a in enumerate(spec):
        if a is None:
            continue
        n = full.shape[dim]
        bs = -(-n // 2)
        lo = min(coord[axes[a]] * bs, n)
        hi = min(lo + bs, n)
        full = np.take(full, np.arange(lo, hi), axis=dim)
        pad = [(0, 0)] * full.ndim
        pad[dim] = (0, bs - (hi - lo))
        full = np.pad(full, pad)
    return full


def test_onebit_exchange_is_bitwise_the_references(tmp_path):
    pods, split = _pods(), _split()
    want = _reference(pods, tmp_path)
    ranks = mesh_mod.run_ranks(onebit_rank, 8, pods, split, device="cpu")
    planes = sum(4 * -(-int(np.prod(s)) // 32) + 4 for s, _, _ in LEAVES)
    for r in ranks:
        assert r["bytes"] == planes        # one pod's planes + scales in
        for got, w, (_, _, dyadic) in zip(r["out"], want, LEAVES):
            assert got.shape == w.shape
            np.testing.assert_array_equal(np.sign(got), np.sign(w))
            if dyadic:
                np.testing.assert_array_equal(got, w)
            else:
                np.testing.assert_allclose(got, w, rtol=2 ** -23, atol=0)
            assert len(np.unique(np.abs(got))) == 1
        for (spec, gs), got in zip(split, r["voted"]):
            whole = [torch.from_numpy(g) for g in gs]
            want_v = _vote([[g] for g in whole])[0].numpy()
            w = _block(want_v, spec, r["coord"])
            assert got.shape == w.shape
            np.testing.assert_array_equal(np.sign(got), np.sign(w))
            np.testing.assert_allclose(got, w, rtol=2 ** -22, atol=0)


def _vote(pods_grads: list) -> list:
    """The majority vote written out: sign(sum of the pods' signs + 0.5)
    times the mean of their mean |g|."""
    out = []
    for gs in zip(*pods_grads):
        scale = torch.stack([g.float().abs().mean() for g in gs]).mean()
        votes = sum(torch.where(g.float() >= 0, 1.0, -1.0) for g in gs)
        out.append((scale * torch.sign(votes + 0.5)).to(gs[0].dtype))
    return out


@pytest.mark.parametrize("arch", ["qwen2-7b+xnor"])
def test_onebit_step_is_the_plain_composition(arch):
    cfg = configs.get(arch).smoke(dtype=torch.float32)
    host = synthetic.Pipeline(cfg, 4, 16, seed=1).get(2)
    host["labels"][0, 9:] = -1                   # the pods' counts differ
    ranks = mesh_mod.run_ranks(onebit_step_rank, 2, arch, host, STEP,
                               SCHEDULE, device="cpu")
    state = ttrain.init_state(cfg, 0, device="cpu")
    batch = synthetic.to_device(host, "cpu")
    per_pod = [ttrain._grads(cfg, state.params, {
        k: v[2 * p:2 * p + 2] for k, v in batch.items()}) for p in (0, 1)]
    keys = [k for k, _ in ttrain.verify.tree_flatten_with_path(
        state.params)]
    voted = _vote([ttrain._leaves(g) for _, _, g in per_pod])
    it = iter(voted)
    grads = ttrain.verify.tree_map(lambda _: next(it), state.params)
    lr = ttrain.schedule.warmup_cosine(STEP, **SCHEDULE)
    params, _, gnorm = adamw.update(state.params, grads, state.opt, lr)
    want = {ttrain.verify.leaf_key(k): t.numpy() for k, t in zip(
        keys, ttrain._leaves(params))}
    loss = (per_pod[0][0] + per_pod[1][0]) / 2
    planes = sum(4 * -(-t.numel() // 32) + 4 for t in voted)
    for r in ranks:
        assert r["metrics"]["loss"] == float(loss)
        assert r["metrics"]["gnorm"] == float(gnorm)
        assert r["bytes"] == planes and r["reduced"] > 0
        assert sorted(r["params"]) == sorted(want)
        for k, w in want.items():
            np.testing.assert_array_equal(r["params"][k], w, err_msg=k)
