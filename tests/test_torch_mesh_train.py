"""The sharded train step over eight gloo ranks on the CPU, on the
reference test's (pod, data, model) = (2, 2, 2) mesh, against the JAX
package's jitted single-device ``train_step``.

Each rank keeps its blocks of the parameters and both moments; the batch
(8 x 16) is split over (pod, data), and its rows hold 1 to 8 unlabelled
(-1) positions, so the four batch blocks hold 3, 7, 11 and 15: the CE's
denominator must be the global count, not a mean of block means.
moonshot's routed layers add the load-balance loss, whose two means must
be the whole batch's.  What is held, at ``tests/test_torch_train.py``'s
tolerances: loss, ce, aux, gnorm, lr and tokens on every rank; every
rank's gradient block and updated parameter block against the same
block cut from the reference's (zero-padded where the block runs past
the leaf; the mesh's four ranks along ``model`` and ``pod`` x ``data``
hold their blocks independently); each rank's state bytes against its
shard's, ceil-divided as GSPMD pads."""

import math
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mesh_ranks import train_rank
from test_torch_train import (GRAD_REL, METRIC_TOL, PARAM_TOL, SCHEDULE,
                              SETTLED, STEP)
import repro.configs as jconfigs
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.train import train_step as jtrain
import repro_torch.configs as configs
from repro_torch.distributed import sharding
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import lm
from repro_torch.models import params as pdefs

B, S = 8, 16
AXES = {"pod": 0, "data": 1, "model": 2}
CASES = {"qwen2-7b": dict(n_kv_heads=2), "moonshot-v1-16b-a3b": {}}


def _batch(vocab: int) -> dict:
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, vocab, (B, S), dtype=np.int32)
    labels = np.concatenate([tokens[:, 1:], -np.ones((B, 1), np.int32)], 1)
    for r in range(B):
        labels[r, S - 1 - r:] = -1
    return {"tokens": tokens, "labels": labels}


def _block(full: np.ndarray, spec, coord) -> np.ndarray:
    """The block of ``full`` that mesh coordinate ``coord`` holds."""
    for dim, axes in enumerate(spec):
        names = (axes,) if isinstance(axes, str) else axes or ()
        if not names:
            continue
        k, idx = 1, 0
        for a in names:
            k, idx = k * 2, idx * 2 + coord[AXES[a]]
        n = full.shape[dim]
        bs = -(-n // k)
        lo, hi = min(idx * bs, n), min(idx * bs + bs, n)
        full = np.take(full, np.arange(lo, hi), axis=dim)
        pad = [(0, 0)] * full.ndim
        pad[dim] = (0, bs - (hi - lo))
        full = np.pad(full, pad)
    return full


def _flat(tree, prefix: str = "") -> dict:
    if not isinstance(tree, dict):
        return {prefix: tree}
    return {k: v for key in sorted(tree)
            for k, v in _flat(tree[key], f"{prefix}/{key}".lstrip("/"))
            .items()}


def _reference(arch: str) -> tuple:
    """-> (parameters, batch, gradients, updated parameters, metrics) of
    the jitted single-device reference step."""
    jcfg = jconfigs.get(arch).smoke(dtype=jnp.float32, **CASES[arch])
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(
        zlib.crc32(arch.encode()) % 2**31))
    host = _batch(jcfg.vocab)
    batch = jax.tree.map(jnp.asarray, host)
    _, _, jgrads = jax.jit(lambda p, b: jtrain._grads(jcfg, p, b, 0, 1))(
        jp, batch)
    new, jm = jax.jit(lambda s, b, t: jtrain.train_step(
        jcfg, s, b, t, **SCHEDULE))(jtrain.TrainState(jp, jadamw.init(jp)),
                                    batch, jnp.int32(STEP))
    return jax.tree.map(np.asarray, jp), host, jgrads, new.params, jm


@pytest.fixture(scope="module")
def runs() -> dict:
    """Both archs' reference steps, and one spawn of eight ranks taking
    the sharded step of each (the ranks' start-up is most of the cost)."""
    refs = {arch: _reference(arch) for arch in CASES}
    ranks = mesh_mod.run_ranks(
        train_rank, 8, {a: (CASES[a], *refs[a][:2]) for a in CASES}, STEP,
        SCHEDULE, device="cpu")
    return {a: (refs[a], [r[a] for r in ranks]) for a in CASES}


@pytest.mark.parametrize("arch", sorted(CASES))
def test_sharded_step_matches_reference_single_device(arch, runs):
    over = CASES[arch]
    (_, host, jgrads, jnew, jm), ranks = runs[arch]
    cfg = configs.get(arch).smoke(dtype=torch.float32, **over)
    specs = _flat(lm.param_pspecs(cfg, sharding.DEFAULT_RULES))
    defs = _flat(lm.param_defs(cfg))
    want_g = {k: np.asarray(v, np.float32) for k, v in _flat(jgrads).items()}
    want_p = {k: np.asarray(v, np.float32)
              for k, v in _flat(jnew).items()}
    assert sorted(specs) == sorted(want_g) == sorted(ranks[0]["params"])
    lr = SCHEDULE["peak_lr"]
    for r in ranks:
        for k in ("loss", "ce", "aux", "gnorm", "lr", "tokens"):
            np.testing.assert_allclose(r["metrics"][k], float(jm[k]),
                                       **METRIC_TOL, err_msg=k)
        if arch.startswith("moonshot"):
            assert r["metrics"]["aux"] > 0.0
        shard_bytes = 4    # the step counter
        for key, spec in specs.items():
            g = _block(want_g[key], spec, r["coord"])
            np.testing.assert_allclose(
                r["grads"][key], g, rtol=0,
                atol=GRAD_REL * np.abs(want_g[key]).max() + 1e-12,
                err_msg=f"grad {key} at {r['coord']}")
            want = _block(want_p[key], spec, r["coord"])
            got = r["params"][key]
            firm = np.abs(g) >= SETTLED * np.abs(want_g[key]).max()
            np.testing.assert_allclose(got[firm], want[firm], **PARAM_TOL,
                                       err_msg=f"param {key}")
            assert np.all(np.abs(got - want) <= 2 * lr + PARAM_TOL["atol"]
                          + PARAM_TOL["rtol"] * np.abs(want)), key
            assert got.shape == g.shape
            shard_bytes += g.size * (defs[key].dtype.itemsize + 8)
        assert r["state_bytes"] == shard_bytes
    assert int(ranks[0]["metrics"]["tokens"]) == int(
        (host["labels"] >= 0).sum())
    assert pdefs.count(lm.param_defs(cfg)) == sum(
        math.prod(d.shape) for d in defs.values())

