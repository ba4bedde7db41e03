"""Tensor- and expert-parallel training over gloo ranks on the CPU: the
sharded ``train_step`` on the (data, model) = (1, 4) mesh against the
JAX package's jitted single-device ``train_step`` and the port's
single-process step (``test_torch_mesh_tp_train_pods.py``: the same on
(pod, data, model) = (2, 2, 2), and ``microbatch=2``;
``test_torch_mesh_tp_train_recurrent.py``: the recurrent and CNN
kinds).

Each rank keeps its head-aligned blocks of the parameters and both
moments and computes on them: qwen2-7b's smoke config at 6 query heads
and 2 KV heads (ranks 0-2 hold 2 query heads, rank 3 none; rank 1's
read both KV heads, which ranks 0 and 2 hold too: their gradients are
summed over the holders), float and ``+xnor`` (the float STE, the
row-parallel ``wo`` and ``w2`` as sign products summed over the ranks),
moonshot (top-2 over 4 experts, one a rank), recurrentgemma-2b
``+xnor`` (its ``rglru`` and ``local`` layers on their blocks), and
llama-3.2-vision-11b at 10 layers with a seeded context a row, whose two
``cross`` layers have no tensor-parallel form and are gathered whole a
layer at a time; moonshot again with every
model-axis sum on the ring all-reduce (``ctx.GATHER_BYTES`` 0: the MoE
combine's f32 partial sums under autograd).  The batch (8 x 16) holds 1
to 8 unlabelled positions a row (``test_torch_mesh_train``).

What is held, at ``tests/test_torch_train.py``'s tolerances: loss, ce,
aux, gnorm, lr and tokens on every rank; every rank's gradient block and
updated parameter block against the same block cut from the reference's
(and from the port's single-process step's); leaves replicated over
``model`` bitwise equal on every rank of the axis; what a step gathers
(each layer's blocks, twice with remat, never more than one layer's
alive at once, the embedding's at its use) and that no op makes a
(tokens, vocab) tensor.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mesh_ranks import tp_train_rank
from test_torch_mesh_train import _batch, _flat
from test_torch_train import (GRAD_REL, METRIC_TOL, PARAM_TOL, SCHEDULE,
                              SETTLED, STEP)
import repro.configs as jconfigs
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.train import train_step as jtrain
import repro_torch.configs as configs
from repro_torch import convert
from repro_torch.distributed import sharding
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.train import train_step as ttrain

torch.set_num_threads(1)

QWEN = dict(n_heads=6, n_kv_heads=2)
CASES = {
    "qwen2-7b": ("qwen2-7b", QWEN, 1),
    "qwen2-7b+xnor": ("qwen2-7b+xnor", QWEN, 1),
    "moonshot-v1-16b-a3b": ("moonshot-v1-16b-a3b", {}, 1),
    "recurrentgemma-2b+xnor": ("recurrentgemma-2b+xnor", {}, 1),
    "llama-3.2-vision-11b": ("llama-3.2-vision-11b", dict(n_layers=10), 1),
    "moonshot-v1-16b-a3b ring sums": ("moonshot-v1-16b-a3b", {}, 1),
}
COUNTED = "llama-3.2-vision-11b"
# cases run with ctx.GATHER_BYTES = 0: every sum over model takes the
# ring all-reduce (a prefill's path) and the MoE combine sums f32
# partials, whose weights enter the rank's experts through ctx.enter
RING = {"moonshot-v1-16b-a3b ring sums"}


def reference(arch: str, over: dict, microbatch: int) -> dict:
    """The jitted single-device reference step and the port's
    single-process one from the same parameters and batch."""
    jcfg = jconfigs.get(arch).smoke(dtype=jnp.float32, **over)
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(
        zlib.crc32(arch.encode()) % 2**31))
    host = _batch(jcfg.vocab)
    if jcfg.n_ctx_tokens:      # a context arch: each row's seeded context
        host["ctx"] = np.random.default_rng(6).standard_normal(
            (len(host["tokens"]), jcfg.n_ctx_tokens, jcfg.d_model)
        ).astype(np.float32)
    batch = jax.tree.map(jnp.asarray, host)
    _, _, jgrads = jax.jit(lambda p, b: jtrain._grads(
        jcfg, p, b, 0, microbatch))(jp, batch)
    new, jm = jax.jit(lambda s, b, t: jtrain.train_step(
        jcfg, s, b, t, **SCHEDULE, microbatch=microbatch))(
        jtrain.TrainState(jp, jadamw.init(jp)), batch, jnp.int32(STEP))
    params = jax.tree.map(np.asarray, jp)
    cfg = configs.get(arch).smoke(dtype=torch.float32, **over)
    tb = {k: torch.from_numpy(v) for k, v in host.items()}
    _, _, grads = ttrain._grads(cfg, convert.from_jax(cfg, params), tb, 0,
                                microbatch)
    tree = convert.from_jax(cfg, params)
    pnew, pm = ttrain.train_step(cfg, ttrain.TrainState(
        tree, adamw.init(tree)), tb, STEP, **SCHEDULE, microbatch=microbatch)
    f32 = lambda t: {k: np.asarray(v, np.float32)      # noqa: E731
                     for k, v in _flat(t).items()}
    return dict(params=params, batch=host,
                refs={"jax": (f32(jgrads), f32(new.params),
                              {k: float(v) for k, v in jm.items()}),
                      "port": (f32(verify_tree(grads)),
                               f32(verify_tree(pnew.params)),
                               {k: float(v) for k, v in pm.items()})})


def verify_tree(tree):
    return {k: verify_tree(v) for k, v in tree.items()} \
        if isinstance(tree, dict) else tree.detach().numpy()


def run(shape: tuple, axes: tuple, cases: dict, counted,
        ring=frozenset()) -> dict:
    """Each case's references, and one spawn of the mesh's ranks taking
    the sharded step of every case (those in ``ring`` at
    ``ctx.GATHER_BYTES`` 0; those named in ``counted``, a name or names,
    with what their gradient pass gathers)."""
    counted = (counted,) if isinstance(counted, str) else tuple(counted)
    refs = {}
    for name, case in cases.items():
        same = [n for n in refs if cases[n] == case]
        refs[name] = refs[same[0]] if same else reference(*case)
    rank_cases = {name: dict(arch=arch, over=over, microbatch=mb,
                             params=refs[name]["params"],
                             batch=refs[name]["batch"],
                             count=name in counted,
                             gather_bytes=0 if name in ring else None)
                  for name, (arch, over, mb) in cases.items()}
    ranks = mesh_mod.run_ranks(tp_train_rank, int(np.prod(shape)), shape,
                               axes, rank_cases, STEP, SCHEDULE,
                               device="cpu", timeout_s=600)
    return {"refs": refs, "ranks": ranks, "axes": axes, "shape": shape}


def block(full: np.ndarray, spec, coord, axes, shape) -> np.ndarray:
    """The block of ``full`` that mesh coordinate ``coord`` holds
    (head-aligned entries cut by ``sharding.extent``, each piece of a
    ``sharding.Parts`` dim on its own), zero-padded."""
    for dim, entry in enumerate(spec):
        names = sharding._names(entry)
        if not names:
            continue
        k, idx = 1, 0
        for a in names:
            n = shape[axes.index(a)]
            k, idx = k * n, idx * n + coord[axes.index(a)]
        bs, lo, hi = sharding.extent(full.shape[dim], entry, k, idx)
        pad = [(0, 0)] * full.ndim
        pad[dim] = (0, bs - (hi - lo))
        full = np.concatenate([
            np.pad(np.take(piece, np.arange(lo, hi), axis=dim), pad)
            for piece in np.split(full, getattr(entry, "parts", 1), dim)],
            axis=dim)
    return full


def hold(name: str, arch: str, over: dict, got: dict, want: tuple, coord,
         axes, shape) -> None:
    """One rank's case against a reference (gradients, parameters,
    metrics)."""
    want_g, want_p, want_m = want
    cfg = configs.get(arch).smoke(dtype=torch.float32, **over)
    specs = _flat(lm.param_pspecs(cfg, sharding.DEFAULT_RULES,
                                  head_aligned=True))
    assert sorted(specs) == sorted(want_g) == sorted(got["params"])
    for k in ("loss", "ce", "aux", "gnorm", "lr", "tokens"):
        np.testing.assert_allclose(got["metrics"][k], want_m[k],
                                   **METRIC_TOL, err_msg=f"{name} {k}")
    lr = SCHEDULE["peak_lr"]
    for key, spec in specs.items():
        g = block(want_g[key], spec, coord, axes, shape)
        scale = np.abs(want_g[key]).max()
        np.testing.assert_allclose(
            got["grads"][key], g, rtol=0, atol=GRAD_REL * scale + 1e-12,
            err_msg=f"{name} grad {key} at {coord}")
        want = block(want_p[key], spec, coord, axes, shape)
        have = got["params"][key]
        firm = np.abs(g) >= SETTLED * scale
        np.testing.assert_allclose(have[firm], want[firm], **PARAM_TOL,
                                   err_msg=f"{name} param {key}")
        assert np.all(np.abs(have - want) <= 2 * lr + PARAM_TOL["atol"]
                      + PARAM_TOL["rtol"] * np.abs(want)), (name, key)


def hold_case(name: str, case: tuple, runs: dict) -> None:
    arch, over, _ = case
    for r in runs["ranks"]:
        got = r["cases"][name]
        for ref in ("jax", "port"):
            hold(name, arch, over, got, runs["refs"][name]["refs"][ref],
                 r["coord"], runs["axes"], runs["shape"])
        if arch.startswith("moonshot"):
            assert got["metrics"]["aux"] > 0.0


def hold_replicated(name: str, case: tuple, runs: dict) -> None:
    """Leaves whose placement has no ``model`` entry: the same gradient
    and updated parameter bits on every rank of the model axis."""
    arch, over, _ = case
    cfg = configs.get(arch).smoke(dtype=torch.float32, **over)
    specs = _flat(lm.param_pspecs(cfg, sharding.DEFAULT_RULES,
                                  head_aligned=True))
    axes = runs["axes"]
    m = axes.index("model")
    groups = {}
    for r in runs["ranks"]:
        key = tuple(c for i, c in enumerate(r["coord"]) if i != m)
        groups.setdefault(key, []).append(r["cases"][name])
    replicated = [k for k, s in specs.items()
                  if "model" not in {a for e in s for a in sharding._names(e)}]
    assert replicated
    for members in groups.values():
        assert len(members) == runs["shape"][m]
        for key in replicated:
            for what in ("grads", "params"):
                first = members[0][what][key]
                for other in members[1:]:
                    assert np.array_equal(first.view(np.uint32),
                                          other[what][key].view(np.uint32)), \
                        (name, what, key)


def hold_gathers(name: str, case: tuple, runs: dict, b_local: int) -> None:
    """The parameter bytes a step's gradient pass gathers: the
    embedding's and each layer's blocks in the forward, each layer's
    again in the backward (the recompute), never more than one layer's
    (and the embedding's) alive at once; no op output of (tokens,
    vocab)."""
    arch, over, _ = case
    cfg = configs.get(arch).smoke(dtype=torch.float32, **over)
    for r in runs["ranks"]:
        got = r["cases"][name]
        probe, layers, embed = got["probe"], got["layers"], got["embed"]
        assert max(layers) > 0
        fwd = sum(n for p, n in probe["calls"] if p == "fwd")
        bwd = sum(n for p, n in probe["calls"] if p == "bwd")
        assert fwd == embed + sum(layers)
        assert bwd == sum(layers)
        assert max(layers) <= probe["live_max"] <= max(layers) + embed
        assert probe["live_max"] < sum(layers)
        assert probe["vocab_outputs"] < b_local * 16 * cfg.padded_vocab


@pytest.fixture(scope="module")
def runs():
    return run((1, 4), ("data", "model"), CASES, COUNTED, RING)


@pytest.mark.parametrize("name", list(CASES))
def test_tp_train_step_matches_reference_and_single_process(name, runs):
    hold_case(name, CASES[name], runs)


@pytest.mark.parametrize("name", list(CASES))
def test_leaves_replicated_over_model_are_bitwise_equal(name, runs):
    hold_replicated(name, CASES[name], runs)


def test_kinds_without_tp_gather_a_layer_at_a_time_over_model(runs):
    """llama-vision's cross layers gathered whole over ``model``
    (nothing is split over ``data`` on this mesh; its attn layers compute
    on their heads), a layer at a time, twice; the vocab stays split."""
    hold_gathers(COUNTED, CASES[COUNTED], runs, 8)


class _Mesh:
    """Rank ``i``'s view of a (data 1, model ``k``) mesh: what
    ``sharding`` reads of a ``DeviceMesh``."""
    mesh_dim_names = ("data", "model")

    def __init__(self, k: int, i: int):
        self.k, self.i = k, i

    def size(self, dim: int) -> int:
        return (1, self.k)[dim]

    def get_local_rank(self, axis: str) -> int:
        return self.i if axis == "model" else 0


def test_shared_kv_heads_and_norm_count_each_element_once():
    """6 query heads over 4 ranks read KV heads {0}, {0, 1}, {1}, {}: the
    K/V leaves' KV heads are held twice, so the global norm divides each
    by its holders; Q's heads, and KV heads on 2 ranks (3 query heads a
    rank, one KV head each), are held once."""
    kv = (None, "data", sharding.Heads("model", 6, 16, 3))
    q = (None, "data", sharding.Heads("model", 6, 16, 1))
    for i, holders in enumerate([[2], [2, 2], [2], []]):
        mesh = _Mesh(4, i)
        dim, _, spans = ttrain._shared_heads(kv, mesh)
        assert dim == 2 and spans == [(0, 1), (0, 2), (1, 2), (2, 2)]
        block = torch.zeros((1, 64, 32))
        c = ttrain._copies(kv, mesh, block)
        want = [float(h) for h in holders for _ in range(16)]
        want += [1.0] * (32 - len(want))
        assert c.shape == (1, 1, 32) and c.flatten().tolist() == want
        assert ttrain._shared_heads(q, mesh) is None
        assert ttrain._copies(q, mesh, block) == 1
    assert ttrain._shared_heads(kv, _Mesh(2, 0)) is None
