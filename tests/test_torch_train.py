"""One training step of the port against the JAX package's jitted
``train_step``, on the CPU, for every registered decoder kind.

The same parameters (the reference's ``init_params``, converted with
``convert.from_jax``) and the same ``synthetic.Pipeline`` batch go
through both packages; the step is taken at step 12 of a warmup-10
schedule on fresh AdamW moments.  What is held, in f32:

- loss, ce, aux and gnorm: ``METRIC_TOL``;
- every gradient leaf within ``GRAD_REL`` of its largest |g| (the sums
  run in other orders; the XNOR layers' straight-through sign products
  are exact);
- every updated parameter: within ``PARAM_TOL`` where the reference's
  gradient is at least ``SETTLED`` of its leaf's largest |g|; elsewhere
  within two learning rates.  AdamW's first step moves an element by
  lr g / (|g| + eps): a gradient within its tolerance of zero may move
  its element by anything up to lr either way.

bf16 (``qwen2-7b+xnor``) holds the same quantities at ``BF16_GRAD_REL``
(XLA keeps the backward's fused products in f32 where autograd rounds
each op's result to bf16: up to 1.5 % of a leaf's largest |g| at the
smoke size) and its parameters at one bf16 ulp where the gradient is
settled.

Then ``microbatch=2`` against ``microbatch=1`` and ``q_chunk=4`` against
``q_chunk=0``, in both packages, and ``remat`` changing no gradient.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.data import synthetic as jsynthetic
from repro.distributed import sharding as jsharding
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.train import train_step as jtrain
import repro_torch.configs as configs
from repro_torch import convert
from repro_torch.core import verify
from repro_torch.data import synthetic
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.train import train_step as ttrain

torch.set_num_threads(1)

B, S, STEP = 2, 16, 12
SCHEDULE = dict(peak_lr=3e-3, warmup=10, total=100)
METRIC_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_REL = 2e-5
SETTLED = 1e-3
PARAM_TOL = dict(rtol=1e-5, atol=2e-6)
BF16_GRAD_REL = 2 ** -5
BF16_SETTLED = 2 ** -4

# every registered decoder kind at least once
KINDS = {"qwen2-7b": "attn", "qwen2-7b+xnor": "attn + xnor",
         "recurrentgemma-2b": "local, rglru",
         "moonshot-v1-16b-a3b": "moe",
         "llama-3.2-vision-11b": "cross", "whisper-tiny": "enc, dec",
         "xlstm-350m": "mlstm, slstm"}


def _setup(arch: str, dtype: str = "float32", **over):
    jcfg = jconfigs.get(arch).smoke(dtype=jnp.dtype(dtype), **over)
    cfg = configs.get(arch).smoke(dtype=getattr(torch, dtype), **over)
    key = jax.random.PRNGKey(zlib.crc32(arch.encode()) % 2**31)
    jp = jlm.init_params(jcfg, key)
    host = jsynthetic.Pipeline(jcfg, B, S, seed=3).get(7)
    return jcfg, cfg, jp, host


def _port(cfg, jp):
    return convert.from_jax(cfg, jax.tree.map(np.asarray, jp))


def _leaves(tree) -> list:
    return [(verify.leaf_key(p), leaf)
            for p, leaf in verify.tree_flatten_with_path(tree)]


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _reference(jcfg, jp, host, **kw):
    """-> (grads, new params, metrics) of the jitted reference step."""
    batch = jax.tree.map(jnp.asarray, host)
    _, _, grads = jax.jit(lambda p, b: jtrain._grads(
        jcfg, p, b, 0, kw.get("microbatch", 1)))(jp, batch)
    state = jtrain.TrainState(jp, jadamw.init(jp))
    new, metrics = jax.jit(lambda s, b, t: jtrain.train_step(
        jcfg, s, b, t, **SCHEDULE, **kw))(state, batch, jnp.int32(STEP))
    return grads, new.params, metrics


def _hold_grads(want_grads, grads, grad_rel):
    """Every gradient leaf within ``grad_rel`` of its largest |g|."""
    want = dict(zip((k for k, _ in _leaves(grads)),
                    jax.tree.leaves(want_grads)))
    assert len(want) == len(_leaves(grads))
    for key, g in _leaves(grads):
        w = _np(want[key])
        np.testing.assert_allclose(_np(g), w, rtol=0,
                                   atol=grad_rel * np.abs(w).max() + 1e-12,
                                   err_msg=f"grad {key}")


def _hold_params(want_grads, want_new, new, settled, param_tol):
    """Updated params within ``param_tol`` where the reference's |g| is at
    least ``settled`` of its leaf's largest, else within two learning
    rates."""
    lr = SCHEDULE["peak_lr"]
    keys = [k for k, _ in _leaves(new)]
    jg = dict(zip(keys, jax.tree.leaves(want_grads)))
    jn = dict(zip(keys, jax.tree.leaves(want_new)))
    for key, p in _leaves(new):
        g = np.abs(_np(jg[key]))
        want, got = _np(jn[key]), _np(p)
        firm = g >= settled * g.max()
        np.testing.assert_allclose(got[firm], want[firm], **param_tol,
                                   err_msg=f"param {key}")
        assert np.all(np.abs(got - want) <= 2 * lr + param_tol["atol"]
                      + param_tol["rtol"] * np.abs(want)), f"param {key}"


def _port_step(cfg, jp, host, **kw):
    """-> (grads, new params, metrics) of the port's step."""
    batch = synthetic.to_device(host, "cpu")
    _, _, grads = ttrain._grads(cfg, _port(cfg, jp), batch,
                                microbatch=kw.get("microbatch", 1))
    state = ttrain.TrainState(_port(cfg, jp), adamw.init(_port(cfg, jp)))
    new, metrics = ttrain.train_step(cfg, state, batch, STEP, **SCHEDULE,
                                     **kw)
    return grads, new.params, metrics


def _metrics(jm, tm, keys=("loss", "ce", "aux", "gnorm", "lr", "tokens")):
    for k in keys:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), **METRIC_TOL,
                                   err_msg=k)


@pytest.mark.parametrize("arch", sorted(KINDS))
def test_train_step_matches_reference_f32(arch):
    jcfg, cfg, jp, host = _setup(arch)
    jgrads, jnew, jm = _reference(jcfg, jp, host)
    tgrads, tnew, tm = _port_step(cfg, jp, host)
    _metrics(jm, tm)
    if KINDS[arch] == "moe":
        assert float(tm["aux"]) > 0.0
    _hold_grads(jgrads, tgrads, GRAD_REL)
    _hold_params(jgrads, jnew, tnew, SETTLED, PARAM_TOL)


def test_train_step_matches_reference_bf16():
    jcfg, cfg, jp, host = _setup("qwen2-7b+xnor", "bfloat16")
    jgrads, jnew, jm = _reference(jcfg, jp, host)
    tgrads, tnew, tm = _port_step(cfg, jp, host)
    _metrics(jm, tm, ("loss", "ce", "lr", "tokens"))
    np.testing.assert_allclose(float(tm["gnorm"]), float(jm["gnorm"]),
                               rtol=BF16_GRAD_REL)
    _hold_grads(jgrads, tgrads, BF16_GRAD_REL)
    _hold_params(jgrads, jnew, tnew, BF16_SETTLED,
                 dict(rtol=2 ** -7, atol=1e-6))


@pytest.mark.parametrize("arch", ["qwen2-7b+xnor", "moonshot-v1-16b-a3b"])
def test_microbatch_matches_reference_and_whole_batch(arch):
    """Two sequential microbatches: the port against the reference's
    scan at ``microbatch=2``, and against its own whole batch (the same
    mean gradient: each part's loss is its own tokens' mean, and the two
    parts hold equal token counts)."""
    jcfg, cfg, jp, host = _setup(arch)
    jgrads, jnew, jm = _reference(jcfg, jp, host, microbatch=2)
    tgrads, tnew, tm = _port_step(cfg, jp, host, microbatch=2)
    _metrics(jm, tm, ("loss", "ce", "gnorm", "lr", "tokens"))
    _hold_grads(jgrads, tgrads, GRAD_REL)
    _hold_params(jgrads, jnew, tnew, SETTLED, PARAM_TOL)
    whole, _, wm = _port_step(cfg, jp, host)
    assert all(g.dtype == torch.float32 for _, g in _leaves(tgrads))
    if arch != "moonshot-v1-16b-a3b":   # routing groups follow the batch
        np.testing.assert_allclose(float(tm["loss"]), float(wm["loss"]),
                                   rtol=1e-5)
        _hold_grads(whole, tgrads, GRAD_REL)


@pytest.mark.parametrize("arch,window", [("qwen2-7b+xnor", 0),
                                         ("recurrentgemma-2b", 8),
                                         ("whisper-tiny", 0)])
def test_q_chunk_matches_one_shot(arch, window):
    """``q_chunk=4`` over S 16 against the one-shot attention, in both
    packages; recurrentgemma at window 8 takes the band path (the window
    a multiple of the chunk), the others the full-row mask."""
    over = {"local_window": window} if window else {}
    jcfg, cfg, jp, host = _setup(arch, **over)
    batch = jax.tree.map(jnp.asarray, host)
    vg = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(jcfg, p, b, q_chunk=4), has_aux=True),
        static_argnums=())
    (jl, _), jgrads = vg(jp, batch)
    tb = synthetic.to_device(host, "cpu")
    tl, _, tgrads = ttrain._grads(cfg, _port(cfg, jp), tb, q_chunk=4)
    one, _, ograds = ttrain._grads(cfg, _port(cfg, jp), tb, q_chunk=0)
    np.testing.assert_allclose(float(tl), float(jl), **METRIC_TOL)
    np.testing.assert_allclose(float(tl), float(one), **METRIC_TOL)
    _hold_grads(jgrads, tgrads, GRAD_REL)
    _hold_grads(ograds, tgrads, GRAD_REL)


def test_q_chunk_raises_on_a_ragged_sequence():
    cfg = configs.get("qwen2-7b").smoke(dtype=torch.float32)
    params = lm.init_params(cfg, 0, device="cpu")
    tokens = torch.zeros((1, 10), dtype=torch.int32)
    with pytest.raises(ValueError, match="q_chunk"):
        lm.forward(cfg, params, tokens, q_chunk=4)


def test_remat_changes_no_gradient():
    """Per-layer checkpointing recomputes each layer's activations in the
    backward pass: the same loss and the same gradients, bit for bit."""
    cfg = configs.get("moonshot-v1-16b-a3b").smoke(dtype=torch.float32)
    params = lm.init_params(cfg, 1, device="cpu")
    batch = synthetic.to_device(synthetic.batch(0, 0, B, S, cfg.vocab), "cpu")

    def grads(remat):
        leaves = [p.detach().requires_grad_(True)
                  for _, p in _leaves(params)]
        it = iter(leaves)
        live = verify.tree_map(lambda _: next(it), params)
        loss, m = lm.loss_fn(cfg, live, batch, remat=remat)
        return loss, m["aux"], torch.autograd.grad(loss, leaves)
    a, b = grads(True), grads(False)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert all(torch.equal(x, y) for x, y in zip(a[2], b[2]))


def test_train_step_learns_and_reports():
    """Ten port steps on one smoke config: finite metrics every step, the
    loss falls, ``tokens`` counts the labelled positions."""
    cfg = configs.get("qwen2-7b+xnor").smoke(dtype=torch.float32)
    state = ttrain.init_state(cfg, 0, device="cpu")
    pipe = synthetic.Pipeline(cfg, 4, 16, seed=0)
    losses = []
    for step in range(10):
        state, m = ttrain.train_step(cfg, state, synthetic.to_device(
            pipe.get(step % 2), "cpu"), step, peak_lr=1e-2, warmup=2,
            total=10)
        assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["gnorm"]))
        assert int(m["tokens"]) == 4 * 15
        losses.append(float(m["loss"]))
    assert int(state.opt.step) == 10
    assert np.mean(losses[-3:]) < np.mean(losses[:3])


def test_onebit_pod_and_pspecs_need_a_mesh():
    """The one-bit exchange runs across a mesh's pod axis: without a mesh
    the step refuses it.  ``state_pspecs`` needs only the rules: the
    reference's placements, with the dims of heads split into whole heads
    (``sharding.Heads``; the same blocks as the reference's where the
    heads divide evenly over ``model``; ``tests/test_torch_mesh_*.py``
    run both on gloo meshes)."""
    from repro_torch.distributed import sharding
    cfg = configs.get("qwen2-7b").smoke(dtype=torch.float32)
    with pytest.raises(ValueError, match="'pod' axis"):
        ttrain.train_step(cfg, None, {}, 0, grad_compress="onebit_pod")
    specs = ttrain.state_pspecs(cfg, jsharding.DEFAULT_RULES)
    want = jtrain.state_pspecs(jconfigs.get("qwen2-7b").smoke(),
                               jsharding.DEFAULT_RULES)
    assert specs.opt.step == ()
    heads = sharding.Heads("model", cfg.n_heads, cfg.d_head, 1)
    assert specs.params["seg0_attn"]["attn_wq"] == (None, "data", heads)
    assert tuple(want.params["seg0_attn"]["attn_wq"]) == (None, "data",
                                                          "model")
    n = cfg.n_heads * cfg.d_head
    for k in (2, 4):
        for i in range(k):
            assert sharding.extent(n, heads, k, i) == \
                sharding.extent(n, "model", k, i)
    assert specs.params["seg0_attn"]["ffn_w1"] == tuple(
        want.params["seg0_attn"]["ffn_w1"])
    assert specs.opt.m == specs.opt.v == specs.params


def test_counts_match_reference():
    for arch in list(KINDS) + ["llama4-scout-17b-a16e", "xnor-cnn"]:
        jcfg, cfg = jconfigs.get(arch), configs.get(arch)
        assert lm.param_count(cfg) == jlm.param_count(jcfg), arch
        assert lm.active_param_count(cfg) == jlm.active_param_count(jcfg)
        for kind in ("train", "serve"):
            assert lm.model_flops(cfg, kind, 1024) == \
                jlm.model_flops(jcfg, kind, 1024)


def test_abstract_state_matches_init():
    cfg = configs.get("whisper-tiny").smoke(dtype=torch.float32)
    like = ttrain.abstract_state(cfg)
    real = ttrain.init_state(cfg, 0, device="cpu")
    a, r = _leaves(like), _leaves(real)
    assert [k for k, _ in a] == [k for k, _ in r]
    assert all(x.device.type == "meta" and x.shape == y.shape
               and x.dtype == y.dtype for (_, x), (_, y) in zip(a, r))
