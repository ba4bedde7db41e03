"""The paper's XNOR-CNN served as an arch (``xnor-cnn``, kind
``bindense``) in the port against the JAX package: the block alone, the
stripe images drawn with the reference's random bits, the images' context
rows, and greedy tokens through both engines, paged and slot-dense.

The arch is f32 with binarized up / down projections; its full size is
already tiny (2 layers, d 64), so nothing is cut.  Weights come from
``jax.random`` and ``convert.from_jax``.  Tolerances are stated per test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import bcnn as jbcnn
from repro.models import blocks as jblocks
from repro.models import lm as jlm
from repro.serve import Request as JRequest
import repro_torch.configs as configs
from repro_torch import convert
from repro_torch.core import prng
from repro_torch.models import bcnn, blocks, lm, registry
from repro_torch.serve import Request, ServeEngine
from test_torch_reference import COUNTERS, reference_engine

ARCH = "xnor-cnn"


@pytest.fixture(scope="module")
def params():
    """key -> (reference cfg, params; port cfg, params), built once."""
    cache = {}

    def get(key):
        if key not in cache:
            jcfg, cfg = jconfigs.get(ARCH), configs.get(ARCH)
            jp = jlm.init_params(jcfg, jax.random.PRNGKey(key))
            cache[key] = (jcfg, jp, cfg, convert.from_jax(
                cfg, jax.tree.map(np.asarray, jp)))
        return cache[key]
    return get


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t, np.float32)


def test_arch_and_kind_are_the_references():
    cfg, jcfg = configs.get(ARCH), jconfigs.get(ARCH)
    assert cfg.segments() == jcfg.segments() == [("bindense", 2)]
    assert (bcnn.N_CLASSES, bcnn.QUERY_TOKEN, bcnn.VOCAB) == \
        (jbcnn.N_CLASSES, jbcnn.QUERY_TOKEN, jbcnn.VOCAB) == (2, 2, 4)
    assert registry.get("bindense") is bcnn.BinDenseBlock
    assert lm.paged_table_widths(cfg, 16, 8, 8) == {}
    assert lm.prefix_cache_eligible(cfg) and lm.prefix_table_class(cfg) is None


@pytest.mark.parametrize("packed", [False, True])
def test_block_matches_reference(params, packed):
    """One layer's prefill over 5 tokens with a context (and the gate it
    keeps), two decode steps reading that gate, and a ragged chunk, f32:
    within 1e-5 of the reference (the full-precision ``w_ctx`` product and
    the binary layers' alpha sum in their own orders); float or packed
    weights."""
    jcfg, jp, cfg, tp = params(7)
    if packed:
        jp, tp = jlm.pack_params(jcfg, jp), lm.pack_params(cfg, tp)
    jpl = jax.tree.map(lambda a: a[0], jp["seg0_bindense"])
    tpl = blocks.layer_params(tp["seg0_bindense"], 0)
    jb, tb = jblocks.KINDS["bindense"], registry.get("bindense")
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    ctx = rng.standard_normal((2, cfg.n_ctx_tokens, cfg.d_model)).astype(
        np.float32)
    opts = jblocks.FwdOpts(want_state=True, s_max=16)
    jy, _, jg = jax.jit(lambda p, x, c: jb.fwd(jcfg, p, x, c, opts))(
        jpl, jnp.asarray(x), jnp.asarray(ctx))
    ty, tg = tb.fwd(cfg, tpl, torch.from_numpy(x),
                    blocks.FwdOpts(want_state=True, s_max=16),
                    torch.from_numpy(ctx))
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(ty), _np(jy), **tol)
    np.testing.assert_allclose(_np(tg), _np(jg), **tol)
    for step in range(2):
        xt = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        jy, jg = jb.decode(jcfg, jpl, jnp.asarray(xt), jg, jnp.int32(5 + step),
                           None)
        before = tg.clone()
        ty = tb.decode(cfg, tpl, torch.from_numpy(xt), tg,
                       torch.tensor(5 + step), None)
        np.testing.assert_allclose(_np(ty), _np(jy), **tol)
        assert torch.equal(tg, before)           # decode only reads it
    xc = rng.standard_normal((1, 8, cfg.d_model)).astype(np.float32)
    valid = np.arange(8)[None] < 3
    state = torch.zeros((1, 1, cfg.d_model))
    jy, jg = jb.chunk(jcfg, jpl, jnp.asarray(xc), jnp.zeros((1, 1, 64)),
                      jnp.int32(0), jnp.asarray(valid), jnp.int32(3),
                      jnp.asarray(ctx[:1]), None)
    ty = tb.chunk(cfg, tpl, torch.from_numpy(xc), state, None,
                  torch.from_numpy(valid), 3, None, torch.from_numpy(ctx[:1]))
    np.testing.assert_allclose(_np(ty[:, :3]), _np(jy[:, :3]), **tol)
    np.testing.assert_allclose(_np(state), _np(jg), **tol)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_synthetic_images_are_the_references(seed):
    """Labels bit for bit (``prng.bernoulli``); pixels within 1e-6, a few
    f32 ulps (``prng.normal``'s ``log1p`` is torch's, which differs from
    XLA's on about 8 % of inputs)."""
    ji, jy = jbcnn.synthetic_images(jax.random.PRNGKey(seed), 32)
    ti, ty = bcnn.synthetic_images(prng.PRNGKey(seed), 32)
    assert np.array_equal(ty.numpy(), np.asarray(jy))
    assert ti.dtype == torch.float32 and ti.shape == (32, 16, 16)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=1e-6,
                               atol=1e-6)


def test_prng_bernoulli_and_normal():
    """``bernoulli`` bit for bit at p 0.5 and 0.2; ``normal`` within 3 f32
    ulps of ``jax.random.normal`` on 20,000 draws, and ``erf_inv`` within
    3 ulps of ``lax.erf_inv`` over (-1, 1), +-inf at +-1."""
    key = jax.random.PRNGKey(5)
    for p in (0.5, 0.2):
        want = np.asarray(jax.random.bernoulli(key, p, (20000,)))
        assert np.array_equal(prng.bernoulli(prng.PRNGKey(5), p,
                                             (20000,)).numpy(), want)

    def ulps(a, b):
        return np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max()
    want = np.asarray(jax.random.normal(key, (20000,)))
    got = prng.normal(prng.PRNGKey(5), (20000,)).numpy()
    assert ulps(got, want) <= 3
    x = np.linspace(-0.999999, 0.999999, 10001, dtype=np.float32)
    got = prng.erf_inv(torch.from_numpy(x)).numpy()
    assert ulps(got, np.asarray(jax.lax.erf_inv(jnp.asarray(x)))) <= 3
    edge = prng.erf_inv(torch.tensor([-1.0, 1.0])).tolist()
    assert edge == [-np.inf, np.inf]


def test_image_ctx_is_the_references():
    """Pixel bands bit for bit from numpy or tensors; a wrong pixel count
    raises in both packages."""
    cfg = configs.get(ARCH)
    imgs = np.random.default_rng(3).standard_normal((5, 16, 16)).astype(
        np.float32)
    want = jbcnn.image_ctx(jconfigs.get(ARCH), imgs)
    assert np.array_equal(bcnn.image_ctx(cfg, imgs), want)
    assert np.array_equal(bcnn.image_ctx(cfg, torch.from_numpy(imgs)), want)
    with pytest.raises(ValueError, match="pixels"):
        bcnn.image_ctx(cfg, imgs[:, :8])


def _trace(cfg, seed):
    """6 image requests: the reference's stripe images as contexts, a
    prompt of the query token then 0-5 random class-vocab tokens, 1-4 new
    tokens (one request a plain classification: 1 token)."""
    imgs, _ = jbcnn.synthetic_images(jax.random.PRNGKey(seed), 6)
    ctx = jbcnn.image_ctx(jconfigs.get(ARCH), imgs).copy()
    rng = np.random.default_rng(seed)
    out = []
    for i in range(6):
        prompt = np.concatenate([[bcnn.QUERY_TOKEN], rng.integers(
            0, cfg.vocab, int(rng.integers(0, 6)))]).astype(np.int32)
        out.append((i, prompt, 1 if i == 0 else int(rng.integers(1, 5)),
                    ctx[i]))
    return out


@pytest.mark.parametrize("trace_seed", [0, 1, 2, 3])
@pytest.mark.parametrize("key", [7, 11])
@pytest.mark.parametrize("paged", [True, False])
def test_greedy_tokens_match_reference(params, paged, key, trace_seed):
    """2 slots, packed: the reference engine's greedy tokens and counters,
    paged (no pool: the kind keeps only its per-slot gate) and
    slot-dense."""
    jcfg, jp, cfg, tp = params(key)
    geom = dict(slots=2, s_max=16, pack=True, paged=paged)
    jeng = reference_engine(jcfg, jp, **geom)
    eng = ServeEngine(cfg, tp, device="cpu", **geom)
    for rid, prompt, n, ctx in _trace(cfg, trace_seed):
        jeng.submit(JRequest(rid, prompt, n, ctx=ctx))
        eng.submit(Request(rid, prompt, n, ctx=ctx))
    jrep, rep = jeng.run(), eng.run()
    want = {rid: jrep.tokens(rid).tolist() for rid in jrep.sessions}
    assert {rid: rep.tokens(rid).tolist() for rid in rep.sessions} == want
    assert all(0 <= t < cfg.vocab for ts in want.values() for t in ts)
    assert eng.blocks is None
    for f in COUNTERS:
        assert getattr(rep.stats, f) == getattr(jrep.stats, f), f
