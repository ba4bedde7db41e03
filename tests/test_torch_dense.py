"""The port's slot-dense layout and static-batch loop against the JAX
package: ``lm.prefill`` / ``lm.decode_step`` logits, the engine with
``paged=False``, ``serve_step.generate_static`` and ``generate``.

Logits are held at 1e-4 in f32 (the paged tests' tolerance) and within
``BF16_LOGIT_BOUND`` (one bf16 ulp of a smoke logit) in bf16 against the
reference run jitted, as its engine runs it (XLA keeps a bf16 sum read by
an f32 cast in f32; the port rounds where that program rounds).  Tokens
must be equal — greedy and at temperature 0.8, whose Gumbel noise the
port draws from its threefry twin.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import lm as jlm
from test_torch_reference import reference_engine as JServeEngine
from repro.serve import synthetic_trace as jsynthetic_trace
from repro.train import serve_step as jserve_step
import repro_torch.configs as configs
from repro_torch import convert
from repro_torch.core import prng
from repro_torch.models import lm
from repro_torch.serve import ServeEngine, synthetic_trace
from repro_torch.train import serve_step

from test_torch_layers import BF16_LOGIT_BOUND

CASES = [("qwen2-7b+xnor", {}, True),          # the slice: packed residency
         ("qwen3-4b", {}, False),              # full precision, qk_norm
         ("qwen3-4b", {"kv_cache_dtype": "i8"}, False)]
TRACE = dict(prompt_lens=(4, 7, 12), new_tokens=(3, 6))


def _setup(name, over, dtype, seed=1):
    jcfg = jconfigs.get(name).smoke(dtype=jnp.dtype(str(dtype)[6:]), **over)
    cfg = configs.get(name).smoke(dtype=dtype, **over)
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, jp, cfg, convert.from_jax(cfg, jax.tree.map(np.asarray, jp))


def _prefill_and_decode(name, over, packed, dtype):
    """A 2-row prefill (s_max 24), then three decode steps with per-slot
    positions (row 1 inactive on the last) through both packages on the
    same weights; yields (port, reference) logits per step and checks the
    positions and, in f32, the cached keys."""
    jcfg, jp, cfg, tp = _setup(name, over, dtype)
    if packed:
        jp, tp = jlm.pack_params(jcfg, jp), lm.pack_params(cfg, tp)
    jprefill = functools.partial(jlm.prefill, jcfg, s_max=24)
    jdecode = functools.partial(jlm.decode_step, jcfg)
    if dtype == torch.bfloat16:
        jprefill, jdecode = jax.jit(jprefill), jax.jit(jdecode)
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, jcfg.vocab, size=(2, 9)).astype(np.int32)
    jl, js = jprefill(jp, jnp.asarray(prompt), None)
    tl, ts = lm.prefill(cfg, tp, torch.from_numpy(prompt), s_max=24)
    yield tl.float().numpy(), np.asarray(jl.astype(jnp.float32))
    assert int(ts.pos) == int(js.pos) == 9
    js = js._replace(pos=jnp.full((2,), 9, jnp.int32))
    ts = ts._replace(pos=torch.full((2,), 9, dtype=torch.int32))
    token = np.array([[3], [8]], np.int32)
    for step in range(3):
        active = np.array([True, step < 2])
        jl, js = jdecode(jp, jnp.asarray(token), js,
                         active=jnp.asarray(active))
        tl, ts = lm.decode_step(cfg, tp, torch.from_numpy(token), ts,
                                active=torch.from_numpy(active))
        jl = np.asarray(jl.astype(jnp.float32))
        yield tl.float().numpy(), jl
        token = np.argmax(jl[:, -1, :jcfg.vocab], -1).astype(np.int32)[:, None]
    assert np.array_equal(ts.pos.numpy(), np.asarray(js.pos))
    if dtype == torch.float32:
        np.testing.assert_allclose(
            ts.seg_states[0].k.float().numpy(),
            np.asarray(js.seg_states[0].k).astype(np.float32),
            rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name,over,packed", CASES)
def test_prefill_and_decode_logits(name, over, packed):
    for got, want in _prefill_and_decode(name, over, packed, torch.float32):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name,over,packed", CASES[:2])
def test_prefill_and_decode_logits_bf16(name, over, packed):
    for got, want in _prefill_and_decode(name, over, packed, torch.bfloat16):
        np.testing.assert_allclose(got, want, rtol=0, atol=BF16_LOGIT_BOUND)


def test_decode_state_spec_per_slot_pos():
    cfg = configs.get("qwen3-4b").smoke()
    st = lm.decode_state_spec(cfg, 3, 16, device="cpu", per_slot_pos=True)
    assert st.pos.shape == (3,) and st.pos.dtype == torch.int32
    assert lm.decode_state_spec(cfg, 3, 16, device="cpu").pos.shape == ()
    k = st.seg_states[0].k
    assert k.shape == (cfg.n_layers, 3, cfg.n_kv_heads, 16, cfg.d_head)


@pytest.mark.parametrize("name,dtype,temperature", [
    ("qwen2-7b+xnor", torch.bfloat16, 0.8),
    ("qwen2-7b+xnor", torch.float32, 0.0),
    ("qwen3-4b", torch.float32, 0.8),
    ("qwen3-4b", torch.bfloat16, 0.0)])
def test_dense_engine_tokens_match_reference(name, dtype, temperature):
    """``paged=False``, packed, 2 slots over 6 requests: the reference's
    dense engine's tokens, and the port's own paged engine's."""
    jcfg, jp, cfg, tp = _setup(name, {}, dtype, seed=7)
    kw = dict(slots=2, s_max=24, pack=True, temperature=temperature,
              seed=5)
    jeng = JServeEngine(jcfg, jp, paged=False, **kw)
    for r in jsynthetic_trace(6, jcfg.vocab, seed=2, **TRACE):
        jeng.submit(r)
    jrep = jeng.run()
    got = {}
    for paged in (False, True):
        eng = ServeEngine(cfg, tp, paged=paged, device="cpu", **kw)
        for r in synthetic_trace(6, cfg.vocab, seed=2, **TRACE):
            eng.submit(r)
        rep = eng.run()
        got[paged] = {rid: rep.tokens(rid).tolist() for rid in rep.sessions}
        assert rep.prefills == jrep.prefills == 6
    want = {rid: jrep.tokens(rid).tolist() for rid in jrep.sessions}
    assert got[False] == want
    assert got[True] == want
    assert eng.stats.decode_steps > 0


def test_dense_engine_refuses_migration():
    _, _, cfg, tp = _setup("qwen3-4b", {}, torch.float32)
    eng = ServeEngine(cfg, tp, slots=1, s_max=16, paged=False, device="cpu")
    with pytest.raises(RuntimeError, match="block-paged"):
        eng.export_session(0)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_generate_static_matches_reference(temperature):
    """The static-batch loop (batch prefill + eager decode, key folded per
    step) against the reference's, on float weights."""
    jcfg, jp, cfg, tp = _setup("qwen3-4b", {}, torch.float32, seed=3)
    prompt = np.random.default_rng(8).integers(
        0, jcfg.vocab, (3, 6)).astype(np.int32)
    key = None if temperature == 0 else 8
    want = jserve_step.generate_static(
        jcfg, jp, jnp.asarray(prompt), 5, temperature=temperature,
        key=None if key is None else jax.random.PRNGKey(key))
    got = serve_step.generate_static(
        cfg, tp, torch.from_numpy(prompt), 5, temperature=temperature,
        key=None if key is None else prng.PRNGKey(key), device="cpu")
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_generate_wrapper_matches_reference(temperature):
    """``generate`` (the engine wrapper: dense, float weights, seed drawn
    from the key) against the reference's, and, greedy, against the
    static loop."""
    jcfg, jp, cfg, tp = _setup("qwen3-4b", {}, torch.float32, seed=3)
    prompt = np.random.default_rng(9).integers(
        0, jcfg.vocab, (3, 6)).astype(np.int32)
    want = jserve_step.generate(jcfg, jp, jnp.asarray(prompt), 5,
                                temperature=temperature,
                                key=jax.random.PRNGKey(8))
    got = serve_step.generate(cfg, tp, torch.from_numpy(prompt), 5,
                              temperature=temperature, key=prng.PRNGKey(8),
                              device="cpu")
    assert np.array_equal(got.numpy(), np.asarray(want))
    if temperature == 0:
        static = serve_step.generate_static(cfg, tp,
                                            torch.from_numpy(prompt), 5,
                                            device="cpu")
        assert np.array_equal(got.numpy(), static.numpy())


def test_entry_points_run_on_cuda_unless_asked():
    """Without ``device="cpu"`` the dense engine, the sampled engine and
    the static loops ask for the card, and raise where there is none."""
    if torch.cuda.is_available():
        pytest.skip("this case checks the refusal without a card")
    _, _, cfg, tp = _setup("qwen3-4b", {}, torch.float32)
    prompt = torch.zeros((1, 4), dtype=torch.int32)
    calls = [lambda: ServeEngine(cfg, tp, slots=1, s_max=8, paged=False),
             lambda: ServeEngine(cfg, tp, slots=1, s_max=8, temperature=0.8,
                                 seed=3),
             lambda: serve_step.generate_static(cfg, tp, prompt, 2),
             lambda: serve_step.generate(cfg, tp, prompt, 2)]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


@pytest.mark.parametrize("window,kv_dtype", [(0, "bf16"), (6, "bf16"),
                                             (6, "i8")])
def test_decode_attention_matches_reference(window, kv_dtype):
    """``decode_attention`` on one layer's dense cache: per-slot positions
    (one slot past the window, so a rolling buffer wraps), the i8 cache,
    f32 activations; outputs at 1e-4 and the written caches equal."""
    from repro.models import attention as jattn
    from repro_torch.models import attention as attn

    over = {} if kv_dtype == "bf16" else {"kv_cache_dtype": "i8"}
    jcfg, jp, cfg, tp = _setup("qwen3-4b", over, torch.float32)
    jlayer = jax.tree.map(lambda a: a[0], jp["seg0_attn"])
    tlayer = {k: v[0] for k, v in tp["seg0_attn"].items()}
    jap = {k[5:]: v for k, v in jlayer.items() if k.startswith("attn_")}
    tap = {k[5:]: v for k, v in tlayer.items() if k.startswith("attn_")}
    rng = np.random.default_rng(5)
    s_max = window or 12
    b = 3
    kdt = np.int8 if kv_dtype == "i8" else np.float32
    ck = rng.standard_normal((b, cfg.n_kv_heads, s_max, cfg.d_head))
    cv = rng.standard_normal((b, cfg.n_kv_heads, s_max, cfg.d_head))
    if kdt == np.int8:
        ck, cv = (np.clip(np.round(a * 32), -127, 127) for a in (ck, cv))
    ck, cv = ck.astype(kdt), cv.astype(kdt)
    pos = np.array([0, 4, 9], np.int32)
    x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    jout, jcache = jattn.decode_attention(
        jcfg, jap, jnp.asarray(x), jattn.KVCache(jnp.asarray(ck),
                                                 jnp.asarray(cv)),
        jnp.asarray(pos), window=window)
    cache = attn.KVCache(torch.from_numpy(ck.copy()),
                         torch.from_numpy(cv.copy()))
    out = attn.decode_attention(cfg, tap, torch.from_numpy(x), cache,
                                torch.from_numpy(pos), window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-4,
                               atol=1e-4)
    for got, want in zip(cache, jcache):
        if kdt == np.int8:
            assert np.array_equal(got.numpy(), np.asarray(want))
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("rolling,s", [(False, 5), (True, 5), (True, 11)])
def test_kv_from_seq_matches_reference(rolling, s):
    """Prefill's cache layout, padded, and as a rolling window buffer."""
    from repro.models import blocks as jblocks
    from repro_torch.models import blocks

    jcfg = jconfigs.get("qwen3-4b").smoke(dtype=jnp.float32)
    cfg = configs.get("qwen3-4b").smoke(dtype=torch.float32)
    rng = np.random.default_rng(s)
    k, v = (rng.standard_normal((2, s, cfg.n_kv_heads, cfg.d_head))
            .astype(np.float32) for _ in range(2))
    want = jblocks._kv_from_seq(jcfg, jnp.asarray(k), jnp.asarray(v), 8,
                                rolling=rolling)
    got = blocks._kv_from_seq(cfg, torch.from_numpy(k), torch.from_numpy(v),
                              8, rolling=rolling)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
