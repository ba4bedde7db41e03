"""The port's serve engine against ``repro.serve.ServeEngine``.

Same trace, same (converted) weights, f32 smoke config, paged layout with
the prefix cache on and a shared prefix in the trace: greedy tokens must
be identical, and so must the scheduling counters (prefix hits, copies,
chunks).  Inside the port, packed residency serves exactly what the float
binary path serves.  The host bookkeeping copies (pools, prefix index) are
driven side by side with the reference's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.configs as jconfigs
from repro.models import lm as jlm
from repro.serve import BlockPool as JBlockPool
from repro.serve import PrefixIndex as JPrefixIndex
from repro.serve import ServeEngine as JServeEngine
from repro.serve import synthetic_trace as jsynthetic_trace
import repro_torch.configs as configs
from repro_torch import convert
from repro_torch.serve import BlockPool, PrefixIndex, ServeEngine
from repro_torch.serve import synthetic_trace

ARCH = "qwen2-7b+xnor"
TRACE = dict(prompt_lens=(4, 8, 12, 16), new_tokens=(4, 8),
             prefix_frac=0.5, prefix_len=16)


@pytest.fixture(scope="module")
def setup():
    jcfg = jconfigs.get(ARCH).smoke(dtype=jnp.float32)
    cfg = configs.get(ARCH).smoke(dtype=torch.float32)
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(7))
    tp = convert.from_jax(cfg, jax.tree.map(np.asarray, jp))
    eng = JServeEngine(jcfg, jp, slots=2, s_max=40, pack=True, paged=True)
    for r in jsynthetic_trace(6, jcfg.vocab, seed=4, **TRACE):
        eng.submit(r)
    rep = eng.run()
    want = {rid: rep.tokens(rid).tolist() for rid in rep.sessions}
    return cfg, tp, want, rep.stats


def _serve(cfg, params, **kw):
    eng = ServeEngine(cfg, params, slots=2, s_max=40, device="cpu", **kw)
    for r in synthetic_trace(6, cfg.vocab, seed=4, **TRACE):
        eng.submit(r)
    rep = eng.run()
    return {rid: rep.tokens(rid).tolist() for rid in rep.sessions}, rep


def test_trace_matches_reference():
    a = jsynthetic_trace(6, 256, seed=4, **TRACE)
    b = synthetic_trace(6, 256, seed=4, **TRACE)
    assert [(r.rid, r.prompt.tolist(), r.max_new_tokens) for r in a] == \
        [(r.rid, r.prompt.tolist(), r.max_new_tokens) for r in b]


def test_engine_tokens_identical_to_reference(setup):
    cfg, tp, want, jstats = setup
    got, rep = _serve(cfg, tp)
    assert got == want
    st = rep.stats
    assert st.prefix_hits == jstats.prefix_hits > 0
    assert st.cow_copies == jstats.cow_copies
    assert st.prefix_tokens == jstats.prefix_tokens
    assert st.prefill_chunks == jstats.prefill_chunks
    assert st.decode_steps == jstats.decode_steps
    assert all(s.done for s in rep.sessions.values())


def test_packed_serves_exactly_as_float(setup):
    cfg, tp, want, _ = setup
    packed, _ = _serve(cfg, tp, pack=True)
    flt, _ = _serve(cfg, tp, pack=False)
    assert packed == flt == want


def test_prefix_cache_off_same_tokens(setup):
    cfg, tp, want, _ = setup
    got, rep = _serve(cfg, tp, prefix_cache=False)
    assert got == want
    assert rep.stats.prefix_hits == 0 and not rep.stats.cow_copies


def test_engine_rejects_unported_modes(setup):
    cfg, tp, _, _ = setup
    with pytest.raises(NotImplementedError):
        ServeEngine(cfg, tp, slots=1, s_max=16, temperature=0.7,
                    device="cpu")
    eng = ServeEngine(cfg, tp, slots=1, s_max=16, device="cpu")
    from repro_torch.serve import Request
    with pytest.raises(ValueError):         # does not fit s_max
        eng.submit(Request(rid=0, prompt=np.arange(12), max_new_tokens=8))


def test_pools_and_prefix_index_track_reference():
    rng = np.random.default_rng(0)
    jpool, pool = JBlockPool(12), BlockPool(12)
    for rid in range(4):
        n = int(rng.integers(1, 3))
        assert pool.alloc(rid, n) == jpool.alloc(rid, n)
    for p in (pool, jpool):
        p.set_cached(1)
        p.share(9, [1])
        p.free(0)
        p.free(9)
    assert pool.idle_blocks == jpool.idle_blocks
    assert pool.free_blocks == jpool.free_blocks
    assert pool.evict_idle(1) == jpool.evict_idle(1)
    jidx, idx = JPrefixIndex(4), PrefixIndex(4)
    toks = rng.integers(0, 50, size=14).astype(np.int32)
    for (k1, p1, t1), (k2, p2, t2) in zip(jidx.chain(toks), idx.chain(toks)):
        assert k1 == k2 and p1 == p2
        jidx.register(k1, p1, 3, t1)
        idx.register(k2, p2, 3, t2)
    probe = np.concatenate([toks[:6], [99, 98]]).astype(np.int32)
    assert idx.lookup(probe) == jidx.lookup(probe)


def test_profile_decode_runs_on_cpu(capsys):
    from repro_torch.launch import profile_decode
    assert profile_decode.main(["--smoke", "--device", "cpu", "--steps",
                                "2", "--slots", "2"]) == 0
    out = capsys.readouterr().out
    assert "decode step wall" in out and "not measured" in out
