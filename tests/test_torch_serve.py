"""The port's serve engine against ``repro.serve.ServeEngine``.

Same trace, same (converted) weights, f32 smoke config (and bf16 on
eight traces), paged layout with the prefix cache on and a shared prefix
in the trace: greedy tokens must be identical, and so must the scheduling counters (prefix hits, copies,
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
from repro_torch.kernels import ops
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


def _serve(cfg, params, seed=4, **kw):
    eng = ServeEngine(cfg, params, slots=2, s_max=40, device="cpu", **kw)
    for r in synthetic_trace(6, cfg.vocab, seed=seed, **TRACE):
        eng.submit(r)
    rep = eng.run()
    return {rid: rep.tokens(rid).tolist() for rid in rep.sessions}, rep


@pytest.fixture(scope="module")
def bf16_params():
    """(arch, parameter key) -> (reference cfg, params; port cfg, params)
    in bf16, built once."""
    cache = {}

    def get(arch, key):
        if (arch, key) not in cache:
            jcfg = jconfigs.get(arch).smoke(dtype=jnp.bfloat16)
            cfg = configs.get(arch).smoke(dtype=torch.bfloat16)
            jp = jlm.init_params(jcfg, jax.random.PRNGKey(key))
            cache[arch, key] = (jcfg, jp, cfg, convert.from_jax(
                cfg, jax.tree.map(np.asarray, jp)))
        return cache[arch, key]
    return get


@pytest.mark.parametrize("trace_seed", [0, 1, 2, 3])
@pytest.mark.parametrize("key", [7, 11])
@pytest.mark.parametrize("arch", ["qwen2-7b+xnor", "qwen3-4b"])
def test_bf16_greedy_tokens_match_reference(bf16_params, arch, key,
                                            trace_seed):
    """bf16, packed, paged, prefix cache on: the same greedy tokens as the
    reference on every trace (parameter keys 7 and 11, trace seeds 0-3).
    The port rounds its SwiGLU gate, its second RMSNorm and its CPU decode
    attention where the reference's jitted program rounds them; each of
    the three is needed for some trace (``python tests/test_torch_serve.py
    --undo``).  What still differs in the last bit (reduction order, XLA's
    and torch's f32 exp and rsqrt) moves the bf16 logits by at most one
    ulp (``test_torch_layers.BF16_LOGIT_BOUND``) and changes no token
    here; a trace that starts to differ is to be traced to its first
    differing op, not replaced."""
    jcfg, jp, cfg, tp = bf16_params(arch, key)
    eng = JServeEngine(jcfg, jp, slots=2, s_max=40, pack=True, paged=True)
    for r in jsynthetic_trace(6, jcfg.vocab, seed=trace_seed, **TRACE):
        eng.submit(r)
    rep = eng.run()
    want = {rid: rep.tokens(rid).tolist() for rid in rep.sessions}
    got, _ = _serve(cfg, tp, seed=trace_seed, pack=True)
    assert got == want
    assert sum(len(t) for t in want.values()) >= 24


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


def test_engine_tokens_identical_to_reference_fused(setup, monkeypatch):
    """The same trace through the fused route the card takes
    (``fused_mode("auto")`` resolved as on the card: the fused linear and
    the paged decode op, here their plain versions): the reference's
    tokens and counters."""
    cfg, tp, want, jstats = setup
    resolve = ops.fused_mode
    monkeypatch.setattr(ops, "fused_mode",
                        lambda mode="auto", device="cuda":
                        resolve(mode, "cuda"))
    calls = []
    fused = ops.xnor_linear_fused
    monkeypatch.setattr(ops, "xnor_linear_fused",
                        lambda *a, **k: calls.append(1) or fused(*a, **k))
    got, rep = _serve(cfg, tp, pack=True)
    assert got == want and calls
    assert rep.stats.prefix_hits == jstats.prefix_hits
    assert rep.stats.decode_steps == jstats.decode_steps


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


def _first_difference(arch: str, key: int, seed: int, undo: list) -> str:
    """Where the port's bf16 serving first departs from the reference's on
    one trace of :func:`test_bf16_greedy_tokens_match_reference`: both
    engines record every layer function's output in order (``rms_norm``,
    ``linear``, ``apply_rope``, ``ffn``, ``paged_attention``, ``logits``;
    the reference's through ``jax.debug.callback`` inside its jitted
    programs).  ``undo`` puts back the port's departures from the
    reference (``test_torch_layers._undone``: ``gate``, ``ln2``, ``cpu``).
    Patches the layer functions for the life of the process: for the
    command line only."""
    import contextlib
    import functools

    from repro.models import attention as jattn
    from repro.models import layers as jlayers
    from repro_torch.models import attention as tattn
    from repro_torch.models import layers as tlayers
    from test_torch_layers import _undone

    jrec, trec = [], []

    def jwrap(name, f):
        @functools.wraps(f)
        def w(*a, **k):
            y = f(*a, **k)
            v = y[0] if isinstance(y, tuple) else y
            jax.debug.callback(lambda v: jrec.append(
                (name, np.asarray(v).astype(np.float32))), v, ordered=True)
            return y
        return w

    def twrap(name, f):
        @functools.wraps(f)
        def w(*a, **k):
            y = f(*a, **k)
            trec.append((name, y.float().numpy().copy()))
            return y
        return w

    pairs = [(jlayers, tlayers, n) for n in
             ("rms_norm", "linear", "apply_rope", "ffn", "logits")]
    pairs.append((jattn, tattn, "paged_attention"))
    for jm, tm, n in pairs:
        setattr(jm, n, jwrap(n, getattr(jm, n)))
        setattr(tm, n, twrap(n, getattr(tm, n)))
    jcfg = jconfigs.get(arch).smoke(dtype=jnp.bfloat16)
    cfg = configs.get(arch).smoke(dtype=torch.bfloat16)
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(key))
    tp = convert.from_jax(cfg, jax.tree.map(np.asarray, jp))
    eng = JServeEngine(jcfg, jp, slots=2, s_max=40, pack=True, paged=True)
    for r in jsynthetic_trace(6, jcfg.vocab, seed=seed, **TRACE):
        eng.submit(r)
    rep = eng.run()
    want = {rid: rep.tokens(rid).tolist() for rid in rep.sessions}
    with contextlib.ExitStack() as stack:
        for what in undo:
            stack.enter_context(_undone(what))
        got, _ = _serve(cfg, tp, pack=True, seed=seed)
    n_tok = sum(a != b for rid in want for a, b in zip(want[rid], got[rid]))
    differ, first = 0, None
    for i, ((jn, jv), (tn, tv)) in enumerate(zip(jrec, trec)):
        assert jn == tn, (i, jn, tn)
        tv = tv.reshape(jv.shape) if tv.size == jv.size else tv
        if tv.shape != jv.shape or not np.array_equal(jv, tv,
                                                      equal_nan=True):
            differ += 1
            if first is None:
                first = (i, jn, tuple(jv.shape), int((jv != tv).sum()),
                         float(np.abs(jv - tv).max()))
    return (f"{arch} key {key} trace seed {seed} undo {undo or 'none'}: "
            f"tokens differ {n_tok}; records {len(jrec)}, differing "
            f"{differ}; first (record, op, shape, elements, max abs) {first}")


if __name__ == "__main__":
    # PYTHONPATH=src python tests/test_torch_serve.py --arch qwen3-4b \
    #     --key 7 --seed 2 [--undo gate|ln2|cpu ...]
    import argparse
    ap = argparse.ArgumentParser(description=_first_difference.__doc__)
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--key", type=int, default=7)
    ap.add_argument("--seed", type=int, default=2)
    ap.add_argument("--undo", action="append", default=[],
                    choices=["gate", "ln2", "cpu"])
    a = ap.parse_args()
    print(_first_difference(a.arch, a.key, a.seed, a.undo))
