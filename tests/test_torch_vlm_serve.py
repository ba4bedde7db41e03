"""The port's serve engine on Llama-3.2-Vision (``attn`` + ``cross``, a
per-request context of patch embeddings) against
``repro.serve.ServeEngine``: greedy tokens identical on 8 traces
(parameter keys 7 and 11, trace seeds 0-3), each layout against the same
layout of the reference (paged here, in bf16 jitted; f32 in
``test_torch_vlm_serve_f32.py``; the slot-dense layout in
``test_torch_vlm_dense*.py``; every file binarized and at full
precision), with the scheduling counters the
reference reports.  Every request brings its own context and the
shared-prefix half of the trace shares one, so prefix hits happen, keyed
on the context as well as the tokens.

The helpers here serve the other ``test_torch_vlm_*`` and
``test_torch_encdec_*`` files (Whisper: the context is frames, encoded
once at admission): the prefix cache keyed on the context,
``generate_static`` / the dense layout / the paged engine against each
other and the reference with a context, temperature sampling, a
migration whose wire carries the context and the cross layers'
``ctx_kv``, and the Router's kill drill (``test_torch_vlm_tier.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.checkpoint import ckpt as jckpt
from repro.models import lm as jlm
from repro.serve import Router as JRouter
from test_torch_reference import reference_engine as JServeEngine
from repro.serve import synthetic_trace as jsynthetic_trace
from repro.train import serve_step as jserve_step
import repro_torch.configs as configs
from repro_torch import convert
from repro_torch.checkpoint import ckpt
from repro_torch.models import registry
from repro_torch.serve import Request, Router, ServeEngine, synthetic_trace
from repro_torch.train import serve_step

VLM = "llama-3.2-vision-11b"
TRACE = dict(prompt_lens=(4, 8, 12, 16), new_tokens=(4, 8),
             prefix_frac=0.5, prefix_len=16)
KEY = "ctx-mig-test"


@pytest.fixture(scope="module")
def params():
    """(arch, dtype, key) -> (reference cfg, params; port cfg, params),
    built once."""
    cache = {}

    def get(arch, dtype, key):
        if (arch, dtype, key) not in cache:
            jcfg = jconfigs.get(arch).smoke(dtype=jnp.dtype(dtype))
            cfg = configs.get(arch).smoke(dtype=getattr(torch, dtype))
            jp = jlm.init_params(jcfg, jax.random.PRNGKey(key))
            cache[arch, dtype, key] = (jcfg, jp, cfg, convert.from_jax(
                cfg, jax.tree.map(np.asarray, jp)))
        return cache[arch, dtype, key]
    return get


def trace_of(cfg, n, seed, fn=synthetic_trace, **kw):
    """A seeded trace whose requests bring (T_ctx, d) contexts."""
    return fn(n, cfg.vocab, seed=seed, n_ctx_tokens=cfg.n_ctx_tokens,
              d_model=cfg.d_model, **(TRACE | kw))


def _tokens(rep) -> dict:
    return {rid: rep.tokens(rid).tolist() for rid in rep.sessions}


def check_tokens(params, arch, dtype, key, trace_seed, paged=True,
                 temperature=0.0):
    """6 requests on 2 slots (s_max 40), packed: the reference engine's
    tokens and counters; paged, the prefix cache is on and hit."""
    jcfg, jp, cfg, tp = params(arch, dtype, key)
    geom = dict(slots=2, s_max=40, pack=True, paged=paged,
                temperature=temperature, seed=3)
    jeng = JServeEngine(jcfg, jp, **geom)
    for r in trace_of(jcfg, 6, trace_seed, jsynthetic_trace):
        jeng.submit(r)
    jrep = jeng.run()
    eng = ServeEngine(cfg, tp, device="cpu", **geom)
    for r in trace_of(cfg, 6, trace_seed):
        eng.submit(r)
    rep = eng.run()
    assert _tokens(rep) == _tokens(jrep)
    assert sum(len(t) for t in _tokens(jrep).values()) >= 24
    assert eng.prefix_caching == paged
    if paged:
        assert rep.stats.prefix_hits > 0
    for f in ("prefills", "prefill_chunks", "decode_steps", "prefix_hits",
              "cow_copies"):
        assert getattr(rep.stats, f) == getattr(jrep.stats, f), f


def check_ctx_keys_the_prefix(params, arch):
    """One slot, three requests with one 16-token prompt: the second
    brings the first's context and maps its blocks; the third brings
    another context and maps nothing, in both packages, with the
    reference's tokens."""
    jcfg, jp, cfg, tp = params(arch, "float32", 7)
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, cfg.vocab, 16).astype(np.int32)
    a, b = ((rng.standard_normal((cfg.n_ctx_tokens, cfg.d_model)) * 0.1)
            .astype(np.float32) for _ in range(2))
    reqs = [Request(i, prompt, 4, ctx=c) for i, c in enumerate((a, a, b))]
    reps = []
    geom = dict(slots=1, s_max=24, n_blocks=12)
    for mk in (lambda: ServeEngine(cfg, tp, device="cpu", **geom),
               lambda: JServeEngine(jcfg, jp, **geom)):
        eng = mk()
        hits = []
        for r in reqs:
            eng.submit(r)
            eng.run()
            hits.append(eng.stats.prefix_hits)
        assert hits == [0, 1, 1], hits
        reps.append({r.rid: list(eng.sessions[r.rid].tokens) for r in reqs})
    assert reps[0] == reps[1]


def check_static(params, arch):
    """f32, float weights: ``generate_static`` with a batch of 3 contexts
    gives the reference's tokens, and the dense wrapper ``generate`` and
    the paged engine give the static loop's."""
    jcfg, jp, cfg, tp = params(arch, "float32", 7)
    rng = np.random.default_rng(9)
    prompt = rng.integers(0, cfg.vocab, (3, 6)).astype(np.int32)
    ctx = (rng.standard_normal((3, cfg.n_ctx_tokens, cfg.d_model)) * 0.1) \
        .astype(np.float32)
    want = jserve_step.generate_static(jcfg, jp, jnp.asarray(prompt), 5,
                                       ctx=jnp.asarray(ctx))
    static = serve_step.generate_static(cfg, tp, torch.from_numpy(prompt), 5,
                                        ctx=torch.from_numpy(ctx),
                                        device="cpu")
    assert np.array_equal(static.numpy(), np.asarray(want))
    dense = serve_step.generate(cfg, tp, torch.from_numpy(prompt), 5,
                                ctx=torch.from_numpy(ctx), device="cpu")
    assert np.array_equal(dense.numpy(), static.numpy())
    eng = ServeEngine(cfg, tp, slots=2, s_max=16, pack=False, device="cpu")
    for i in range(3):
        eng.submit(Request(i, prompt[i], 5, ctx=ctx[i]))
    rep = eng.run()
    assert [rep.tokens(i).tolist() for i in range(3)] == \
        static.numpy().tolist()


def _mid_decode_session(eng, max_steps=12):
    for _ in range(max_steps):
        eng.step()
        for slot, sess in eng.pool.active.items():
            if sess.tokens and not sess.done and slot not in eng._prefilling:
                return sess
    raise AssertionError("trace never produced a mid-decode session")


def _ctx_kv_leaves(cfg) -> list:
    """The wire's per-slot leaves: each cross-attending segment's ctx_kv
    (k, v) under ``state/segs/<i>/1``."""
    return [f"state/segs/{i}/1/{j}" for i, (kind, _) in
            enumerate(cfg.segments()) for j in (0, 1)
            if registry.contract(kind).per_slot_state]


def check_migration(params, arch, tmp_path):
    """T = 0.8, f32, float weights.  A session exported mid-decode from a
    2-slot engine, saved encrypted, restored against a 1-slot engine's
    spec: its wire carries the request's context and every cross layer's
    ``ctx_kv`` at batch width 1 (leaf names listed); it finishes with the
    never-migrated tokens (the reference's), as does a session moved
    mid-chunked-prefill, whose destination rebuilds its context.  The
    reference restores the port's wire and finishes it the same."""
    jcfg, jp, cfg, tp = params(arch, "float32", 7)
    geom = dict(s_max=48, seed=0, temperature=0.8, pack=False)
    trace = trace_of(cfg, 3, 3, prompt_lens=(6, 11, 17), new_tokens=(5, 9),
                     prefix_len=0)

    def engine(slots):
        return ServeEngine(cfg, tp, slots=slots, device="cpu", **geom)

    def run(eng):
        for r in trace:
            eng.submit(r)
        return _tokens(eng.run())
    want = run(engine(2))
    jeng = JServeEngine(jcfg, jp, slots=2, **geom)
    for r in trace_of(jcfg, 3, 3, jsynthetic_trace, prompt_lens=(6, 11, 17),
                      new_tokens=(5, 9), prefix_len=0):
        jeng.submit(r)
    assert want == _tokens(jeng.run())

    for where in ("decode", "prefill"):
        a = engine(2)
        for r in trace:
            a.submit(r)
        if where == "decode":
            sess = _mid_decode_session(a)
        else:
            a.step()
            sess = a.pool.active[min(a._prefilling)]
        rid, req = sess.request.rid, sess.request
        wire = a.export_session(rid)
        assert np.array_equal(wire["ctx"], req.ctx)
        for i, (kind, n) in enumerate(cfg.segments()):
            per_slot = wire["state"]["segs"][i][1]
            if registry.contract(kind).per_slot_state:
                assert [tuple(t.shape) for t in per_slot] == [
                    (n, 1, cfg.n_ctx_tokens, cfg.n_kv_heads,
                     cfg.d_head)] * 2
        d = str(tmp_path / where)
        man = ckpt.save(d, 1, wire, root_key=KEY, device="cpu")
        leaves = sorted(k for k in man["leaves"] if k == "ctx"
                        or k.startswith("state/segs/")
                        and k.split("/")[3] == "1")
        assert leaves == sorted(["ctx"] + _ctx_kv_leaves(cfg)), leaves
        b = engine(1)
        restored, _ = ckpt.restore(d, 1, b.export_spec(req), root_key=KEY,
                                   device="cpu")
        b.import_session(req, restored)
        a.release_migrated(rid)
        if where == "prefill":
            assert b._prefilling[0].ctx is not None
        got = {rid: b.run().tokens(rid).tolist()}
        rest = a.run()
        got |= {r.rid: rest.tokens(r.rid).tolist() for r in trace
                if r.rid != rid}
        assert got == want, where
        if where == "decode":
            dst = JServeEngine(jcfg, jp, slots=1, **geom)
            jrestored, _ = jckpt.restore(d, 1, dst.export_spec(req),
                                         root_key=KEY)
            dst.import_session(req, jrestored)
            assert dst.run().tokens(rid).tolist() == want[rid]


def check_kill_drill(params, arch, tmp_path):
    """8 requests with contexts on 2 replicas x 2 slots at T = 0.8, a
    replica killed at router step 3: every request finishes with one
    engine's tokens and the reference Router's (same drill); sessions
    migrated with their contexts and ctx_kv; the scrubber found nothing."""
    jcfg, jp, cfg, tp = params(arch, "float32", 0)
    kw = dict(prompt_lens=(4, 7, 11), new_tokens=(4, 6, 9), prefix_len=0)
    trace = trace_of(cfg, 8, 1, **kw)
    eng = ServeEngine(cfg, tp, slots=2, s_max=24, seed=0, temperature=0.8,
                      device="cpu")
    for r in trace:
        eng.submit(r)
    single = eng.run()
    base = dict(slots=2, s_max=24, seed=0, temperature=0.8, epoch_steps=2)
    router = Router(cfg, tp, 2, ckpt_dir=str(tmp_path / "port"),
                    device="cpu", **base)
    for r in trace:
        router.submit(r)
    rep = router.run(kill_at=3)
    jrouter = JRouter(jcfg, jp, 2, ckpt_dir=str(tmp_path / "ref"), **base)
    for r in trace_of(jcfg, 8, 1, jsynthetic_trace, **kw):
        jrouter.submit(r)
    jrep = jrouter.run(kill_at=3)
    assert all(s.done for s in rep.sessions.values())
    for r in trace:
        assert rep.tokens(r.rid).tolist() == single.tokens(r.rid).tolist()
        assert rep.tokens(r.rid).tolist() == jrep.tokens(r.rid).tolist()
    assert rep.killed == jrep.killed and len(rep.migrations) >= 1
    assert [m[:3] for m in rep.migrations] == [m[:3] for m in jrep.migrations]
    assert rep.scrub_passes > 0 and rep.scrub_corruptions == 0


@pytest.mark.parametrize("trace_seed", [0, 1, 2, 3])
@pytest.mark.parametrize("key", [7, 11])
def test_bf16_paged_tokens_match_reference(params, key, trace_seed):
    check_tokens(params, VLM + "+xnor", "bfloat16", key, trace_seed)


def test_ctx_keys_the_prefix_cache(params):
    check_ctx_keys_the_prefix(params, VLM + "+xnor")


@pytest.mark.parametrize("trace_seed", [0, 1, 2, 3])
@pytest.mark.parametrize("key", [7, 11])
def test_bf16_paged_full_precision_tokens_match_reference(params, key,
                                                          trace_seed):
    check_tokens(params, VLM, "bfloat16", key, trace_seed)
