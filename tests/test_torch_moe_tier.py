"""The serving tier on the mixture-of-experts archs in the port: what the
reference promises an MoE engine (DESIGN.md §14) and what the card run
gates on.

- The same tokens whatever the slot count (1, 2 and 4 slots; greedy and
  at temperature 0.7) where no prefix is shared: a decode step routes
  each slot as its own one-token group (capacity 1), so slots never
  compete for an expert.
- Prefix caching is on and replays deterministically: the same trace
  through an identically configured engine gives the same tokens, hits
  and copy-on-write copies (a hit is not promised a miss's tokens: it
  shortens the dispatched group).
- A session migrated mid-decode from a 4-slot engine to a 2-slot one
  keeps its tokens; a 2-replica Router with the kill drill gives one
  engine's tokens and the reference Router's.
- ``generate_static`` against the reference's static loop, and the
  launch entry point with ``--dense``, ``--static`` and ``--replicas``.
- The fused route the card takes (the fused linear for the four packed
  attention projections, the paged decode op) against the reference's
  logits, on their plain versions here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import lm as jlm
from repro.serve import Router as JRouter
from repro.serve import synthetic_trace as jsynthetic_trace
from repro.train import serve_step as jserve_step
import repro_torch.configs as configs
from repro_torch import convert
from repro_torch.models import lm
from repro_torch.serve import Router, ServeEngine, synthetic_trace
from repro_torch.train import serve_step

from test_torch_layers import _chunk_and_decode, fused_on_cpu  # noqa: F401
from test_torch_migration import _mid_decode_session, _ship

MOONSHOT, LLAMA4 = "moonshot-v1-16b-a3b+xnor", "llama4-scout-17b-a16e"
TRACE = dict(prompt_lens=(4, 8, 12, 16), new_tokens=(4, 8),
             prefix_frac=0.5, prefix_len=16)


def _setup(arch, dtype, seed=7):
    jcfg = jconfigs.get(arch).smoke(dtype=jnp.dtype(str(dtype)[6:]))
    cfg = configs.get(arch).smoke(dtype=dtype)
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, jp, cfg, convert.from_jax(cfg, jax.tree.map(np.asarray, jp))


@pytest.fixture(scope="module")
def moonshot():
    return _setup(MOONSHOT, torch.bfloat16)


@pytest.fixture(scope="module")
def llama4():
    return _setup(LLAMA4, torch.bfloat16)


def _serve(cfg, tp, trace, **kw):
    eng = ServeEngine(cfg, tp, device="cpu", **({"s_max": 40} | kw))
    for r in trace:
        eng.submit(r)
    rep = eng.run()
    return {rid: rep.tokens(rid).tolist() for rid in rep.sessions}, rep


@pytest.mark.parametrize("temperature", [0.0, 0.7])
@pytest.mark.parametrize("arch", ["moonshot", "llama4"])
def test_same_tokens_at_1_2_and_4_slots(request, arch, temperature):
    """The reference's pin (``tests/test_paged.py``), on a trace with no
    shared prefix: the slot count decides which requests hit a shared
    prefix, and a hit changes the dispatch groups."""
    _, _, cfg, tp = request.getfixturevalue(arch)
    trace = synthetic_trace(6, cfg.vocab, seed=1, prompt_lens=(4, 8, 12, 16),
                            new_tokens=(4, 8))
    got = [_serve(cfg, tp, trace, slots=n, temperature=temperature,
                  seed=3)[0] for n in (1, 2, 4)]
    assert got[0] == got[1] == got[2]
    assert sum(len(t) for t in got[0].values()) >= 24


def test_prefix_cache_replay_is_deterministic(llama4):
    """The reference's MoE replay pin (``tests/test_paged.py``): a
    90 %-shared trace twice through identical engines."""
    _, _, cfg, tp = llama4
    trace = synthetic_trace(6, cfg.vocab, seed=3, prompt_lens=(3, 5),
                            new_tokens=(3, 5), prefix_frac=0.9,
                            prefix_len=9)
    (t1, r1), (t2, r2) = (_serve(cfg, tp, trace, slots=2, s_max=24)
                          for _ in range(2))
    assert t1 == t2
    assert r1.stats.prefix_hits == r2.stats.prefix_hits > 0
    assert r1.stats.cow_copies == r2.stats.cow_copies
    assert r1.stats.prefix_tokens == r2.stats.prefix_tokens > 0


def test_cross_slot_migration_keeps_tokens(moonshot, tmp_path):
    """A session exported mid-decode from a 4-slot engine, through an
    encrypted checkpoint, into a 2-slot one at T = 0.8: the tokens of a
    run that never moved."""
    _, _, cfg, tp = moonshot
    kw = dict(s_max=48, seed=0, temperature=0.8)
    trace = synthetic_trace(5, cfg.vocab, seed=3, prompt_lens=(6, 11, 17),
                            new_tokens=(5, 9))
    want, _ = _serve(cfg, tp, trace, slots=4, **kw)
    a = ServeEngine(cfg, tp, slots=4, device="cpu", **kw)
    for r in trace:
        a.submit(r)
    sess = _mid_decode_session(a)
    rid = sess.request.rid
    b = ServeEngine(cfg, tp, slots=2, device="cpu", **kw)
    _ship(a, b, rid, sess.request, str(tmp_path / "wire"))
    got = {r.rid: (b if r.rid == rid else a).run().tokens(r.rid).tolist()
           for r in trace}
    assert got == want


def test_router_kill_drill_gives_one_engines_tokens(tmp_path):
    """10 requests on 2 replicas x 2 slots at T = 0.8, a replica killed at
    router step 3: every request finishes with a single engine's tokens
    and the reference Router's (same drill), with a migration and a clean
    scrub of the weights (the packed attention planes and the f32 / bf16
    expert leaves alike)."""
    jcfg, jp, cfg, tp = _setup(MOONSHOT, torch.float32, seed=0)
    kw = dict(slots=2, s_max=24, seed=0, temperature=0.8)
    tr = dict(prompt_lens=(4, 7, 11), new_tokens=(4, 6, 9))
    trace = synthetic_trace(10, cfg.vocab, seed=1, **tr)
    single, _ = _serve(cfg, tp, trace, **kw)
    router = Router(cfg, tp, 2, ckpt_dir=str(tmp_path / "port"),
                    epoch_steps=2, device="cpu", **kw)
    for r in trace:
        router.submit(r)
    rep = router.run(kill_at=3)
    jrouter = JRouter(jcfg, jp, 2, ckpt_dir=str(tmp_path / "ref"),
                      epoch_steps=2, **kw)
    for r in jsynthetic_trace(10, jcfg.vocab, seed=1, **tr):
        jrouter.submit(r)
    jrep = jrouter.run(kill_at=3)
    for r in trace:
        assert rep.tokens(r.rid).tolist() == single[r.rid] == \
            jrep.tokens(r.rid).tolist()
    assert rep.killed == jrep.killed and len(rep.migrations) >= 1
    assert [m[:3] for m in rep.migrations] == [m[:3] for m in jrep.migrations]
    assert rep.scrub_passes > 0 and rep.scrub_corruptions == 0


@pytest.mark.parametrize("arch", ["moonshot", "llama4"])
def test_generate_static_matches_reference(request, arch):
    """The static-batch loop in bf16: a 3 x 6 prompt batch (one dispatch
    group of 18 tokens), 5 greedy tokens, against the reference's."""
    jcfg, jp, cfg, tp = request.getfixturevalue(arch)
    prompt = np.random.default_rng(8).integers(
        0, jcfg.vocab, (3, 6)).astype(np.int32)
    want = jserve_step.generate_static(jcfg, jlm.pack_params(jcfg, jp),
                                       jnp.asarray(prompt), 5)
    got = serve_step.generate_static(cfg, lm.pack_params(cfg, tp),
                                      torch.from_numpy(prompt), 5,
                                      device="cpu")
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("args", [[], ["--dense"], ["--static"],
                                  ["--replicas", "2", "--kill-at", "3"]])
def test_launch_serves_the_moe_archs(args, tmp_path):
    from repro_torch.launch import serve
    for arch in (MOONSHOT, "llama4-scout-17b-a16e+xnor"):
        extra = ["--ckpt-dir", str(tmp_path / arch)] if "--replicas" in \
            args else []
        assert serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                           "--requests", "3", "--new-tokens", "3",
                           "--prompt-len", "8"] + args + extra) == 0


def test_fused_route_matches_reference(fused_on_cpu):  # noqa: F811
    """f32, through the fused route the card takes: one chunk's and one
    decode step's 4 attention linears a layer go through the fused
    linear, decode attention through the paged decode op (their plain
    versions here), the experts through torch products: the reference's
    logits at 1e-4."""
    for got, want in _chunk_and_decode(MOONSHOT, {}, True, torch.float32):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    n = configs.get(MOONSHOT).smoke().n_layers
    assert fused_on_cpu["paged_decode_attention"] == 2 * n
    assert fused_on_cpu["xnor_linear_fused"] == 4 * 4 * n
