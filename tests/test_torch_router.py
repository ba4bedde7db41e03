"""The port's replicated tier: ``StragglerPolicy`` (the cases of
``tests/test_fault.py``), replica placement, least-loaded admission, the
kill drill — zero token divergence from one engine and from the
reference's Router on the same trace — and the integrity scrubber, which
must flag one flipped word of a replica's packed weights.
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
import repro_torch.configs as configs
from repro_torch import convert
from repro_torch.distributed.fault import StragglerPolicy
from repro_torch.launch.mesh import replica_devices
from repro_torch.serve import Request, Router, ServeEngine, synthetic_trace

# ---------------------------------------------------------------------------
# StragglerPolicy.observe
# ---------------------------------------------------------------------------


def test_policy_warmup_is_always_ok():
    p = StragglerPolicy()
    assert [p.observe(s, dt) for s, dt in
            enumerate([0.01, 0.01, 5.0, 0.01])] == ["ok"] * 4
    assert p.events == [] and p.strikes == 0


def test_policy_flags_slow_step_against_trailing_median():
    p = StragglerPolicy(straggler_factor=2.0)
    for s in range(6):
        assert p.observe(s, 0.01) == "ok"
    assert p.observe(6, 0.05) == "straggler"
    assert p.strikes == 1
    [(step, dt, med)] = p.events
    assert step == 6 and dt == 0.05 and med == pytest.approx(0.01)


def test_policy_fast_step_within_factor_is_ok():
    p = StragglerPolicy(straggler_factor=2.0)
    for s in range(6):
        p.observe(s, 0.01)
    assert p.observe(6, 0.02) == "ok"          # strict >
    assert p.strikes == 0


def test_policy_reshard_after_max_strikes_then_resets():
    p = StragglerPolicy(straggler_factor=2.0, max_strikes=3, window=50)
    for s in range(20):
        p.observe(s, 0.01)
    verdicts = [p.observe(100 + i, 0.05) for i in range(3)]
    assert verdicts == ["straggler", "straggler", "reshard"]
    assert p.strikes == 0
    assert p.observe(200, 0.05) == "straggler"
    assert len(p.events) == 4


def test_policy_window_bounds_the_memory():
    p = StragglerPolicy(window=5)
    for s in range(100):
        p.observe(s, 0.01)
    assert len(p._times) == 5


def test_policy_median_excludes_current_sample():
    p = StragglerPolicy(straggler_factor=2.0, window=5)
    for s in range(5):
        p.observe(s, 0.01)
    p.observe(5, 10.0)
    assert p.events[-1][2] == pytest.approx(0.01)


# ---------------------------------------------------------------------------
# placement and admission
# ---------------------------------------------------------------------------


def test_replica_devices():
    assert replica_devices(3, "cpu") == [torch.device("cpu")] * 3
    with pytest.raises(ValueError):
        replica_devices(0, "cpu")


def test_router_runs_on_cuda_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("this case checks the refusal without a card")
    cfg = configs.get("qwen3-4b").smoke()
    with pytest.raises(RuntimeError, match="CUDA"):
        Router(cfg, {}, 2, slots=1, s_max=16, ckpt_dir="unused")


@pytest.fixture(scope="module")
def smoke():
    jcfg = jconfigs.get("qwen2-7b+xnor").smoke(dtype=jnp.float32)
    cfg = configs.get("qwen2-7b+xnor").smoke(dtype=torch.float32)
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jp, cfg, convert.from_jax(cfg, jax.tree.map(np.asarray, jp))


def _router(cfg, tp, d, **kw):
    base = dict(slots=2, s_max=24, ckpt_dir=str(d), seed=0,
                temperature=0.8, epoch_steps=2, device="cpu")
    return Router(cfg, tp, 2, **(base | kw))


def test_least_loaded_admission(smoke, tmp_path):
    _, _, cfg, tp = smoke
    router = _router(cfg, tp, tmp_path)
    reqs = [Request(rid=i, prompt=np.arange(3 + i) % cfg.vocab,
                    max_new_tokens=2) for i in range(5)]
    for r in reqs:
        router.submit(r)
    # 0 -> r0, 1 -> r1, then ties to the lowest index
    assert [router._where[i] for i in range(5)] == [0, 1, 0, 1, 0]
    assert [h.load for h in router.replicas] == [3, 2]
    rep = router.run()
    assert all(s.done for s in rep.sessions.values())
    assert not rep.migrations and not rep.killed


TRACE = dict(prompt_lens=(4, 7, 11), new_tokens=(4, 6, 9))


def test_kill_drill_zero_divergence(smoke, tmp_path):
    """10 requests on 2 replicas x 2 slots at T = 0.8, replica killed at
    router step 3: every request finishes with a single engine's tokens
    and the reference Router's (same drill), sessions migrated, the
    scrubber covered the weights and found nothing."""
    _kill_drill(*smoke, tmp_path)


@pytest.fixture(scope="module")
def recurrent():
    jcfg = jconfigs.get("recurrentgemma-2b+xnor").smoke(dtype=jnp.float32)
    cfg = configs.get("recurrentgemma-2b+xnor").smoke(dtype=torch.float32)
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jp, cfg, convert.from_jax(cfg, jax.tree.map(np.asarray, jp))


def test_kill_drill_zero_divergence_recurrent(recurrent, tmp_path):
    """The same drill on RecurrentGemma: the killed replica's sessions
    drain with their RG-LRU carries, conv buffers and window rings; no
    request diverges.  Prefix caching is off for the arch, so the scrubber
    finds no idle cached block to scan and digests the packed weights."""
    rep = _kill_drill(*recurrent, tmp_path)
    cfg, tp = recurrent[2:]
    assert not ServeEngine(cfg, tp, slots=1, s_max=8,
                           device="cpu").prefix_caching
    assert sum(r.scrub_idle_blocks for r in rep.replicas) == 0


def _kill_drill(jcfg, jp, cfg, tp, tmp_path):
    trace = synthetic_trace(10, cfg.vocab, seed=1, **TRACE)
    eng = ServeEngine(cfg, tp, slots=2, s_max=24, seed=0, temperature=0.8,
                      device="cpu")
    for r in trace:
        eng.submit(r)
    single = eng.run()

    router = _router(cfg, tp, tmp_path / "port")
    for r in trace:
        router.submit(r)
    rep = router.run(kill_at=3)

    jrouter = JRouter(jcfg, jp, 2, slots=2, s_max=24,
                      ckpt_dir=str(tmp_path / "ref"), seed=0,
                      temperature=0.8, epoch_steps=2)
    for r in jsynthetic_trace(10, jcfg.vocab, seed=1, **TRACE):
        jrouter.submit(r)
    jrep = jrouter.run(kill_at=3)

    assert all(s.done for s in rep.sessions.values())
    assert set(rep.sessions) == {r.rid for r in trace}
    for r in trace:
        assert rep.tokens(r.rid).tolist() == single.tokens(r.rid).tolist()
        assert rep.tokens(r.rid).tolist() == jrep.tokens(r.rid).tolist()
    assert rep.killed == jrep.killed and len(rep.migrations) >= 1
    assert [m[:3] for m in rep.migrations] == [m[:3] for m in jrep.migrations]
    assert rep.scrub_passes > 0 and rep.scrub_corruptions == 0
    sr = rep.serve_report()
    assert sr.stats.scrub_weight_leaves > 0
    assert sr.stats.migrations_in == sr.stats.migrations_out == \
        len(rep.migrations)
    return rep


def test_scrubber_flags_one_flipped_word(smoke, tmp_path):
    """After a clean baseline, one flipped word of a replica's resident
    packed weights is exactly one corruption; flipped back, none."""
    _, _, cfg, tp = smoke
    router = _router(cfg, tp, tmp_path)
    for r in synthetic_trace(3, cfg.vocab, seed=4, **TRACE):
        router.submit(r)
    router.run()
    assert router.scrub() == 0
    assert router.scrub() == 0
    victim = router.replicas[1]
    pb = victim.engine.params["seg0_attn"]["attn_wq"].pb
    pb.view(-1)[5] ^= 1 << 7
    assert router.scrub() == 1
    assert victim.engine.stats.scrub_corruptions == 1
    assert router.replicas[0].engine.stats.scrub_corruptions == 0
    pb.view(-1)[5] ^= 1 << 7
    assert router.scrub() == 0


def test_scrubber_baselines_idle_blocks(smoke, tmp_path):
    """Finished requests' cached blocks sit in the idle tier; the scrubber
    baselines them and a write into one is a corruption."""
    _, _, cfg, tp = smoke
    router = _router(cfg, tp, tmp_path, epoch_steps=0)
    prefix = np.arange(16) % cfg.vocab
    for i in range(2):
        router.submit(Request(rid=i, prompt=np.concatenate(
            [prefix, [i + 1]]).astype(np.int32), max_new_tokens=3))
    router.run()
    eng = router.replicas[0].engine
    idle = eng.blocks.idle_blocks
    assert idle, "no cached block went idle"
    assert router.scrub() == 0
    assert eng.stats.scrub_idle_blocks == len(idle)
    eng._state.seg_states[0].k[0, idle[0]].add_(1.0)
    assert router.scrub() == 1
