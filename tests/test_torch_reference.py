"""What the port's CPU tests share to stay cheap, and the tests that show
the sharing changes no result.

* ``torch.set_num_threads(1)``: the suite runs on several xdist workers
  over a few cores, and torch's default of one thread a core
  oversubscribes them; at the tests' smoke shapes one thread is faster
  even alone (one xlstm-350m+xnor smoke trace through the port's
  engine on an 8-core x86 CPU: 1.24 s on one thread, 2.06 s on eight).
* :func:`reference_engine`: a ``repro.serve.ServeEngine`` whose paged
  programs (chunked prefill, decode, copy-on-write, encode, export,
  import, gather) are the jitted functions of the first engine built
  here for the same config and temperature.  The reference jits them
  per engine, so every new engine compiled them again (2-3 s a trace);
  the functions take the parameters and state as arguments and close
  over nothing else but the config, the temperature and, for trace
  counting, the first engine's ``stats``.  So an engine built here
  computes what a fresh one computes, and its scheduling counters
  (``prefills``, ``prefill_chunks``, ``decode_steps``, ``prefix_hits``,
  ``cow_copies``) are its own: only ``prefill_traces`` /
  ``decode_traces`` stay with the engine that traced.  The slot-dense
  layout's programs are module-level jits keyed on the config already.
"""

import jax
import jax.numpy as jnp
import pytest
import torch

import repro.configs as jconfigs
from repro.models import lm as jlm
from repro.serve import ServeEngine as JServeEngine
from repro.serve import synthetic_trace as jsynthetic_trace

torch.set_num_threads(1)

PAGED_PROGRAMS = ("_chunk_program", "_paged_decode_program", "_cow_program",
                  "_encode_program", "_export_program", "_import_program",
                  "_gather_block_program")
_PROGRAMS: dict = {}


def reference_engine(cfg, params, **kw) -> JServeEngine:
    """``repro.serve.ServeEngine(cfg, params, **kw)`` running the compiled
    paged programs of the first engine built here for ``(cfg,
    temperature)`` (see the module docstring)."""
    eng = JServeEngine(cfg, params, **kw)
    if eng.paged:
        key = (cfg, eng.temperature)
        progs = _PROGRAMS.setdefault(
            key, {n: getattr(eng, n) for n in PAGED_PROGRAMS})
        for name, fn in progs.items():
            setattr(eng, name, fn)
    return eng


TRACE = dict(prompt_lens=(4, 8, 12, 16), new_tokens=(4, 8),
             prefix_frac=0.5, prefix_len=16)
COUNTERS = ("prefills", "prefill_chunks", "decode_steps", "prefix_hits",
            "cow_copies")


def _run(eng, cfg, seed):
    for r in jsynthetic_trace(6, cfg.vocab, seed=seed, **TRACE):
        eng.submit(r)
    rep = eng.run()
    return ({rid: rep.tokens(rid).tolist() for rid in rep.sessions},
            {f: getattr(rep.stats, f) for f in COUNTERS})


@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("arch", ["qwen3-4b+xnor", "xlstm-350m"])
def test_shared_programs_change_no_token_or_counter(arch, temperature):
    """Two parameter keys and two traces through engines that share one
    set of programs give a fresh engine's tokens and counters each, and
    the later engines trace nothing."""
    cfg = jconfigs.get(arch).smoke()
    geom = dict(slots=2, s_max=40, temperature=temperature, seed=3)
    for key, seed in ((7, 0), (11, 1), (7, 2)):
        jp = jlm.init_params(cfg, jax.random.PRNGKey(key))
        shared = reference_engine(cfg, jp, **geom)
        fresh = JServeEngine(cfg, jp, **geom)
        assert _run(shared, cfg, seed) == _run(fresh, cfg, seed)
        assert fresh.stats.prefill_traces == 1
        progs = _PROGRAMS[cfg, float(temperature)]
        assert all(getattr(shared, n) is progs[n] for n in PAGED_PROGRAMS)
        if (key, seed) != (7, 0):
            assert shared.stats.prefill_traces == 0


def test_dense_engines_share_programs_without_help():
    """The slot-dense layout's programs are module-level jits with the
    config static: a second dense engine compiles nothing new and gives
    the first one's tokens and counters."""
    from repro.serve import engine as jengine
    cfg = jconfigs.get("qwen3-4b").smoke(dtype=jnp.float32)
    jp = jlm.init_params(cfg, jax.random.PRNGKey(7))
    outs, sizes = [], []
    for _ in range(2):
        eng = reference_engine(cfg, jp, slots=2, s_max=40, paged=False)
        assert not hasattr(eng, "_chunk_program")
        outs.append(_run(eng, cfg, 0))
        sizes.append((jengine._prefill_program._cache_size(),
                      jengine._decode_program._cache_size()))
    assert outs[0] == outs[1] and sizes[0] == sizes[1]


def test_one_torch_thread():
    """The setting holds for every test in the process."""
    assert torch.get_num_threads() == 1
