"""The port's serve engine on xLSTM-350M (``mlstm`` + ``slstm``, per-slot
state only: no paged pool, no prefix cache) against
``repro.serve.ServeEngine``: greedy tokens identical on 8 traces
(parameter keys 7 and 11, trace seeds 0-3), binarized and at full
precision, with the scheduling counters the reference reports.  Paged in
bf16 here (jitted reference), f32 in ``test_torch_xlstm_serve_f32.py``,
the slot-dense layout in ``test_torch_xlstm_dense*.py``.  The reference
engines share their compiled programs (``test_torch_reference.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import lm as jlm
from repro.serve import synthetic_trace as jsynthetic_trace
import repro_torch.configs as configs
from repro_torch import convert
from repro_torch.serve import ServeEngine, synthetic_trace
from test_torch_reference import COUNTERS, TRACE, reference_engine

ARCHS = ["xlstm-350m+xnor", "xlstm-350m"]


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


def check_tokens(params, arch, dtype, key, trace_seed, paged=True):
    """6 requests on 2 slots (s_max 40), packed: the reference engine's
    tokens and counters; no pool, so prefix caching is off in both."""
    jcfg, jp, cfg, tp = params(arch, dtype, key)
    geom = dict(slots=2, s_max=40, pack=True, paged=paged)
    jeng = reference_engine(jcfg, jp, **geom)
    for r in jsynthetic_trace(6, jcfg.vocab, seed=trace_seed, **TRACE):
        jeng.submit(r)
    jrep = jeng.run()
    want = {rid: jrep.tokens(rid).tolist() for rid in jrep.sessions}
    eng = ServeEngine(cfg, tp, device="cpu", **geom)
    for r in synthetic_trace(6, cfg.vocab, seed=trace_seed, **TRACE):
        eng.submit(r)
    rep = eng.run()
    assert {rid: rep.tokens(rid).tolist() for rid in rep.sessions} == want
    assert sum(len(t) for t in want.values()) >= 24
    assert eng.blocks is None and not eng.prefix_caching
    for f in COUNTERS:
        assert getattr(rep.stats, f) == getattr(jrep.stats, f), f


@pytest.mark.parametrize("trace_seed", [0, 1, 2, 3])
@pytest.mark.parametrize("key", [7, 11])
@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_paged_tokens_match_reference(params, arch, key, trace_seed):
    check_tokens(params, arch, "bfloat16", key, trace_seed)
