"""The port's serve engine on the mixture-of-experts archs against
``repro.serve.ServeEngine``: greedy tokens identical on 8 traces
(parameter keys 7 and 11, trace seeds 0-3), each layout against the same
layout of the reference (paged here, in bf16 jitted; f32 in
``test_torch_moe_serve_f32.py``; the slot-dense layout in
``test_torch_moe_dense*.py``), with the scheduling counters the reference
reports.  Both archs are served: moonshot-v1-16b-a3b binarized (its
attention packed) and llama4-scout-17b-a16e at full precision here; the
dense files swap the two.  The prefix cache is on (the kind is
prefix-shareable) and the traces share a 16-token prefix."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import lm as jlm
from test_torch_reference import reference_engine as JServeEngine
from repro.serve import synthetic_trace as jsynthetic_trace
import repro_torch.configs as configs
from repro_torch import convert
from repro_torch.serve import ServeEngine, synthetic_trace

TRACE = dict(prompt_lens=(4, 8, 12, 16), new_tokens=(4, 8),
             prefix_frac=0.5, prefix_len=16)
ARCHS = ["moonshot-v1-16b-a3b+xnor", "llama4-scout-17b-a16e"]


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
    jcfg, jp, cfg, tp = params(arch, dtype, key)
    jeng = JServeEngine(jcfg, jp, slots=2, s_max=40, pack=True, paged=paged)
    for r in jsynthetic_trace(6, jcfg.vocab, seed=trace_seed, **TRACE):
        jeng.submit(r)
    jrep = jeng.run()
    want = {rid: jrep.tokens(rid).tolist() for rid in jrep.sessions}
    eng = ServeEngine(cfg, tp, slots=2, s_max=40, pack=True, paged=paged,
                      device="cpu")
    for r in synthetic_trace(6, cfg.vocab, seed=trace_seed, **TRACE):
        eng.submit(r)
    rep = eng.run()
    got = {rid: rep.tokens(rid).tolist() for rid in rep.sessions}
    assert got == want
    assert sum(len(t) for t in want.values()) >= 24
    assert eng.prefix_caching == paged
    for f in ("prefills", "prefill_chunks", "decode_steps", "prefix_hits",
              "cow_copies"):
        assert getattr(rep.stats, f) == getattr(jrep.stats, f), f


@pytest.mark.parametrize("trace_seed", [0, 1, 2, 3])
@pytest.mark.parametrize("key", [7, 11])
@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_greedy_tokens_match_reference(params, arch, key, trace_seed):
    check_tokens(params, arch, "bfloat16", key, trace_seed)
