"""The port's serve engine on RecurrentGemma (``rglru`` + ``local``)
against ``repro.serve.ServeEngine``: greedy tokens identical on every trace
of ``test_torch_serve.test_bf16_greedy_tokens_match_reference`` (parameter
keys 7 and 11, trace seeds 0-3), in bf16 (packed, paged, jitted reference)
and in f32 (``test_torch_hybrid_serve_f32.py``), for the binarized arch
and the full-precision one, with the scheduling counters the reference
reports.  Prefix caching is off for the
arch in both packages (its state is not block-granular)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import lm as jlm
from repro.serve import ServeEngine as JServeEngine
from repro.serve import synthetic_trace as jsynthetic_trace
import repro_torch.configs as configs
from repro_torch import convert
from repro_torch.serve import ServeEngine, synthetic_trace

TRACE = dict(prompt_lens=(4, 8, 12, 16), new_tokens=(4, 8),
             prefix_frac=0.5, prefix_len=16)


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


ARCHS = ["recurrentgemma-2b+xnor", "recurrentgemma-2b"]


def check_tokens(params, arch, dtype, key, trace_seed):
    jcfg, jp, cfg, tp = params(arch, dtype, key)
    jeng = JServeEngine(jcfg, jp, slots=2, s_max=40, pack=True, paged=True)
    for r in jsynthetic_trace(6, jcfg.vocab, seed=trace_seed, **TRACE):
        jeng.submit(r)
    jrep = jeng.run()
    want = {rid: jrep.tokens(rid).tolist() for rid in jrep.sessions}
    eng = ServeEngine(cfg, tp, slots=2, s_max=40, pack=True, device="cpu")
    for r in synthetic_trace(6, cfg.vocab, seed=trace_seed, **TRACE):
        eng.submit(r)
    rep = eng.run()
    got = {rid: rep.tokens(rid).tolist() for rid in rep.sessions}
    assert got == want
    assert sum(len(t) for t in want.values()) >= 24
    assert not eng.prefix_caching and rep.stats.prefix_hits == 0
    for f in ("prefill_chunks", "decode_steps", "prefix_hits"):
        assert getattr(rep.stats, f) == getattr(jrep.stats, f), f


@pytest.mark.parametrize("trace_seed", [0, 1, 2, 3])
@pytest.mark.parametrize("key", [7, 11])
@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_greedy_tokens_match_reference(params, arch, key, trace_seed):
    check_tokens(params, arch, "bfloat16", key, trace_seed)
