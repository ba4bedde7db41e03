"""The port's configs against the reference's, and the two dense configs
this port adds beside qwen2-7b / qwen3-4b (phi4-mini-3.8b, qwen3-14b),
served at their smoke size with the reference engine's greedy tokens;
every kind's contract (``moe``, ``cross``, ``enc``, ``dec``, ``mlstm``,
``slstm`` and ``bindense`` among them) and the MoE archs' parameter
trees.

Every ported arch must equal the reference's config field by field, full
size and smoke; the port's registry lists the reference's eleven archs."""

import dataclasses

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
from repro_torch.models import registry
from repro_torch.serve import ServeEngine, synthetic_trace

TRACE = dict(prompt_lens=(4, 8, 12, 16), new_tokens=(4, 8),
             prefix_frac=0.5, prefix_len=16)
PORTED = sorted(configs.ALL)


def test_registry_lists_the_ported_archs():
    assert PORTED == ["llama-3.2-vision-11b", "llama4-scout-17b-a16e",
                      "moonshot-v1-16b-a3b", "phi4-mini-3.8b", "qwen2-7b",
                      "qwen3-14b", "qwen3-4b", "recurrentgemma-2b",
                      "whisper-tiny", "xlstm-350m", "xnor-cnn"]
    assert PORTED == sorted(jconfigs.ALL)
    for name in ("xlstm-350m", "xlstm-350m+xnor", "xnor-cnn"):
        assert configs.get(name).name == name
    with pytest.raises(KeyError):
        configs.get("xlstm-1b")
    for name in PORTED:           # every config's kinds are registered
        cfg = configs.get(name)
        for kind, _ in cfg.segments() + cfg.encoder_segments():
            registry.get(kind)


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("xnor", [False, True])
@pytest.mark.parametrize("name", PORTED)
def test_config_equals_the_references(name, xnor, smoke):
    """Every field the port declares, and the derived ones, are the
    reference's (dtypes by name)."""
    arch = name + ("+xnor" if xnor else "")
    t, j = configs.get(arch), jconfigs.get(arch)
    if smoke:
        t, j = t.smoke(), j.smoke()
    for f in dataclasses.fields(t):
        got, want = getattr(t, f.name), getattr(j, f.name)
        if f.name == "dtype":
            got, want = str(got)[6:], jnp.dtype(want).name
        assert got == want, (arch, f.name, got, want)
    for prop in ("q_per_kv", "padded_vocab"):
        assert getattr(t, prop) == getattr(j, prop)
    assert t.segments() == j.segments()
    assert t.layer_kinds() == j.layer_kinds()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "phi4-mini-3.8b+xnor",
                                  "qwen3-14b", "qwen3-14b+xnor"])
def test_smoke_greedy_tokens_match_reference(arch, dtype):
    """phi4-mini (G 3) and qwen3-14b (G 5, qk_norm) at smoke size, paged,
    packed where binarized, prefix cache on: the reference engine's greedy
    tokens and counters."""
    jcfg = jconfigs.get(arch).smoke(dtype=jnp.dtype(dtype))
    cfg = configs.get(arch).smoke(dtype=getattr(torch, dtype))
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(7))
    tp = convert.from_jax(cfg, jax.tree.map(np.asarray, jp))
    jeng = JServeEngine(jcfg, jp, slots=2, s_max=40, pack=True, paged=True)
    for r in jsynthetic_trace(6, jcfg.vocab, seed=0, **TRACE):
        jeng.submit(r)
    jrep = jeng.run()
    eng = ServeEngine(cfg, tp, slots=2, s_max=40, pack=True, device="cpu")
    for r in synthetic_trace(6, cfg.vocab, seed=0, **TRACE):
        eng.submit(r)
    rep = eng.run()
    assert ({rid: rep.tokens(rid).tolist() for rid in rep.sessions}
            == {rid: jrep.tokens(rid).tolist() for rid in jrep.sessions})
    assert rep.stats.prefix_hits == jrep.stats.prefix_hits > 0
    assert rep.stats.decode_steps == jrep.stats.decode_steps


@pytest.mark.parametrize("kind", ["attn", "local", "rglru", "moe", "cross",
                                  "enc", "dec", "mlstm", "slstm",
                                  "bindense"])
def test_contract_equals_the_references(kind):
    """Every field of the reference's contract is the port's, and the port
    declares every field the reference does and one more,
    ``decode_writes_slot``, False only for the kinds whose decode reads
    its per-slot state and never writes it (a context's keys and values,
    ``bindense``'s gate); only the encoder's kind does not decode."""
    from repro.models import bcnn as jbcnn  # noqa: F401 (registers it)
    from repro.models import registry as jregistry
    t, j = registry.contract(kind), jregistry.contract(kind)
    assert {f.name for f in dataclasses.fields(t)} == \
        {f.name for f in dataclasses.fields(j)} | {"decode_writes_slot"}
    for f in dataclasses.fields(j):
        assert getattr(t, f.name) == getattr(j, f.name), (kind, f.name)
    assert t.decode_writes_slot == (kind not in ("cross", "dec",
                                                 "bindense"))
    assert t.decodes == (kind != "enc")
    assert t.routed_experts == (kind == "moe")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b+xnor",
                                  "llama4-scout-17b-a16e"])
def test_from_jax_carries_the_moe_tree(arch, dtype):
    """The reference's smoke tree converts leaf for leaf: the router in
    f32, the experts in the config's dtype, bitwise."""
    jcfg = jconfigs.get(arch).smoke(dtype=jnp.dtype(dtype))
    cfg = configs.get(arch).smoke(dtype=getattr(torch, dtype))
    jp = jax.tree.map(np.asarray, jlm.init_params(jcfg,
                                                  jax.random.PRNGKey(3)))
    tp = convert.from_jax(cfg, jp)
    seg = tp["seg0_moe"]
    assert seg["moe_router"].dtype == torch.float32
    for k in ("moe_w1", "moe_w3", "moe_w2"):
        assert seg[k].dtype == cfg.dtype
    for k, v in seg.items():
        want = np.asarray(jp["seg0_moe"][k]).astype(np.float32)
        np.testing.assert_array_equal(v.float().numpy(), want, err_msg=k)
    assert sorted(seg) == sorted(jp["seg0_moe"])
