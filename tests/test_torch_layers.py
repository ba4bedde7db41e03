"""The port's model path against the JAX reference at smoke size.

The reference's parameters (``repro.models.lm.init_params``) are carried
into the port with ``repro_torch.convert.from_jax``; both packages then
run one chunked-prefill piece and one paged decode step over the same
block tables, and the logits are compared.  f32 configs, CPU: the
reference runs its ref path (the unfused chain), the port its plain
versions; logits agree to 1e-4 (reduction order differs, signs do not).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.configs as jconfigs
from repro.models import lm as jlm
import repro_torch.configs as configs
from repro_torch import convert
from repro_torch.models import lm
from repro_torch.serve import ServeEngine

CASES = [("qwen2-7b+xnor", {}, True),          # the slice: packed residency
         ("qwen2-7b+xnor", {}, False),         # float binary (STE forward)
         ("qwen3-4b", {}, False),              # full precision, qk_norm
         ("qwen3-4b", {"kv_cache_dtype": "i8"}, False)]


def _cfgs(name, over):
    jcfg = jconfigs.get(name).smoke(dtype=jnp.float32, **over)
    cfg = configs.get(name).smoke(dtype=torch.float32, **over)
    return jcfg, cfg


def _params(jcfg, cfg, seed=0):
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, convert.from_jax(cfg, jax.tree.map(np.asarray, jp))


def test_configs_match_reference():
    for name in ("qwen2-7b+xnor", "qwen3-4b"):
        for full in (True, False):
            j = jconfigs.get(name)
            t = configs.get(name)
            if not full:
                j, t = j.smoke(), t.smoke()
            for f in ("name", "n_layers", "d_model", "n_heads", "n_kv_heads",
                      "d_ff", "vocab", "d_head", "qkv_bias", "qk_norm",
                      "rope_theta", "quant", "block_size", "prefill_chunk",
                      "padded_vocab", "q_per_kv"):
                assert getattr(t, f) == getattr(j, f), (name, f)
            assert t.segments() == j.segments()
    full = configs.get("qwen2-7b+xnor")
    assert full.dtype == torch.bfloat16 and full.d_head == 128
    assert full.q_per_kv == 7


def test_from_jax_rejects_mismatched_tree():
    jcfg, cfg = _cfgs("qwen2-7b+xnor", {})
    jp, _ = _params(jcfg, cfg)
    tree = jax.tree.map(np.asarray, jp)
    del tree["embed"]["lm_head"]
    with pytest.raises(ValueError):
        convert.from_jax(cfg, tree)


@pytest.mark.parametrize("name,over,packed", CASES)
def test_prefill_chunk_and_decode_logits(name, over, packed):
    jcfg, cfg = _cfgs(name, over)
    jp, tp = _params(jcfg, cfg, seed=1)
    if packed:
        jp, tp = jlm.pack_params(jcfg, jp), lm.pack_params(cfg, tp)
    slots, s_max, bs, c = 2, 32, jcfg.block_size, jcfg.prefill_chunk
    widths = jlm.paged_table_widths(jcfg, s_max, bs, c)
    assert widths == lm.paged_table_widths(cfg, s_max, bs, c)
    n_blocks = 1 + slots * widths["full"]
    jstate = jlm.paged_decode_state_spec(jcfg, slots, s_max,
                                         n_blocks=n_blocks, block_size=bs,
                                         abstract=False)
    tstate = lm.paged_decode_state_spec(cfg, slots, n_blocks=n_blocks,
                                        block_size=bs, device="cpu")
    # slot 0 owns blocks 1..W, slot 1 the next W, in permuted order
    rng = np.random.default_rng(0)
    ids = rng.permutation(np.arange(1, n_blocks)).astype(np.int32)
    table = ids.reshape(slots, widths["full"])
    prompt = rng.integers(0, jcfg.vocab, size=(2 * c,)).astype(np.int32)
    n_last = c - 3                                   # a ragged second chunk
    for j, n_valid in enumerate((c, n_last)):
        toks = np.zeros((1, c), np.int32)
        toks[0, :n_valid] = prompt[j * c:j * c + n_valid]
        jl, jstate = jlm.prefill_chunk_step(
            jcfg, jp, jnp.asarray(toks), jstate, jnp.int32(0),
            jnp.int32(n_valid), {"full": jnp.asarray(table[:1])},
            fresh=jnp.asarray(j == 0), start=jnp.int32(0))
        tl, tstate = lm.prefill_chunk_step(
            cfg, tp, torch.from_numpy(toks), tstate, 0, n_valid,
            {"full": torch.from_numpy(table[:1].copy())}, fresh=j == 0)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   rtol=1e-4, atol=1e-4)
    assert np.array_equal(tstate.pos.numpy(), np.asarray(jstate.pos))
    # decode: slot 0 continues, slot 1 is dead (zeroed table row, inactive)
    dtable = table.copy()
    dtable[1] = 0
    token = np.array([[5], [0]], np.int32)
    active = np.array([True, False])
    for _ in range(2):
        jl, jstate = jlm.paged_decode_step(
            jcfg, jp, jnp.asarray(token), jstate,
            {"full": jnp.asarray(dtable)}, active=jnp.asarray(active))
        tl, tstate = lm.paged_decode_step(
            cfg, tp, torch.from_numpy(token), tstate,
            {"full": torch.from_numpy(dtable)},
            active=torch.from_numpy(active))
        np.testing.assert_allclose(tl[0].numpy(), np.asarray(jl)[0],
                                   rtol=1e-4, atol=1e-4)
        token[0, 0] = int(np.argmax(np.asarray(jl)[0, -1, :jcfg.vocab]))
    assert np.array_equal(tstate.pos.numpy(), np.asarray(jstate.pos))
    jk = np.asarray(jstate.seg_states[0].k)
    tk = tstate.seg_states[0].k.float().numpy()
    live = np.unique(table[0])                       # slot 0's blocks
    np.testing.assert_allclose(tk[:, live], jk[:, live].astype(np.float32),
                               rtol=1e-4, atol=1e-4)


def test_entry_points_need_cuda_unless_cpu_asked():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    cfg = configs.get("qwen2-7b+xnor").smoke(dtype=torch.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.init_params(cfg, 0)
    params = lm.init_params(cfg, 0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(cfg, params, slots=1, s_max=16)
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "qwen2-7b+xnor", "--smoke"])
    assert serve.main(["--arch", "qwen2-7b+xnor", "--smoke", "--device",
                       "cpu", "--requests", "2", "--new-tokens", "3",
                       "--prompt-len", "8"]) == 0


@pytest.mark.parametrize("name", ["qwen2-7b+xnor", "qwen2-7b"])
def test_unfused_decode_matches_reference(name):
    """fused_decode="off": the decode step's attention runs the gather /
    mask / softmax chain (on any device — the reference's XLA code has no
    kernel); one prefill chunk and one decode step match the reference's
    logits at this suite's tolerance."""
    jcfg, cfg = _cfgs(name, {"fused_decode": "off"})
    jp, tp = _params(jcfg, cfg, seed=2)
    if cfg.quant == "xnor":
        jp, tp = jlm.pack_params(jcfg, jp), lm.pack_params(cfg, tp)
    bs, c = cfg.block_size, cfg.prefill_chunk
    w = lm.paged_table_widths(cfg, 32, bs, c)["full"]
    jstate = jlm.paged_decode_state_spec(jcfg, 1, 32, n_blocks=1 + w,
                                         block_size=bs, abstract=False)
    tstate = lm.paged_decode_state_spec(cfg, 1, n_blocks=1 + w,
                                        block_size=bs, device="cpu")
    table = np.arange(1, 1 + w, dtype=np.int32)[None]
    toks = np.random.default_rng(5).integers(
        0, cfg.vocab, size=(1, c)).astype(np.int32)
    jl, jstate = jlm.prefill_chunk_step(
        jcfg, jp, jnp.asarray(toks), jstate, jnp.int32(0), jnp.int32(c),
        {"full": jnp.asarray(table)}, fresh=jnp.asarray(True),
        start=jnp.int32(0))
    tl, tstate = lm.prefill_chunk_step(
        cfg, tp, torch.from_numpy(toks), tstate, 0, c,
        {"full": torch.from_numpy(table.copy())}, fresh=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    token = np.array([[int(np.argmax(np.asarray(jl)[0, -1, :cfg.vocab]))]],
                     np.int32)
    jl, _ = jlm.paged_decode_step(jcfg, jp, jnp.asarray(token), jstate,
                                  {"full": jnp.asarray(table)})
    tl, _ = lm.paged_decode_step(cfg, tp, torch.from_numpy(token), tstate,
                                 {"full": torch.from_numpy(table.copy())})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
