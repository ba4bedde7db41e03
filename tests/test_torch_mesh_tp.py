"""Tensor- and expert-parallel serving over gloo ranks on the CPU, on the
(data, model) = (1, 4) mesh, against the single-process ``prefill_step``
/ ``decode_step`` of the same package; the pieces of the parallel
layers on their own.

Every rank keeps its blocks of the parameters (``serve_step.
shard_params``: heads, ``d_ff``, experts and vocab over ``model``, whole
heads a rank) and computes on them: qwen2-7b's smoke config at 6 query
heads and 2 KV heads (ranks 0-2 hold 2 query heads, rank 3 none, and
rank 1's read both KV heads), the same packed ``+xnor`` (the row-parallel
``wo`` and ``w2`` on the unfused pack -> ``xnor_gemm`` chain) and with
its float weights (the sign products' sums over the ranks), moonshot
(top-2 over 4 experts, one a rank), llama4-scout ``+xnor`` (top-1) and
recurrentgemma-2b ``+xnor``, whose ``local`` and ``rglru`` layers have
no tensor-parallel form and are gathered whole a layer at a time.  A
prefill of 12 tokens, then two decode steps of teacher-forced tokens;
every rank's logits rows (all of them: the batch is whole on each rank
of this mesh) are held against the single-process steps in f32 at
``rtol = atol = 1e-5`` (a sum split over four ranks reorders the f32
partials) with equal greedy tokens, and in bf16 within
``BF16_LOGIT_BOUND`` (2^-6 of |logit| + 2^-6, the port's bf16 logit
bound against the reference; the CPU runs read 0 here: the f32 partials,
summed and rounded once, round as the single matmul does at these
widths) with equal greedy tokens.
"""

import numpy as np
import pytest
import torch

from mesh_ranks import tp_params, tp_rank
from repro_torch.core import bitpack, xnor_layers
from repro_torch.distributed import sharding
from repro_torch.kernels import ops
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import layers, lm
from repro_torch.train import serve_step

torch.set_num_threads(1)

B, S, S_MAX = 8, 12, 16
TOL = dict(rtol=1e-5, atol=1e-5)
BF16_LOGIT_BOUND = 2 ** -6
QWEN = dict(n_heads=6, n_kv_heads=2)
CASES = {
    "qwen2-7b": ("qwen2-7b", QWEN, "float32", False),
    "qwen2-7b+xnor": ("qwen2-7b+xnor", QWEN, "float32", True),
    "qwen2-7b+xnor float weights": ("qwen2-7b+xnor", QWEN, "float32",
                                    False),
    "moonshot-v1-16b-a3b": ("moonshot-v1-16b-a3b", {}, "float32", False),
    "llama4-scout-17b-a16e+xnor": ("llama4-scout-17b-a16e+xnor", {},
                                   "float32", True),
    "recurrentgemma-2b+xnor": ("recurrentgemma-2b+xnor", {}, "float32",
                               True),
    "qwen2-7b+xnor bf16": ("qwen2-7b+xnor", QWEN, "bfloat16", True),
    "moonshot-v1-16b-a3b bf16": ("moonshot-v1-16b-a3b", {}, "bfloat16",
                                 False),
}


def batch_of(vocab: int, seed: int = 3) -> dict:
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (B, S), dtype=np.int32),
            "next": [rng.integers(0, vocab, (B, 1), dtype=np.int32)
                     for _ in range(2)]}


def single(arch, over, dtype, packed, batch, params=None) -> list:
    """The single-process steps' logits, f32 on the host."""
    cfg, tree = tp_params(arch, over, dtype, packed, params)
    with torch.inference_mode():
        logits, state = serve_step.prefill_step(
            cfg, tree, {"tokens": torch.from_numpy(batch["tokens"])}, S_MAX)
        steps = [logits.float().numpy()]
        for tok in batch["next"]:
            logits, state = serve_step.decode_step(
                cfg, tree, torch.from_numpy(tok), state)
            steps.append(logits.float().numpy())
    return steps


def case_dicts(cases: dict, count: str | None = None) -> dict:
    return {name: dict(arch=arch, over=over, dtype=dt, packed=packed,
                       batch=batch_of(256), count=name == count)
            for name, (arch, over, dt, packed) in cases.items()}


def hold(name, got, want, dtype, rows=slice(None)):
    assert len(got) == len(want) == 3
    for step, (g, w) in enumerate(zip(got, want)):
        w = w[rows]
        if dtype == "float32":
            np.testing.assert_allclose(g, w, **TOL,
                                       err_msg=f"{name} step {step}")
        else:
            bound = BF16_LOGIT_BOUND * (np.abs(w) + 1)
            assert np.all(np.abs(g - w) <= bound), (name, step)
        assert np.array_equal(g[:, -1].argmax(-1), w[:, -1].argmax(-1)), \
            (name, step)


@pytest.fixture(scope="module")
def ranks():
    return mesh_mod.run_ranks(tp_rank, 4, (1, 4), ("data", "model"),
                              case_dicts(CASES, count="qwen2-7b+xnor"),
                              S_MAX, True, device="cpu", timeout_s=600)


@pytest.mark.parametrize("name", list(CASES))
def test_tensor_parallel_steps_match_single_process(name, ranks):
    arch, over, dtype, packed = CASES[name]
    want = single(arch, over, dtype, packed, batch_of(256))
    for r in ranks:
        hold(name, r["cases"][name]["logits"], want, dtype)


def test_no_fsdp_axis_no_gather_and_heads_split(ranks):
    """On (1, 4) nothing is split over ``data``: a decode step gathers no
    parameter (no model gather for a covered kind), only activations move
    over ``model``; each rank's cache holds its 2-head KV block."""
    for r in ranks:
        seen = r["cases"]["qwen2-7b+xnor"]["gathers"]
        assert seen["calls"] == [] or all(
            axes == [] and nbytes == 0 for axes, nbytes in seen["calls"])
        assert seen["total"] > 0             # the logits and the sums
        assert r["cases"]["qwen2-7b+xnor"]["kv_heads"] == 2


def test_vocab_parallel_embedding_is_bitwise(ranks):
    for r in ranks:
        assert r["units"]["embed"] and r["units"]["embed_bits"]


def test_top2_decode_combine_is_bitwise_with_a_rank_s_experts(ranks):
    """Each rank computes its one expert of four; the rows meet over
    ``model`` and combine in the single-process order."""
    assert [r["units"]["experts"] for r in ranks] == [
        (0, 1), (1, 1), (2, 1), (3, 1)]
    for r in ranks:
        assert r["units"]["combine"]


@pytest.mark.parametrize("n_heads, n_kv, tp, q_block, kv_most", [
    (40, 8, 16, 3, 2),        # llama4-scout
    (28, 4, 16, 2, 2),        # qwen2-7b
    (16, 16, 16, 1, 1),       # moonshot
    (40, 8, 4, 10, 2),
    (6, 2, 4, 2, 2),          # the smoke case above
    (6, 2, 2, 3, 1),
])
def test_head_aligned_blocks(n_heads, n_kv, tp, q_block, kv_most):
    """Whole query heads a rank (ceil(H / tp), tail ranks padded); a
    rank's KV block holds exactly the KV heads its query heads read."""
    per = n_heads // n_kv
    seen = []
    for i in range(tp):
        qb, q0, q1 = sharding.head_blocks(n_heads, 1, tp, i)
        kvb, kv0, kv1 = sharding.head_blocks(n_heads, per, tp, i)
        assert (qb, kvb) == (q_block, kv_most)
        assert q1 - q0 <= qb and kv1 - kv0 <= kvb
        assert {h // per for h in range(q0, q1)} == set(range(kv0, kv1))
        seen += range(q0, q1)
    assert seen == list(range(n_heads))
    bs, start, stop = sharding.extent(
        n_heads * 8, sharding.Heads("model", n_heads, 8, 1), tp, 0)
    assert (bs, start, stop) == (q_block * 8, 0, q_block * 8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_row_parallel_xnor_dots_are_bitwise_against_whole_k(dtype):
    """``wo`` of 6 heads of 16 over 4 ranks (2, 2, 2, 0 heads; K blocks of
    32 that a 48-element head block would not align to a word) and over
    2 (3 heads, 48 elements: a block ends mid-word): each rank's block of
    the packed planes (``sharding.shard_bits``) against its valid part of
    x, its words padded with 1 bits, dots summed over the ranks equal
    the whole-K ``xnor_matmul`` bitwise, and the |x| sums its sum."""
    g = torch.Generator().manual_seed(2)
    k, n = 6 * 16, 40
    x = torch.randn((5, k), generator=g).to(dtype)
    w = torch.randn((k, n), generator=g).to(dtype)
    packed = xnor_layers.pack_linear(w)
    pa, _ = ops.binarize(x)
    whole = ops.xnor_matmul(pa, packed.pb, k)
    for tp in (4, 2):
        entry = sharding.Heads("model", 6, 16, 1)
        dots, sums = 0, 0
        for i in range(tp):
            bs, start, stop = sharding.extent(k, entry, tp, i)
            pb = sharding.shard_bits(packed.pb, k, bs, start, stop)
            assert pb.shape == (n, bitpack.packed_width(bs))
            d, s = layers.row_partial(
                x[:, start:stop], xnor_layers.PackedLinear(pb, packed.beta, k))
            dots, sums = dots + d, sums + s
        assert torch.equal(dots, whole), tp
        torch.testing.assert_close(sums, x.abs().float().sum(-1))


def test_head_aligned_placements_of_the_serving_steps():
    """``lm.param_pspecs(..., head_aligned=True)`` splits an attn or moe
    layer's head dims into whole heads and packs a row-parallel plane's
    K blocks apart; other kinds keep the reference's placements; the
    decode state's KV heads follow ``wk``."""
    import repro_torch.configs as configs
    cfg = configs.get("qwen2-7b+xnor")
    rules = sharding.DEFAULT_RULES
    heads = sharding.Heads("model", 28, 128, 1)
    spec = lm.packed_param_pspecs(cfg, rules, head_aligned=True)["seg0_attn"]
    assert spec["attn_wq"].pb == (None, heads, "data")
    assert spec["attn_wk"].pb[1] == sharding.Heads("model", 28, 128, 7)
    assert spec["attn_wo"].pb == (None, "data", sharding.Bits(heads, 3584))
    assert spec["ffn_w2"].pb == (None, "data", sharding.Bits("model", 18944))
    assert spec["attn_bq"] == (None, heads)
    assert lm.packed_param_pspecs(cfg, rules)["seg0_attn"]["attn_wo"].pb == \
        (None, "data", "model")
    state = lm.decode_state_pspecs(cfg, "data", head_aligned=True)
    assert state.seg_states[0].k == (None, "data", sharding.Heads(
        "model", 28, 1, 7), None, None)
    rg = configs.get("recurrentgemma-2b")
    rg_spec = lm.param_pspecs(rg, rules, head_aligned=True)
    assert rg_spec == lm.param_pspecs(rg, rules)
    assert "model" in repr(lm.decode_state_pspecs(rg, "data"))
    assert "model" not in repr(lm.decode_state_pspecs(rg, "data",
                                                      head_aligned=True))
