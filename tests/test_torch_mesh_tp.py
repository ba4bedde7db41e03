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
(top-2 over 4 experts, one a rank), llama4-scout ``+xnor`` (top-1),
recurrentgemma-2b (``rglru`` on its channel block; ``local`` on its
heads: at 6 query heads and its one KV head, ranks 0-2 hold 2 query
heads and the KV head, rank 3 none), xlstm-350m (the mLSTM on its block
of ``di`` and of the memory's rows, at 2 heads too, which do not divide
the 4 ranks; the sLSTM's gates gathered and its cell whole, its GLU on
the rank's channels) and
xnor-cnn (``bindense`` on its ``d_ff`` block).  A prefill of 12 tokens, then two decode steps of teacher-forced tokens;
every rank's logits rows (all of them: the batch is whole on each rank
of this mesh) are held against the single-process steps in f32 at
``rtol = atol = 1e-5`` (a sum split over four ranks reorders the f32
partials) with equal greedy tokens, and in bf16 within
``BF16_LOGIT_BOUND`` (2^-6 of |logit| + 2^-6, the port's bf16 logit
bound against the reference; the CPU runs read 0 here: the f32 partials,
summed and rounded once, round as the single matmul does at these
widths) with equal greedy tokens.  xlstm-350m at 2 heads in f32 is held
bit for bit against the single-process steps with each row-parallel
f32 sum in the ranks' order (:func:`single_rank_order`).
"""

import numpy as np
import pytest
import torch

from mesh_ranks import tp_params, tp_rank
from repro_torch.core import bitpack, xnor_layers
from repro_torch.distributed import sharding
from repro_torch.kernels import ops
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import blocks, layers, lm
from repro_torch.train import serve_step

torch.set_num_threads(1)

B, S, S_MAX = 8, 12, 16
TOL = dict(rtol=1e-5, atol=1e-5)
BF16_LOGIT_BOUND = 2 ** -6
QWEN = dict(n_heads=6, n_kv_heads=2)
RG = dict(n_heads=6, n_kv_heads=1)      # 2, 2, 2 and 0 query heads a rank
XL = dict(n_heads=2, n_kv_heads=2)      # heads that do not divide model
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
    "recurrentgemma-2b 6 heads": ("recurrentgemma-2b", RG, "float32", False),
    "xlstm-350m": ("xlstm-350m", {}, "float32", False),
    "xlstm-350m+xnor": ("xlstm-350m+xnor", {}, "float32", True),
    "xlstm-350m+xnor 2 heads": ("xlstm-350m+xnor", XL, "float32", True),
    "xnor-cnn": ("xnor-cnn", {}, "float32", True),
    "qwen2-7b+xnor bf16": ("qwen2-7b+xnor", QWEN, "bfloat16", True),
    "moonshot-v1-16b-a3b bf16": ("moonshot-v1-16b-a3b", {}, "bfloat16",
                                 False),
    "recurrentgemma-2b+xnor 6 heads bf16": ("recurrentgemma-2b+xnor", RG,
                                            "bfloat16", True),
    "xlstm-350m+xnor 2 heads bf16": ("xlstm-350m+xnor", XL, "bfloat16",
                                     True),
    "xnor-cnn bf16": ("xnor-cnn", {}, "bfloat16", True),
}
# held bit for bit against the single-process steps with the ranks' order
# of each row-parallel f32 sum (:func:`single_rank_order`)
EXACT = {"xlstm-350m 2 heads": ("xlstm-350m", XL, "float32", False)}
# the recurrent and CNN kinds' cases whose second decode step is counted
TP_KINDS = ("recurrentgemma-2b+xnor 6 heads bf16",
            "xlstm-350m+xnor 2 heads bf16", "xnor-cnn")


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


def single_rank_order(arch, over, dtype, packed, batch, k: int = 4) -> list:
    """:func:`single` with each row-parallel float product (``blocks.
    _row_out``: the mLSTM's and sLSTM's ``w_down``) summed as ``k`` ranks
    sum it: each rank's K block's f32 partial, added in rank order, then
    rounded once (``layers.row_linear``, ``ctx.reduce_sum``)."""
    plain = blocks._row_out

    def row_out(cfg, w, y, n):
        assert isinstance(w, torch.Tensor) and cfg.quant == "none"
        out = None
        for r in range(k):
            _, lo, hi = sharding.extent(n, None, k, r)
            part = layers.matmul(y[..., lo:hi], w[lo:hi], f32=True)
            out = part if out is None else out + part
        return out.to(y.dtype)
    blocks._row_out = row_out
    try:
        return single(arch, over, dtype, packed, batch)
    finally:
        blocks._row_out = plain


def case_dicts(cases: dict, count=()) -> dict:
    """The ranks' cases; those named in ``count`` (a name or names)
    count what their second decode step gathers."""
    count = (count,) if isinstance(count, str) else tuple(count)
    return {name: dict(arch=arch, over=over, dtype=dt, packed=packed,
                       batch=batch_of(256), count=name in count)
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
                              case_dicts(CASES | EXACT,
                                         ("qwen2-7b+xnor",) + TP_KINDS),
                              S_MAX, True, device="cpu", timeout_s=600)


@pytest.mark.parametrize("name", list(CASES))
def test_tensor_parallel_steps_match_single_process(name, ranks):
    arch, over, dtype, packed = CASES[name]
    want = single(arch, over, dtype, packed, batch_of(256))
    for r in ranks:
        hold(name, r["cases"][name]["logits"], want, dtype)


@pytest.mark.parametrize("name", list(EXACT))
def test_f32_steps_are_the_single_process_steps_with_the_ranks_sums(name,
                                                                     ranks):
    """xlstm-350m at 2 heads in f32 (the mLSTM's memory rows split, its
    heads whole on no rank): every rank's logits equal bit for bit the
    single-process steps' in which each row-parallel product alone is
    summed as the ranks sum it.  So what parts them from the plain
    single-process steps (4.5e-5 of logits up to 4.2 at 4 ranks, 3.8e-5
    at 2: past ``TOL``; ``python tests/test_torch_mesh_tp.py``) is the
    order of those f32 sums and nothing else; the greedy tokens agree."""
    arch, over, dtype, packed = EXACT[name]
    want = single_rank_order(arch, over, dtype, packed, batch_of(256))
    plain = single(arch, over, dtype, packed, batch_of(256))
    for r in ranks:
        got = r["cases"][name]["logits"]
        for step, (g, w, p) in enumerate(zip(got, want, plain)):
            assert np.array_equal(g, w), (name, step)
            assert np.array_equal(g[:, -1].argmax(-1), p[:, -1].argmax(-1))


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


@pytest.mark.parametrize("name", TP_KINDS)
def test_recurrent_and_cnn_kinds_gather_no_parameter_over_model(name,
                                                                ranks):
    """A decode step of ``local`` + ``rglru``, ``mlstm`` + ``slstm`` and
    ``bindense`` layers on (1, 4) gathers no parameter (each computes on
    its blocks over ``model``); only activations move."""
    for r in ranks:
        seen = r["cases"][name]["gathers"]
        assert all(axes == [] and nbytes == 0
                   for axes, nbytes in seen["calls"])
        assert seen["total"] > 0


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


def test_glu_up_is_placed_by_pieces():
    """The sLSTM's GLU ``w_up`` (``a | g``) is a ``sharding.Parts`` dim
    under the head-aligned placements (float and packed), the reference's
    ceil-div block otherwise; a rank's block of each piece is the
    ceil-div block ``w_down``'s rows take, so it holds ``a`` and ``g`` of
    the channels whose ``a * gelu(g)`` it projects down."""
    import repro_torch.configs as configs
    cfg = configs.get("xlstm-350m+xnor")
    rules = sharding.DEFAULT_RULES
    dff = blocks.SlstmBlock._dff(cfg)
    parts = sharding.Parts("model", 2)
    assert lm.param_pspecs(cfg, rules, head_aligned=True)["seg1_slstm"][
        "w_up"] == (None, "data", parts)
    packed = lm.packed_param_pspecs(cfg, rules, head_aligned=True)[
        "seg1_slstm"]["w_up"]
    assert packed.pb == (None, parts, "data") and packed.beta == (None, parts)
    assert lm.param_pspecs(cfg, rules)["seg1_slstm"]["w_up"] == (
        None, "data", "model")
    for tp in (4, 16, 3):
        for i in range(tp):
            assert sharding.extent(dff, parts, tp, i) == \
                sharding.extent(dff // 2, "model", tp, i)


class _Mesh:
    """Rank ``rank`` of a (data 1, model ``k``) mesh, as ``sharding``'s
    placement functions read one."""
    mesh_dim_names = ("data", "model")

    def __init__(self, k: int, rank: int):
        self.k, self.rank = k, rank

    def size(self, i: int) -> int:
        return (1, self.k)[i]

    def get_local_rank(self, axis: str) -> int:
        return self.rank if axis == "model" else 0


@pytest.mark.parametrize("rank", range(4))
def test_parts_blocks_shard_and_unpad(rank):
    """Two pieces of 10 over 4 ranks (blocks of 3: 3, 3, 3, 1 valid): a
    rank's block is its block of each piece, zero-padded; ``unpad`` is a
    view of the valid part of each piece."""
    mesh = _Mesh(4, rank)
    spec = (None, sharding.Parts("model", 2))
    t = torch.arange(1, 41, dtype=torch.float32).reshape(2, 20)
    block = sharding.shard(t, spec, mesh)
    assert block.shape == sharding.block_shape(t.shape, spec, mesh) == (2, 6)
    lo, hi = min(3 * rank, 10), min(3 * rank + 3, 10)
    for piece in range(2):
        got = block[:, 3 * piece:3 * piece + 3]
        assert torch.equal(got[:, :hi - lo], t[:, 10 * piece + lo:
                                                10 * piece + hi])
        assert not got[:, hi - lo:].any()
    valid = sharding.unpad(block, t.shape, spec, mesh)
    assert valid.shape == (2, 2, hi - lo)
    valid.zero_()
    assert not block.any()


def test_head_aligned_placements_of_the_serving_steps():
    """``lm.param_pspecs(..., head_aligned=True)`` splits a layer's head
    dims into whole heads (attn, moe, local) and packs a row-parallel
    plane's K blocks apart; other kinds keep the reference's placements;
    the decode state's KV heads follow ``wk``, the recurrent kinds' state
    keeps ``model`` where they compute on blocks of it, and a kind with
    no tensor-parallel form (llama-vision's ``cross``) is whole."""
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
    plain = lm.param_pspecs(rg, rules)
    assert rg_spec["seg0_rglru"] == plain["seg0_rglru"]
    assert rg_spec["seg1_local"]["attn_wk"][2] == sharding.Heads(
        "model", 10, 256, 10)
    rg_state = lm.decode_state_pspecs(rg, "data", head_aligned=True)
    assert rg_state.seg_states[0][0].h == (None, "data", "model")
    vlm = configs.get("llama-3.2-vision-11b")
    vlm_spec = lm.param_pspecs(vlm, rules, head_aligned=True)
    cross = [k for k in vlm_spec if k.endswith("_cross")]
    assert cross and all(vlm_spec[k] == lm.param_pspecs(vlm, rules)[k]
                         for k in cross)
    vlm_state = lm.decode_state_pspecs(vlm, "data", head_aligned=True)
    kinds = [kind for kind, _ in vlm.segments()]
    assert "model" in repr(lm.decode_state_pspecs(vlm, "data").seg_states[
        kinds.index("cross")])
    assert "model" not in repr(vlm_state.seg_states[kinds.index("cross")])


def _readings() -> None:
    """The f32 2-head xlstm case at 2 and 4 ranks: the largest |logit|
    difference a step from the plain single-process steps and from
    :func:`single_rank_order`'s."""
    for tp in (2, 4):
        out = mesh_mod.run_ranks(tp_rank, tp, (1, tp), ("data", "model"),
                                 case_dicts(EXACT), S_MAX, False,
                                 device="cpu", timeout_s=600)
        for name, case in EXACT.items():
            got = out[0]["cases"][name]["logits"]
            plain = single(*case, batch_of(256))
            ordered = single_rank_order(*case, batch_of(256), k=tp)
            print(f"{name} over {tp} ranks: |sharded - single| a step "
                  f"{[float(np.abs(g - w).max()) for g, w in zip(got, plain)]}"
                  f", |sharded - single in the ranks' order| "
                  f"{[float(np.abs(g - w).max()) for g, w in zip(got, ordered)]}"
                  f", largest |logit| {max(float(np.abs(w).max()) for w in plain)}")


if __name__ == "__main__":
    _readings()
