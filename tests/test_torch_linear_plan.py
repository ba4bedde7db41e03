"""The fused XNOR linear's launch plan and its kernel-order plain version,
on the CPU.

``xnor_gemm.linear_plan`` cuts an (M, K) x (N, K) product into the CUDA
kernel's blocks from the shapes alone.  At the qwen2-7b and qwen3-4b
linear shapes, xlstm-350m's and xnor-cnn's (the sLSTM's K 1344 is 42 words)
and at ragged ones, every (row, column, word of K) is owned
by exactly one block (``linear_blocks`` computes each block's work from
its index as the kernel does), each pack task of a pass (a 2 KB range
of a row) belongs to exactly one warp of its cluster, and the plan stays
inside the card's limits: a cluster of at most 8 blocks, 227 KB of shared
memory, the grid's dimensions.  The wrapper refuses shapes outside them.

``xnor_gemm.gemm_plan`` is the packed GEMM's plan (``csrc/xnor_gemm.cu``
computes the same from the same shapes): every (8-row n-tile, 16-column
tile, 16-word step of K) belongs to exactly one warp, a K split leaves
no warp without a step, and the wrapper launches any Kw and any M whose
plan has fewer than 2^31 blocks (the first design refused Kw > 7264 and
M > 524280), refusing the rest before it allocates.

``xnor_gemm.linear_kernel_order`` is what the kernel is held to bitwise on
the card (alpha in f32, summed in the kernel's order).  Here it is held
against the JAX package's ``repro.kernels.ref.xnor_linear_fused`` and
``repro.kernels.ops.xnor_linear_fused`` on its interpret path (the Pallas
kernel body run on the CPU, as the JAX suite runs it): bitwise on dyadic
inputs, whose sums are exact in any order, and within 2e-5 on Gaussian f32;
in bf16 within 2^-8 relative (the reference keeps alpha in bf16).
"""

import contextlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import bitpack, xnor_layers
from repro_torch.kernels import cuda
from repro_torch.kernels import xnor_gemm as kx

QWEN2_7B = {"wq/wo": (3584, 3584), "wk/wv": (512, 3584),
            "w1/w3": (18944, 3584), "w2": (3584, 18944)}      # (N, K)
QWEN3_4B = {"wq": (4096, 2560), "wk/wv": (1024, 2560), "wo": (2560, 4096),
            "w1/w3": (9728, 2560), "w2": (2560, 9728)}
XLSTM_350M = {"mlstm wq/wk/wv": (2048, 2048), "mlstm w_up/w_gate": (2048, 1024),
              "mlstm w_down": (1024, 2048), "slstm w_gates": (4096, 1024),
              "slstm w_up": (2688, 1024), "slstm w_down": (1024, 1344)}
XNOR_CNN = {"w_up": (256, 64), "w_down": (64, 256)}
SHAPES = ([("qwen2-7b " + k, *v) for k, v in QWEN2_7B.items()]
          + [("qwen3-4b " + k, *v) for k, v in QWEN3_4B.items()]
          + [("xlstm-350m " + k, *v) for k, v in XLSTM_350M.items()]
          + [("xnor-cnn " + k, *v) for k, v in XNOR_CNN.items()]
          + [("ragged", 9, 70)])


@pytest.mark.parametrize("m", [1, 4, 5, 8, 32, 33])
@pytest.mark.parametrize("label,n,k", SHAPES)
def test_plan_covers_every_output_and_word_once(label, n, k, m):
    for itemsize in (2, 4):
        plan = kx.linear_plan(m, n, k, itemsize=itemsize)
        kw = bitpack.packed_width(k)
        assert plan.cluster <= kx.MAX_CLUSTER and plan.smem <= kx.MAX_SMEM
        assert plan.grid[0] % plan.cluster == 0
        assert plan.grid[0] < 2 ** 31 and plan.grid[1] <= 65535
        assert plan.rows in (4, 8, 32) and plan.passes * plan.rows >= m
        assert (plan.split - 1) * plan.kq_slice < -(-kw // 4)   # no empty part
        seen = np.zeros((m, n, kw), dtype=np.int32)
        for work in kx.linear_blocks(plan, m, n, k):
            if work.rows and work.cols and work.words:
                seen[work.rows.start:work.rows.stop,
                     work.cols.start:work.cols.stop,
                     work.words.start:work.words.stop] += 1
        assert (seen == 1).all(), label
        tasks = plan.rows * kx.pack_tasks(k, itemsize)
        owners = {}                                 # the kernel's task loop
        assert plan.warps in (4, 8)
        for rank in range(plan.cluster):
            for warp in range(plan.warps):
                for t in range(rank + plan.cluster * warp, tasks,
                               plan.cluster * plan.warps):
                    assert t not in owners
                    owners[t] = (rank, warp)
        assert owners == {t: kx.packer(t, plan) for t in range(tasks)}


def test_plan_takes_the_largest_cluster():
    """Every cluster packs all the rows, so the plan takes as many column
    tiles a cluster as it can and splits K only where a block's tile would
    not fit its shared memory."""
    for n, k in list(QWEN2_7B.values()) + list(QWEN3_4B.values()):
        for m in (4, 32):
            plan = kx.linear_plan(m, n, k)
            assert plan.split == 1 and plan.cluster == min(8, plan.tiles)
    wide = kx.linear_plan(32, 64, 65536)          # 512 KB of planes a tile
    assert wide.split > 1 and wide.smem <= kx.MAX_SMEM
    assert kx.linear_plan(4, 3584, 18944) == kx.linear_plan(4, 3584, 18944)


def test_wrapper_refuses_shapes_outside_the_plan(monkeypatch):
    """A K too wide for a block's shared memory raises before any launch."""
    monkeypatch.setattr(cuda, "use_kernel", lambda *t: True)
    monkeypatch.setattr(cuda, "launch", lambda *a: pytest.fail("launched"))
    k = 200_000
    x = torch.zeros((32, k))
    pb = torch.zeros((64, bitpack.packed_width(k)), dtype=torch.int32)
    with pytest.raises(ValueError, match="shared memory"):
        kx.xnor_linear_fused(x, pb, torch.ones(64), k)


def _gemm_warps(plan, m, n, kw):
    """Yield (n-tiles, 16-column tile, steps) of every warp of every block,
    as ``csrc/xnor_gemm.cu`` computes them from its indices."""
    steps = -(-kw // 16)
    for b in range(plan.blocks):
        cb, rt = b % plan.col_blocks, b // plan.col_blocks
        for warp in range(plan.warps):
            kslice, ctile = warp // plan.ct, warp % plan.ct
            col_tile = cb * plan.ct + ctile
            tiles = range(rt * plan.nt, min(-(-m // 8), (rt + 1) * plan.nt))
            if col_tile * 16 < n:
                yield tiles, col_tile, range(kslice, steps, plan.ks)


GEMM_M = [1, 4, 8, 9, 16, 17, 32, 33, 64, 65, 256]


@pytest.mark.parametrize("m", GEMM_M)
@pytest.mark.parametrize("label,n,k", SHAPES + [("quickstart", 32, 256),
                                                ("xnor-cnn", 512, 512)])
def test_gemm_plan_covers_every_output_and_step_once(label, n, k, m):
    kw = bitpack.packed_width(k)
    plan = kx.gemm_plan(m, n, kw)
    steps = -(-kw // 16)
    assert plan.nt in (1, 2, 4, 8) and plan.ks in (1, 2, 4, 8, 16)
    assert plan.ks < 16 or plan.nt == 1
    assert plan.warps in (4, 8, 16) and plan.row_tiles * 8 * plan.nt >= m
    assert plan.ks <= max(1, steps)            # a step a warp at least
    assert plan.ks == 1 or (-(-n // 16) * plan.row_tiles * plan.ks
                            <= kx.GEMM_TARGET_WARPS * (2 if m <= 8 else 1))
    seen = np.zeros((-(-m // 8), -(-n // 16), steps), dtype=np.int32)
    for tiles, col_tile, ks in _gemm_warps(plan, m, n, kw):
        for t in tiles:
            seen[t, col_tile, list(ks)] += 1
    assert (seen == 1).all(), label


def test_gemm_plan_weights_read_once_up_to_64_rows():
    """One row tile, so one read of the weights, for every M <= 64; at
    decode the long-K, few-column w2 splits K 16 ways, the wide w1/w3 two
    ways; at a prefill chunk w1/w3 does not split."""
    for m in range(1, 65):
        assert kx.gemm_plan(m, 18944, 112).row_tiles == 1
    assert kx.gemm_plan(65, 18944, 112).row_tiles == 2
    assert kx.gemm_plan(4, 3584, 592) == kx.GemmPlan(1, 16, 1, 1, 224)
    assert kx.gemm_plan(4, 18944, 112) == kx.GemmPlan(1, 2, 2, 1, 592)
    assert kx.gemm_plan(32, 18944, 112) == kx.GemmPlan(4, 1, 4, 1, 296)
    assert kx.gemm_plan(32, 3584, 592) == kx.GemmPlan(4, 8, 1, 1, 224)


def _fake_card(monkeypatch, launched):
    monkeypatch.setattr(cuda, "use_kernel", lambda *t: True)
    monkeypatch.setattr(cuda, "launch", lambda *a: launched.append(a))
    monkeypatch.setattr(cuda, "stream", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())


@pytest.mark.parametrize("m,n,kw", [(3, 40, 9375), (20, 33, 7265),
                                    (600_000, 17, 8), (524_281, 1, 1)])
def test_gemm_wrapper_takes_wide_k_and_tall_m(monkeypatch, m, n, kw):
    """Shapes past the first design's limits (Kw > 7264, M > 524280)
    launch (meta tensors: nothing is allocated)."""
    launched = []
    _fake_card(monkeypatch, launched)
    pa = torch.empty((m, kw), dtype=torch.int32, device="meta")
    pb = torch.empty((n, kw), dtype=torch.int32, device="meta")
    before = kx.xnor_gemm.launches
    out = kx.xnor_gemm(pa, pb, 32 * kw)
    assert out.shape == (m, n) and kx.xnor_gemm.launches == before + 1
    (name, *args), = launched
    assert name == "xnor_gemm" and args[3:7] == [m, n, kw, 32 * kw]


def test_gemm_wrapper_refuses_a_grid_past_2_31_blocks(monkeypatch):
    launched = []
    _fake_card(monkeypatch, launched)
    m, n = 2 ** 31 - 1, 2 ** 20
    assert kx.gemm_plan(m, n, 1).blocks >= 2 ** 31
    pa = torch.empty((m, 1), dtype=torch.int32, device="meta")
    pb = torch.empty((n, 1), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="2\\^31 blocks"):
        kx.xnor_gemm(pa, pb, 32)
    assert not launched


def test_gemm_plain_at_wide_k_matches_reference():
    """The plain version (what the card's kernel is held to) at Kw past
    the first design's limit, against the JAX package's ``ref.xnor_gemm``."""
    rng = np.random.default_rng(0)
    kw = 7265
    pa = rng.integers(0, 2 ** 32, size=(3, kw), dtype=np.uint32)
    pb = rng.integers(0, 2 ** 32, size=(5, kw), dtype=np.uint32)
    got = kx.xnor_gemm(bitpack.from_numpy_u32(pa), bitpack.from_numpy_u32(pb),
                       32 * kw)
    want = np.asarray(jref.xnor_gemm(jnp.asarray(pa), jnp.asarray(pb),
                                     32 * kw))
    assert np.array_equal(got.numpy(), want)


def _dyadic(rng, shape):
    return (rng.integers(-64, 64, size=shape) / 8.0).astype(np.float32)


def _packed(w):
    pb, beta = xnor_layers.pack_weights(torch.from_numpy(w))
    jpb = jnp.asarray(bitpack.to_numpy_u32(pb))
    return pb, beta, jpb, jnp.asarray(beta.numpy())


@pytest.mark.parametrize("m,k,n", [(4, 256, 64), (3, 512, 40),
                                   (33, 128, 17), (1, 1024, 8), (5, 70, 9),
                                   (33, 96, 17)])
def test_kernel_order_on_dyadic_inputs(m, k, n):
    """Bitwise where K is a power of two.  Elsewhere XLA's CPU backend
    turns the reference's division by the constant K into a product with
    the rounded 1/K (ROADMAP queue 3), which the kernel's true division
    differs from by up to one ulp of alpha: two ulps of the output."""
    rng = np.random.default_rng(m * 1000 + k + n)
    x, w = _dyadic(rng, (m, k)), _dyadic(rng, (n, k))
    pb, beta, jpb, jbeta = _packed(w)
    got = kx.linear_kernel_order(torch.from_numpy(x), pb, beta, k).numpy()
    want_ref = np.asarray(jref.xnor_linear_fused(jnp.asarray(x), jpb, jbeta,
                                                 k))
    want_int = np.asarray(jops.xnor_linear_fused(jnp.asarray(x), jpb, jbeta,
                                                 k, impl="interpret"))
    for want in (want_int, want_ref):
        if k & (k - 1) == 0:
            assert np.array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=2 ** -22, atol=0)


@pytest.mark.parametrize("m,k,n", [(4, 3584, 48), (5, 70, 9), (32, 512, 33),
                                   (4, 8192, 16)])
def test_kernel_order_close_on_gaussian_inputs(m, k, n):
    rng = np.random.default_rng(k + n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((n, k)).astype(np.float32)
    pb, beta, jpb, jbeta = _packed(w)
    got = kx.linear_kernel_order(torch.from_numpy(x), pb, beta, k).numpy()
    for want in (jref.xnor_linear_fused(jnp.asarray(x), jpb, jbeta, k),
                 jops.xnor_linear_fused(jnp.asarray(x), jpb, jbeta, k,
                                        impl="interpret")):
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5,
                                   atol=2e-5)
    # bf16 activations: the reference keeps alpha in bf16 (half an ulp,
    # 2^-9 relative), the kernel in f32
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = kx.linear_kernel_order(xb, pb, beta, k).numpy()
    want = jref.xnor_linear_fused(jnp.asarray(xb.float().numpy(),
                                              dtype=jnp.bfloat16),
                                  jpb, jbeta, k)
    np.testing.assert_allclose(got, np.asarray(want, dtype=np.float32),
                               rtol=2 ** -8, atol=1e-6)


def _kernel_alpha_model(x: np.ndarray) -> np.ndarray:
    """The kernel's alpha in f32 scalar steps: lane l takes element
    32w + l of each word w (0 past K); per 2 KB range each lane's running
    sum from 0, an xor butterfly over the 32 lanes; the ranges' sums in
    order; / K."""
    m, k = x.shape
    a = np.abs(x.astype(np.float32))
    kw = -(-k // 32)
    step = kx.RANGE_BYTES // (32 * x.itemsize)
    out = np.empty(m, dtype=np.float32)
    for i in range(m):
        total = None
        for w0 in range(0, kw, step):
            acc = [np.float32(0)] * 32
            for w in range(w0, min(kw, w0 + step)):
                for l in range(32):
                    v = a[i, w * 32 + l] if w * 32 + l < k else np.float32(0)
                    acc[l] = np.float32(acc[l] + v)
            for o in (16, 8, 4, 2, 1):
                acc = [np.float32(acc[l] + acc[l ^ o]) for l in range(32)]
            total = acc[0] if total is None else np.float32(total + acc[0])
        out[i] = np.float32(total / np.float32(k))
    return out


@pytest.mark.parametrize("k", [5120, 2048, 200])
def test_alpha_kernel_order_is_the_kernels_order(k):
    """The mirror against a scalar model of the kernel's summation (K =
    5120 in f32: 160 words, ten ranges of 16) on an aligned row and
    on an offset view: the order does not depend on where the row lies."""
    rng = np.random.default_rng(k)
    x = rng.standard_normal((2, k + 1)).astype(np.float32)
    t = torch.from_numpy(x)
    for view in (t[:, :k].contiguous(), t.reshape(-1)[1:1 + 2 * k]
                 .reshape(2, k)):
        got = kx.alpha_kernel_order(view).numpy()
        assert np.array_equal(got, _kernel_alpha_model(view.numpy()))
        exact = np.abs(view.numpy().astype(np.float64)).mean(1)
        np.testing.assert_allclose(got, exact, rtol=1e-6, atol=0)
