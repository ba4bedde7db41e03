"""The fused XNOR linear's launch plan and its kernel-order plain version,
on the CPU.

``xnor_gemm.linear_plan`` cuts an (M, K) x (N, K) product into the CUDA
kernel's blocks from the shapes alone.  At the qwen2-7b and qwen3-4b
linear shapes and at ragged ones, every (row, column, word of K) is owned
by exactly one block (``linear_blocks`` computes each block's work from
its index as the kernel does), each pack task of a pass (a 2 KB range
of a row) belongs to exactly one warp of its cluster, and the plan stays
inside the card's limits: a cluster of at most 8 blocks, 227 KB of shared
memory, the grid's dimensions.  The wrapper refuses shapes outside them.

``xnor_gemm.linear_kernel_order`` is what the kernel is held to bitwise on
the card (alpha in f32, summed in the kernel's order).  Here it is held
against the JAX package's ``repro.kernels.ref.xnor_linear_fused`` and
``repro.kernels.ops.xnor_linear_fused`` on its interpret path (the Pallas
kernel body run on the CPU, as the JAX suite runs it): bitwise on dyadic
inputs, whose sums are exact in any order, and within 2e-5 on Gaussian f32;
in bf16 within 2^-8 relative (the reference keeps alpha in bf16).
"""

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
SHAPES = ([("qwen2-7b " + k, *v) for k, v in QWEN2_7B.items()]
          + [("qwen3-4b " + k, *v) for k, v in QWEN3_4B.items()]
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
