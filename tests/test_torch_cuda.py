"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``cuda`` and skipped where ``torch.cuda.is_available()`` is
false (a CUDA kernel has no CPU mode); this file imports neither JAX nor
the reference package, so it runs on a machine with only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: bitwise for sign planes and for ±1 activations (alpha = 1
exactly), and the fused linear bitwise against its plain version summed in
the kernel's order; 2e-5 for f32; for bf16 activations 2^-8 relative,
because the kernels keep alpha in f32 while the plain versions round it
through bf16 (half an ulp, 2^-9 relative); attention (paged decode and
flash) at the reference suite's f32 2e-5, and in bf16 within one bf16 ulp
(rtol 2^-7, atol 1e-5): the kernels and the plain versions compute in f32
and round once to bf16, and a looser limit would be as large as |o| itself
at long context. The integer kernels (``xnor_gemm``, ``bulk_xor``,
``parity_digest``, ``xor_cipher``) are held bitwise.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import xnor_layers
from repro_torch.kernels import bulk as kbulk
from repro_torch.kernels import cipher as kcipher
from repro_torch.kernels import cuda
from repro_torch.kernels import flash_attn as kflash
from repro_torch.kernels import pack as kpack
from repro_torch.kernels import paged_attn as kpaged
from repro_torch.kernels import parity as kparity
from repro_torch.kernels import xnor_gemm as kxnor

LENGTHS = [1, 127, 128, 129, 128 * 512 + 3]
BF16_ULP = (2 ** -7, 1e-5)        # (rtol, atol): one bf16 ulp of the value


def _case(*, b, kv, g, dh, bs, w, i8, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, kv, g, dh)).astype(np.float32)
    ck = rng.standard_normal((1 + b * w, kv, bs, dh))
    cv = rng.standard_normal((1 + b * w, kv, bs, dh))
    scale, out_scale = dh ** -0.5, 1.0
    if i8:
        ck = np.clip(np.round(ck * 32.0), -127, 127).astype(np.int8)
        cv = np.clip(np.round(cv * 32.0), -127, 127).astype(np.int8)
        scale, out_scale = scale / 32.0, 1.0 / 32.0
    else:
        ck, cv = ck.astype(np.float32), cv.astype(np.float32)
    table = (rng.permutation(b * w).reshape(b, w) + 1).astype(np.int32)
    return q, ck, cv, table, float(scale), float(out_scale)


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _kernel_and_plain(fn, *args, **kw):
    k = fn(*args, **kw)
    with cuda.plain_reference():
        p = fn(*args, **kw)
    torch.cuda.synchronize()
    return k, p


@pytest.mark.cuda
@pytest.mark.parametrize("k", [3584, 45])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_pack(gpu, k, dtype):
    x = torch.randn((64, k), device=gpu).to(dtype)
    x[0, :3] = torch.tensor([-0.0, 0.0, float("nan")])
    (kp, ka), (pp, pa) = _kernel_and_plain(kpack.pack, x)
    assert torch.equal(kp, pp)
    # the kernel keeps alpha in f32, the plain version rounds through
    # x.dtype: bf16 allows its half-ulp (2^-9 relative)
    tol = 1e-6 if dtype == torch.float32 else 2 ** -8
    torch.testing.assert_close(ka, pa, rtol=tol, atol=0, equal_nan=True)


QWEN2_7B_LINEARS = [(3584, 3584), (512, 3584), (18944, 3584),
                    (3584, 18944)]                       # (N, K)
# the decode shapes of the other ported archs (N, K)
NEW_LINEARS = [(2560, 2560), (256, 2560), (7680, 2560), (2560, 7680),  # rg-2b
               (3072, 3072), (1024, 3072), (8192, 3072), (3072, 8192),  # phi4
               (5120, 5120), (1024, 5120), (17408, 5120),
               (5120, 17408)]                                   # qwen3-14b


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(m, k, n) for n, k in QWEN2_7B_LINEARS
                                   for m in (1, 4, 5, 8, 32, 33)]
                         + [(5, 70, 9)])
def test_cuda_xnor_linear_fused(gpu, m, k, n):
    """Bitwise against the plain version summed in the kernel's order
    (``xnor_gemm.linear_kernel_order``) in f32 and bf16, bitwise on ±1
    activations, and within the reference's tolerances of the plain
    version; at each qwen2-7b linear shape and a ragged one."""
    g = torch.Generator(device=gpu)
    g.manual_seed(m * 100003 + k + n)
    w = torch.randn((n, k), generator=g, device=gpu)
    pb, beta = xnor_layers.pack_weights(w)
    pm1 = torch.where(torch.randn((m, k), generator=g, device=gpu) >= 0,
                      1.0, -1.0)
    kk, pp = _kernel_and_plain(kxnor.xnor_linear_fused, pm1, pb, beta, k)
    assert torch.equal(kk, pp)              # alpha = 1 exactly: exact dots
    x = torch.randn((m, k), generator=g, device=gpu)
    kk, pp = _kernel_and_plain(kxnor.xnor_linear_fused, x, pb, beta, k)
    assert torch.equal(kk, kxnor.linear_kernel_order(x, pb, beta, k))
    torch.testing.assert_close(kk, pp, rtol=2e-5, atol=2e-5)
    # bf16: the kernel's alpha is f32, the plain one is rounded to bf16 —
    # a relative difference of at most 2^-9 in every output
    xb = x.to(torch.bfloat16)
    kk, pp = _kernel_and_plain(kxnor.xnor_linear_fused, xb, pb, beta, k)
    assert torch.equal(kk, kxnor.linear_kernel_order(xb, pb, beta, k))
    torch.testing.assert_close(kk, pp, rtol=2 ** -8, atol=1e-6)
    # rows one element off 16-byte alignment read x without TMA
    off = torch.cat([xb.new_zeros(1), xb.reshape(-1)])[1:].reshape(m, k)
    assert torch.equal(kxnor.xnor_linear_fused(off, pb, beta, k),
                       kxnor.linear_kernel_order(off, pb, beta, k))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(m, k, n) for n, k in NEW_LINEARS
                                   for m in (4, 32)])
def test_cuda_xnor_linear_fused_other_archs(gpu, m, k, n):
    """recurrentgemma-2b's, phi4-mini's and qwen3-14b's linear shapes at
    M 4 (decode) and 32 (a prefill chunk): bitwise against the plain
    version summed in the kernel's order, f32 and bf16."""
    g = torch.Generator(device=gpu)
    g.manual_seed(m * 7 + k + n)
    pb, beta = xnor_layers.pack_weights(
        torch.randn((n, k), generator=g, device=gpu))
    for dtype, tol in ((torch.float32, (2e-5, 2e-5)),
                       (torch.bfloat16, (2 ** -8, 1e-6))):
        x = torch.randn((m, k), generator=g, device=gpu).to(dtype)
        kk, pp = _kernel_and_plain(kxnor.xnor_linear_fused, x, pb, beta, k)
        assert torch.equal(kk, kxnor.linear_kernel_order(x, pb, beta, k))
        torch.testing.assert_close(kk, pp, rtol=tol[0], atol=tol[1])


# the attention projections of the mixture-of-experts archs (N, K):
# moonshot-v1-16b-a3b's four (2048 -> 2048), llama4-scout's q/o and k/v
MOE_LINEARS = [(2048, 2048), (5120, 5120), (1024, 5120)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(m, k, n) for n, k in MOE_LINEARS
                                   for m in (4, 32)])
def test_cuda_xnor_linear_fused_moe_archs(gpu, m, k, n):
    """Bitwise against the plain version summed in the kernel's order and
    within the reference's tolerances of the plain one, f32 and bf16."""
    g = torch.Generator(device=gpu)
    g.manual_seed(m * 11 + k + n)
    pb, beta = xnor_layers.pack_weights(
        torch.randn((n, k), generator=g, device=gpu))
    for dtype, tol in ((torch.float32, (2e-5, 2e-5)),
                       (torch.bfloat16, (2 ** -8, 1e-6))):
        x = torch.randn((m, k), generator=g, device=gpu).to(dtype)
        kk, pp = _kernel_and_plain(kxnor.xnor_linear_fused, x, pb, beta, k)
        assert torch.equal(kk, kxnor.linear_kernel_order(x, pb, beta, k))
        torch.testing.assert_close(kk, pp, rtol=tol[0], atol=tol[1])


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,dtype", [(32, 60000, 64, torch.bfloat16),
                                         (4, 150000, 40, torch.bfloat16),
                                         (33, 40000, 70, torch.float32),
                                         (8, 120000, 33, torch.float32)])
def test_cuda_xnor_linear_fused_split_k(gpu, m, k, n, dtype):
    """K too wide for one block's shared memory: the plan splits it across
    the blocks of a cluster, whose integer partials meet in the tile's
    first block; still bitwise against the kernel-order plain version."""
    assert kxnor.linear_plan(m, n, k, dtype.itemsize).split > 1
    g = torch.Generator(device=gpu)
    g.manual_seed(k + n)
    pb, beta = xnor_layers.pack_weights(
        torch.randn((n, k), generator=g, device=gpu))
    x = torch.randn((m, k), generator=g, device=gpu).to(dtype)
    kk, pp = _kernel_and_plain(kxnor.xnor_linear_fused, x, pb, beta, k)
    assert torch.equal(kk, kxnor.linear_kernel_order(x, pb, beta, k))
    tol = (2e-5, 2e-5) if dtype == torch.float32 else (2 ** -8, 1e-6)
    torch.testing.assert_close(kk, pp, rtol=tol[0], atol=tol[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,i8,tol", [("f32", False, (2e-5, 2e-5)),
                                          ("bf16", False, BF16_ULP),
                                          ("bf16", True, BF16_ULP),
                                          ("f32", True, (2e-5, 2e-5))])
@pytest.mark.parametrize("window,pos", [(0, [0, 17, 127, 64]),
                                        (40, [45, 80, 300, 127])])
def test_cuda_paged_decode(gpu, dtype, i8, tol, window, pos):
    q, ck, cv, table, scale, out_scale = _case(
        b=4, kv=4, g=7, dh=128, bs=16, w=8, i8=i8, seed=1)
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    tq = torch.from_numpy(q).to(gpu, tdt)
    conv = (lambda a: torch.from_numpy(a).to(gpu)) if i8 else \
        (lambda a: torch.from_numpy(a).to(gpu, tdt))
    args = (tq, conv(ck), conv(cv), torch.from_numpy(table).to(gpu),
            torch.tensor(pos, dtype=torch.int32, device=gpu))
    kk, pp = _kernel_and_plain(kpaged.paged_decode_attention, *args,
                               window=window, scale=scale,
                               out_scale=out_scale)
    torch.testing.assert_close(kk.float(), pp.float(), rtol=tol[0],
                               atol=tol[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("f32", (2e-5, 2e-5)),
                                       ("bf16", BF16_ULP)])
@pytest.mark.parametrize("window,pos", [(0, [1000, 17, 511, 64]),
                                        (40, [45, 80, 3000, 127])])
def test_cuda_paged_decode_merge(gpu, dtype, tol, window, pos):
    """The kernel's split walk and last-block merge against the same split
    in plain PyTorch merged by ``online_softmax.merge``."""
    q, ck, cv, table, scale, out_scale = _case(
        b=4, kv=4, g=7, dh=128, bs=16, w=64, i8=False, seed=2)
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    args = (torch.from_numpy(q).to(gpu, tdt), torch.from_numpy(ck).to(gpu, tdt),
            torch.from_numpy(cv).to(gpu, tdt),
            torch.from_numpy(table).to(gpu),
            torch.tensor(pos, dtype=torch.int32, device=gpu))
    sms = torch.cuda.get_device_properties(gpu).multi_processor_count
    n_split, _ = kpaged.split_plan(64, 4, sms)
    assert n_split > 1
    got = kpaged.paged_decode_attention(*args, window=window, scale=scale,
                                        out_scale=out_scale)
    want = kpaged.split_reference(*args, window=window, scale=scale,
                                  out_scale=out_scale, sms=sms)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=tol[0],
                               atol=tol[1])
    assert int(kpaged._tickets[gpu.index or 0][:16].abs().sum()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w", [8, 32, 2048])
def test_cuda_paged_decode_rows_do_not_depend_on_the_batch(gpu, w, dtype):
    """Slots 0-1 of a 4-slot launch equal a 2-slot launch's bitwise: the
    split plan reads no batch size, so a session migrated between engines
    of other ``slots`` keeps its bits."""
    b, kv, g, dh, bs = 4, 4, 7, 128, 16
    gen = torch.Generator(device=gpu)
    gen.manual_seed(w)
    q = torch.randn((b, kv, g, dh), generator=gen, device=gpu).to(dtype)
    ck, cv = (torch.randn((1 + b * w, kv, bs, dh), generator=gen,
                          device=gpu).to(dtype) for _ in range(2))
    table = (torch.randperm(b * w, generator=gen, device=gpu).reshape(b, w)
             + 1).to(torch.int32)
    pos = torch.tensor([w * bs - 1, 17, w * bs // 2, 3], dtype=torch.int32,
                       device=gpu)
    four = kpaged.paged_decode_attention(q, ck, cv, table, pos,
                                         scale=dh ** -0.5)
    two = kpaged.paged_decode_attention(q[:2].contiguous(), ck, cv,
                                        table[:2].contiguous(),
                                        pos[:2].contiguous(),
                                        scale=dh ** -0.5)
    torch.cuda.synchronize()
    assert torch.equal(four[:2], two)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,i8,tol", [("f32", False, (2e-5, 2e-5)),
                                          ("bf16", False, BF16_ULP),
                                          ("bf16", True, BF16_ULP)])
@pytest.mark.parametrize("w,pos", [(8, [0, 17, 127, 64]),
                                   (2048, [32767, 17, 20000, 4095])])
def test_cuda_paged_decode_g1(gpu, dtype, i8, tol, w, pos):
    """moonshot-v1-16b-a3b's geometry: KV 16, G 1 (one query row a KV
    head), dh 128, block 16, 4 slots, at W 8 and at W 2048 (a split
    walk), against the plain version; rows 0-1 of the launch bitwise a
    2-slot launch's."""
    q, ck, cv, table, scale, out_scale = _case(
        b=4, kv=16, g=1, dh=128, bs=16, w=w, i8=i8, seed=w)
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    conv = (lambda a: torch.from_numpy(a).to(gpu)) if i8 else \
        (lambda a: torch.from_numpy(a).to(gpu, tdt))
    args = (torch.from_numpy(q).to(gpu, tdt), conv(ck), conv(cv),
            torch.from_numpy(table).to(gpu),
            torch.tensor(pos, dtype=torch.int32, device=gpu))
    kk, pp = _kernel_and_plain(kpaged.paged_decode_attention, *args,
                               scale=scale, out_scale=out_scale)
    torch.testing.assert_close(kk.float(), pp.float(), rtol=tol[0],
                               atol=tol[1])
    # F2's invariant here too: rows 0-1 alone are the 4-slot launch's bits
    tq, tk, tv, tt, tp = args
    two = kpaged.paged_decode_attention(
        tq[:2].contiguous(), tk, tv, tt[:2].contiguous(), tp[:2].contiguous(),
        scale=scale, out_scale=out_scale)
    torch.cuda.synchronize()
    assert torch.equal(two, kk[:2])


DH256 = [("f32", False, (2e-5, 2e-5)), ("bf16", False, BF16_ULP),
         ("bf16", True, BF16_ULP)]


@pytest.mark.cuda
@pytest.mark.parametrize("g,dtype,i8,tol",
                         [(g, *c) for g in range(9, 17) for c in DH256]
                         + [(g, *DH256[0]) for g in (1, 8)])
def test_cuda_paged_decode_dh256(gpu, g, dtype, i8, tol):
    """dh 256 at G 9-16 (RecurrentGemma's MQA is G 10), and G 1 and 8 in
    f32: the instances that score two row groups from one staged page.
    Monotone at W 8 and a wrapping 2048-key window ring over the 130
    columns RecurrentGemma's local layers serve (W 130 > 2048 / 16, so
    every slot's walk splits)."""
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    for w, window, pos in ((8, 0, [0, 17, 127, 64]),
                           (130, 2048, [2099, 2048, 5000, 1000])):
        q, ck, cv, table, scale, out_scale = _case(
            b=4, kv=1, g=g, dh=256, bs=16, w=w, i8=i8, seed=g)
        conv = (lambda a: torch.from_numpy(a).to(gpu)) if i8 else \
            (lambda a: torch.from_numpy(a).to(gpu, tdt))
        args = (torch.from_numpy(q).to(gpu, tdt), conv(ck), conv(cv),
                torch.from_numpy(table).to(gpu),
                torch.tensor(pos, dtype=torch.int32, device=gpu))
        kk, pp = _kernel_and_plain(kpaged.paged_decode_attention, *args,
                                   window=window, scale=scale,
                                   out_scale=out_scale)
        torch.testing.assert_close(kk.float(), pp.float(), rtol=tol[0],
                                   atol=tol[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w,window", [(8, 0), (130, 2048)])
def test_cuda_paged_decode_rows_do_not_depend_on_the_batch_g10(gpu, w,
                                                              window, dtype):
    """F2's invariant at RecurrentGemma's instance (KV 1, G 10, dh 256):
    slots 0-1 of a 4-slot launch equal a 2-slot launch's bitwise."""
    b, kv, g, dh, bs = 4, 1, 10, 256, 16
    gen = torch.Generator(device=gpu)
    gen.manual_seed(w + 10)
    q = torch.randn((b, kv, g, dh), generator=gen, device=gpu).to(dtype)
    ck, cv = (torch.randn((1 + b * w, kv, bs, dh), generator=gen,
                          device=gpu).to(dtype) for _ in range(2))
    table = (torch.randperm(b * w, generator=gen, device=gpu).reshape(b, w)
             + 1).to(torch.int32)
    pos = torch.tensor([w * bs - 1, 17, 4000, 3], dtype=torch.int32,
                       device=gpu)
    four = kpaged.paged_decode_attention(q, ck, cv, table, pos,
                                         window=window, scale=dh ** -0.5)
    two = kpaged.paged_decode_attention(q[:2].contiguous(), ck, cv,
                                        table[:2].contiguous(),
                                        pos[:2].contiguous(), window=window,
                                        scale=dh ** -0.5)
    torch.cuda.synchronize()
    assert torch.equal(four[:2], two)


@pytest.mark.cuda
def test_cuda_paged_decode_long_ring_with_dead_splits(gpu):
    """W = 2048 with a 40-key window ring: most splits of every slot see no
    live key and must weigh nothing in the merge."""
    b, kv, g, dh, bs, w, window = 4, 4, 7, 128, 16, 2048, 40
    gen = torch.Generator(device=gpu)
    gen.manual_seed(3)
    q = torch.randn((b, kv, g, dh), generator=gen, device=gpu).bfloat16()
    ck, cv = (torch.randn((1 + b * w, kv, bs, dh), generator=gen,
                          device=gpu).bfloat16() for _ in range(2))
    table = (torch.randperm(b * w, generator=gen, device=gpu).reshape(b, w)
             + 1).to(torch.int32)
    pos = torch.tensor([45, 32767, 40000, 100000], dtype=torch.int32,
                       device=gpu)
    sms = torch.cuda.get_device_properties(gpu).multi_processor_count
    n_split, cols = kpaged.split_plan(w, kv, sms)
    live = kpaged.live_columns(pos, w, bs, window).cpu()
    dead = [i for i in range(n_split)
            if not live[:, i * cols:(i + 1) * cols].any()]
    assert dead, (n_split, cols)
    kk, pp = _kernel_and_plain(kpaged.paged_decode_attention, q, ck, cv,
                               table, pos, window=window, scale=dh ** -0.5)
    torch.testing.assert_close(kk.float(), pp.float(), rtol=BF16_ULP[0],
                               atol=BF16_ULP[1])


def _words(n, gpu, seed=0):
    g = torch.Generator(device=gpu)
    g.manual_seed(seed)
    return torch.randint(-2 ** 31, 2 ** 31, (n,), generator=g, device=gpu,
                         dtype=torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,kw,valid_k", [
    (64, 32, 8, 256), (256, 512, 16, 512), (4, 18944, 112, 3584),
    (32, 3584, 592, 18944), (5, 9, 3, 70), (17, 40, 7, 200),
    # each row-tile width at one qwen2-7b shape (wq/wo), ragged ones too
    (1, 3584, 112, 3584), (8, 3584, 112, 3584), (9, 3584, 112, 3584),
    (16, 3584, 112, 3584), (17, 3584, 112, 3584), (33, 3584, 112, 3584),
    # K past the first design's shared memory (Kw > 7264), ragged Kw
    (3, 40, 9375, 300000), (20, 33, 7265, 232480),
    # M past the first design's grid rows (M > 524280)
    (600000, 17, 8, 256)])
def test_cuda_xnor_gemm(gpu, m, n, kw, valid_k):
    if m * valid_k <= 2 ** 26:
        pa, _ = kpack.pack(torch.randn((m, valid_k), device=gpu))
        pb, _ = kpack.pack(torch.randn((n, valid_k), device=gpu))
    else:  # random words: every bit is live (valid_k = 32 Kw)
        assert valid_k == 32 * kw
        pa = _words(m * kw, gpu, seed=1).reshape(m, kw)
        pb = _words(n * kw, gpu, seed=2).reshape(n, kw)
    kk, pp = _kernel_and_plain(kxnor.xnor_gemm, pa, pb, valid_k)
    assert kk.dtype == torch.int32 and torch.equal(kk, pp)
    # a misaligned operand (one word in) takes the one-word path, on
    # either side
    big = torch.cat([pa.new_zeros(1), pa.reshape(-1)])[1:].reshape(m, kw)
    kk2, _ = _kernel_and_plain(kxnor.xnor_gemm, big, pb, valid_k)
    assert torch.equal(kk2, pp)
    big = torch.cat([pb.new_zeros(1), pb.reshape(-1)])[1:].reshape(n, kw)
    kk2, _ = _kernel_and_plain(kxnor.xnor_gemm, pa, big, valid_k)
    assert torch.equal(kk2, pp)


@pytest.mark.cuda
def test_cuda_xnor_gemm_plan_matches_launch(gpu):
    """The launch plan the wrapper checks is the one the kernel runs
    (``xnor_gemm_plan``, the C side's own plan), and a 16-way split-K
    plan (every K slice adds into slice 0's warps) gives the plain
    version's counts."""
    import ctypes
    for m in (1, 4, 8, 9, 16, 17, 32, 33, 64, 65, 256, 600000):
        for n, kw in ((3584, 112), (512, 112), (18944, 112), (3584, 592),
                      (32, 8), (512, 16), (9, 3), (40, 9375)):
            got = (ctypes.c_int * 5)()
            cuda.launch("xnor_gemm_plan", m, n, kw, ctypes.addressof(got))
            assert tuple(got) == tuple(kxnor.gemm_plan(m, n, kw)), (m, n, kw)
    assert kxnor.gemm_plan(4, 3584, 592).ks == 16
    assert kxnor.gemm_plan(32, 18944, 112).ks == 1
    assert kxnor.gemm_plan(600000, 17, 8).row_tiles == 9375
    pa = _words(4 * 592, gpu, seed=3).reshape(4, 592)
    pb = _words(3584 * 592, gpu, seed=4).reshape(3584, 592)
    kk, pp = _kernel_and_plain(kxnor.xnor_gemm, pa, pb, 32 * 592)
    assert torch.equal(kk, pp)


# the bulk kernel's edges: a block moves 256 quads; 1 to 3 words may be
# peeled before the first 16-byte boundary and 1 to 3 follow the last quad
BULK_LENGTHS = LENGTHS + [2, 3, 4, 5, 1023, 1024, 1025, 1027, 1028, 1031,
                          256 * 4 * 3 + 7]


@pytest.mark.cuda
@pytest.mark.parametrize("n", BULK_LENGTHS)
@pytest.mark.parametrize("invert", [False, True])
def test_cuda_bulk_xor(gpu, n, invert):
    a, b = _words(n + 3, gpu, 1), _words(n + 3, gpu, 2)
    # aligned; each offset of a and b alike (the peeled quad path); the two
    # at different offsets (one word a thread)
    pairs = [(a[i:i + n], b[i:i + n]) for i in range(4)]
    pairs += [(a[1:1 + n], b[2:2 + n]), (a[:n], b[3:3 + n])]
    for x, y in pairs:
        kk, pp = _kernel_and_plain(kbulk.bulk_xor, x, y, invert)
        assert torch.equal(kk, pp)
        if x.data_ptr() % 16 == y.data_ptr() % 16:      # out at a's offset
            assert kk.data_ptr() % 16 == x.data_ptr() % 16


@pytest.mark.cuda
@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("width", [64, 96, 128, 256, 1000])
def test_cuda_parity_digest(gpu, n, width):
    w = _words(n + 1, gpu, 3)
    for x in (w[:n], w[1:]):
        kk, pp = _kernel_and_plain(kparity.parity_digest, x, width)
        assert torch.equal(kk, pp)
        for chunk in (width, 4 * width):
            kk, pp = _kernel_and_plain(kparity.parity_digest, x, width, chunk)
            assert torch.equal(kk, pp)
    x = w[:n].clone()
    d0 = kparity.parity_digest(x, width)
    x[n // 2] ^= 1 << 9
    d1 = kparity.parity_digest(x, width)
    flips = (d0 ^ d1).cpu().numpy().view(np.uint32)
    assert int(np.unpackbits(flips.view(np.uint8)).sum()) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("counter", [0, 12345, 2 ** 32 - 5])
def test_cuda_xor_cipher(gpu, n, counter):
    w = _words(n + 1, gpu, 4)
    for x in (w[:n], w[1:]):
        kk, pp = _kernel_and_plain(kcipher.xor_cipher, x, 0x9E3779B9,
                                   0x0BADF00D, counter)
        assert torch.equal(kk, pp)
        assert torch.equal(kcipher.xor_cipher(kk, 0x9E3779B9, 0x0BADF00D,
                                              counter), x)


@pytest.mark.cuda
@pytest.mark.parametrize("bh,s,dh,bq,bk", [
    (2, 64, 16, 32, 32), (1, 128, 32, 32, 32), (3, 256, 8, 32, 32),
    (2, 128, 16, 16, 64), (2, 128, 16, 64, 16), (2, 128, 16, 128, 32),
    (1, 80, 24, 16, 16), (2, 192, 128, 64, 64), (1, 64, 256, 32, 32)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, (2e-5, 2e-5)),
                                       (torch.bfloat16, BF16_ULP)])
def test_cuda_flash_attention(gpu, bh, s, dh, bq, bk, causal, dtype, tol):
    g = torch.Generator(device=gpu)
    g.manual_seed(bh * 1000 + s + dh)
    q, k, v = (torch.randn((bh, s, dh), generator=g, device=gpu).to(dtype)
               for _ in range(3))
    kk, pp = _kernel_and_plain(kflash.flash_attention, q, k, v,
                               causal=causal, bq=bq, bk=bk)
    assert kk.dtype == dtype and kk.shape == (bh, s, dh)
    torch.testing.assert_close(kk.float(), pp.float(), rtol=tol[0],
                               atol=tol[1])
    oracle = kflash.flash_attention_ref(q, k, v, causal)
    torch.testing.assert_close(kk.float(), oracle.float(), rtol=tol[0],
                               atol=tol[1])


@pytest.mark.cuda
def test_cuda_flash_attention_rejects_unsupported_dh(gpu):
    q = torch.zeros((1, 64, 12), device=gpu)
    with pytest.raises(ValueError, match="multiple of 8"):
        kflash.flash_attention(q, q, q, bq=32, bk=32)


@pytest.mark.cuda
@pytest.mark.parametrize("root_key", [None, "card-key"])
def test_cuda_checkpoint_defaults_to_the_card(gpu, tmp_path, root_key):
    """With no ``engine=`` a checkpoint of a tree on the card digests (and
    ciphers) it through the card's kernels, and writes the same manifest
    and members as the host path."""
    import zipfile

    from repro_torch.checkpoint import ckpt

    g = torch.Generator(device=gpu)
    g.manual_seed(11)
    tree = {"w": torch.randn((64, 33), generator=g, device=gpu)
            .to(torch.bfloat16),
            "b": [torch.randn((7,), generator=g, device=gpu),
                  torch.arange(5, device=gpu, dtype=torch.int32)]}
    kparity.parity_digest.launches = 0
    kcipher.xor_cipher.launches = 0
    card = ckpt.save(str(tmp_path / "card"), 1, tree, root_key=root_key)
    assert kparity.parity_digest.launches >= 3
    assert (kcipher.xor_cipher.launches >= 3) == (root_key is not None)
    host = ckpt.save(str(tmp_path / "host"), 1, tree, root_key=root_key,
                     device="cpu")
    assert card == host
    members = []
    for d in ("card", "host"):
        with zipfile.ZipFile(tmp_path / d / "ckpt_00000001.npz") as z:
            members.append([(n, z.read(n)) for n in z.namelist()])
    assert members[0] == members[1]
    assert ckpt.check(str(tmp_path / "host"), 1, root_key=root_key) == \
        (True, [])
    got, _ = ckpt.restore(str(tmp_path / "host"), 1, tree, root_key=root_key)
    for a, b in zip((got["w"], *got["b"]), (tree["w"], *tree["b"])):
        assert a.device.type == "cuda" and a.dtype == b.dtype
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the serving tier on the card: sampling, migration, the router
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_prng_equals_cpu(gpu):
    """The threefry twin on the card: bits and uniforms bitwise equal to
    the CPU's; gumbel within two ulps of max(|g|, 1) (the card's log)."""
    from repro_torch.core import prng

    seeds = torch.tensor([0, 7, 2**31 - 2, 1_000_003])
    for dev_key, cpu_key in ((prng.fold_in(prng.PRNGKey(3, gpu), seeds.to(gpu)),
                              prng.fold_in(prng.PRNGKey(3), seeds)),):
        assert torch.equal(dev_key.cpu(), cpu_key)
        for shape in [(5,), (3, 152064)]:
            assert torch.equal(prng.bits(dev_key, shape).cpu(),
                               prng.bits(cpu_key, shape))
            assert torch.equal(prng.uniform(dev_key, shape).cpu(),
                               prng.uniform(cpu_key, shape))
        g, c = prng.gumbel(dev_key, (4096,)).cpu(), prng.gumbel(cpu_key,
                                                                 (4096,))
        ulp = torch.from_numpy(np.spacing(
            np.maximum(c.abs().numpy(), 1).astype(np.float32)))
        assert torch.all((g - c).abs() <= 2 * ulp)


def _smoke_serving(gpu, dtype=torch.bfloat16):
    import repro_torch.configs as configs
    from repro_torch.models import lm
    from repro_torch.serve import synthetic_trace

    cfg = configs.get("qwen2-7b+xnor").smoke(dtype=dtype)
    params = lm.init_params(cfg, 0, device=gpu)
    trace = synthetic_trace(6, cfg.vocab, seed=3, prompt_lens=(6, 11, 17),
                            new_tokens=(5, 9))
    return cfg, params, trace


def _run_engine(eng, trace):
    for r in trace:
        eng.submit(r)
    rep = eng.run()
    return {r.rid: rep.tokens(r.rid).tolist() for r in trace}


@pytest.mark.cuda
@pytest.mark.parametrize("dst_slots", [4, 2])
def test_cuda_migration_identity(gpu, tmp_path, dst_slots):
    """On the card, bf16, packed, T = 0.8: a session exported mid-decode
    from a 4-slot engine through an encrypted checkpoint (digests and
    cipher on the card) finishes in a ``dst_slots``-slot engine with the
    never-migrated tokens; the 2-slot case changes the batch the
    destination's kernels see."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.serve import ServeEngine

    cfg, params, trace = _smoke_serving(gpu)
    kw = dict(s_max=48, temperature=0.8, seed=0, device=gpu)
    want = _run_engine(ServeEngine(cfg, params, slots=4, **kw), trace)
    a = ServeEngine(cfg, params, slots=4, **kw)
    for r in trace:
        a.submit(r)
    sess = None
    for _ in range(12):
        a.step()
        live = [s for slot, s in a.pool.active.items()
                if s.tokens and not s.done and slot not in a._prefilling]
        if live:
            sess = live[0]
            break
    assert sess is not None
    rid = sess.request.rid
    b = ServeEngine(cfg, params, slots=dst_slots, **kw)
    kparity.parity_digest.launches = 0
    kcipher.xor_cipher.launches = 0
    d = str(tmp_path / "wire")
    ckpt.save(d, 1, a.export_session(rid), root_key="k")
    restored, _ = ckpt.restore(d, 1, b.export_spec(sess.request),
                               root_key="k")
    assert restored["state"]["segs"][0][0].k.device.type == "cuda"
    b.import_session(sess.request, restored)
    a.release_migrated(rid)
    assert kparity.parity_digest.launches > 0
    assert kcipher.xor_cipher.launches > 0
    rep_a, rep_b = a.run(), b.run()
    got = {r.rid: (rep_b if r.rid == rid else rep_a).tokens(r.rid).tolist()
           for r in trace}
    assert got == want


@pytest.mark.cuda
def test_cuda_router_kill_drill(gpu, tmp_path):
    """Two replicas sharing the card, the kill drill at router step 3:
    every request finishes with the single engine's tokens, at least one
    session migrated, the scrubber covered the packed weights and found
    nothing; one flipped weight word is then exactly one corruption."""
    from repro_torch.serve import Router, ServeEngine

    cfg, params, trace = _smoke_serving(gpu)
    kw = dict(slots=2, s_max=48, temperature=0.8, seed=0)
    want = _run_engine(ServeEngine(cfg, params, device=gpu, **kw), trace)
    router = Router(cfg, params, 2, ckpt_dir=str(tmp_path), epoch_steps=2,
                    **kw)
    assert [h.device.type for h in router.replicas] == ["cuda", "cuda"]
    for r in trace:
        router.submit(r)
    rep = router.run(kill_at=3)
    assert all(s.done for s in rep.sessions.values())
    assert {rid: rep.tokens(rid).tolist() for rid in want} == want
    assert rep.migrations and rep.scrub_corruptions == 0
    assert sum(r.scrub_weight_leaves for r in rep.replicas) > 0
    alive = [h for h in router.replicas if h.alive]
    pb = alive[0].engine.params["seg0_attn"]["ffn_w1"].pb
    assert router.scrub() == 0
    pb.view(-1)[0] ^= 1
    assert router.scrub() == 1


def _moe_case(seed, d=2048, e=64, ff=1408):
    """moonshot-v1-16b-a3b's MoE at full width (d 2048, 64 experts, top-6,
    d_ff 1408), one layer, bf16 experts and an f32 router, on the CPU."""
    import repro_torch.configs as configs
    cfg = configs.get("moonshot-v1-16b-a3b")
    g = torch.Generator()
    g.manual_seed(seed)
    p = {"router": torch.randn((d, e), generator=g) / d ** 0.5}
    for k, shape in (("w1", (e, d, ff)), ("w3", (e, d, ff)),
                     ("w2", (e, ff, d))):
        p[k] = (torch.randn(shape, generator=g) / shape[1] ** 0.5).to(
            torch.bfloat16)
    return cfg, p, g


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,n_valid", [(4, 1, None), (1, 32, 32),
                                         (1, 32, 19)])
def test_cuda_moe_ffn_matches_the_cpu(gpu, b, s, n_valid):
    """``moe_ffn`` on the card against its CPU run on the same inputs, at a
    decode step (4 slots, one token each: capacity 1) and a 32-token chunk
    (capacity 3; ragged at 19): the same routing (experts, kept mask,
    places) and y within 2^-7 (|y| + sum_j w_j |ye_j|), one bf16 ulp of y
    and one of the expert outputs it sums (cuBLAS sums each product's
    terms in its own order); PyTorch's settings as a user has them
    (``moe.experts`` sums its products in f32 itself)."""
    from repro_torch.models import moe
    cfg, p, g = _moe_case(b * 100 + s)
    x = torch.randn((b, s, cfg.d_model), generator=g).to(torch.bfloat16)
    valid = None if n_valid is None else torch.arange(s)[None] < n_valid
    y, aux = moe.moe_ffn(cfg, p, x, valid)
    pc = {k: v.to(gpu) for k, v in p.items()}
    vc = None if valid is None else valid.to(gpu)
    yc, auxc = moe.moe_ffn(cfg, pc, x.to(gpu), vc)
    tg = min(moe.group_len(cfg), s)
    xg = x.reshape(b * s // tg, tg, -1)
    vg = None if valid is None else valid.reshape(xg.shape[:2])
    r = moe.route(cfg, p["router"], xg, vg)
    rc = moe.route(cfg, pc["router"], xg.to(gpu),
                   None if vg is None else vg.to(gpu))
    assert torch.equal(rc.idx.cpu(), r.idx)
    assert torch.equal(rc.keep.cpu(), r.keep)
    assert torch.equal(rc.pos.cpu(), r.pos)
    terms = moe.combine(cfg, r, moe.experts(cfg, p, xg, r).abs(),
                        torch.bfloat16).reshape(y.shape)
    bound = 2.0 ** -7 * (y.float().abs() + terms)
    assert ((yc.cpu().float() - y.float()).abs() <= bound).all()
    torch.testing.assert_close(auxc.cpu(), aux, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_cuda_moe_rows_do_not_depend_on_the_batch(gpu):
    """A decode step's MoE at 1, 2 and 4 slots: each slot's row is the
    same bits whatever the batch (each slot is its own dispatch group, and
    the expert products' M grows with the slot count)."""
    from repro_torch.models import moe
    cfg, p, g = _moe_case(7)
    pc = {k: v.to(gpu) for k, v in p.items()}
    x = torch.randn((4, 1, cfg.d_model), generator=g).to(torch.bfloat16)
    x = x.to(gpu)
    four = moe.moe_ffn(cfg, pc, x)[0]
    for n in (1, 2):
        assert torch.equal(moe.moe_ffn(cfg, pc, x[:n].contiguous())[0],
                           four[:n])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [6, 64, 2048, 5120])
def test_cuda_row_sums_do_not_depend_on_the_batch(gpu, d):
    """Fault F4: PyTorch's CUDA sum over the last dim sizes its block by
    the row count, so a (4, 2048) f32 tensor's row 1 summed other bits
    than a (2, 2048) one's.  ``layers.row_sum`` (RMSNorm's sum of squares,
    the router's softmax and gate sums) and the decode router give every
    row the bits it has alone, at 2 to 32 rows, on f32 rows that are not
    bf16 values (whose squares sum exactly in any order)."""
    from repro_torch.models import layers, moe
    import repro_torch.configs as configs
    g = torch.Generator(device=gpu)
    g.manual_seed(d)
    x = torch.randn((32, 1, d), generator=g, device=gpu)
    alone = torch.cat([layers.row_sum(x[j:j + 1] * x[j:j + 1])
                       for j in range(32)])
    for b in range(2, 33):
        assert torch.equal(layers.row_sum(x[:b] * x[:b]), alone[:b]), b
        assert torch.equal(layers.row_sum(x[:b], square=True), alone[:b]), b
    torch.testing.assert_close(alone, (x * x).sum(-1, keepdim=True),
                               rtol=1e-5, atol=0)
    if d == 2048:
        cfg = configs.get("moonshot-v1-16b-a3b")
        router = torch.randn((d, 64), generator=g, device=gpu) / d ** 0.5
        xb = x.to(torch.bfloat16)
        r1 = [moe.route(cfg, router, xb[j:j + 1]) for j in range(8)]
        for b in (2, 4, 8):
            rb = moe.route(cfg, router, xb[:b])
            for j in range(b):
                assert torch.equal(rb.probs[j:j + 1], r1[j].probs), (b, j)
                assert torch.equal(rb.idx[j:j + 1], r1[j].idx), (b, j)


# the context archs' projections (N, K): llama-3.2-vision-11b's (trunk and
# cross layers alike) and whisper-tiny's (encoder and decoder alike), with
# the rows their context projections run at (the cross layers' wk/wv over
# 1,600 patch rows, every encoder linear over 1,500 frames)
CTX_LINEARS = [(4096, 4096, (4, 32)), (1024, 4096, (4, 32, 1600)),
               (14336, 4096, (4, 32)), (4096, 14336, (4, 32)),
               (384, 384, (4, 32, 1500)), (1536, 384, (4, 32, 1500)),
               (384, 1536, (4, 32, 1500))]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(m, k, n) for n, k, ms in CTX_LINEARS
                                   for m in ms])
def test_cuda_xnor_linear_fused_ctx_archs(gpu, m, k, n):
    """Bitwise against the plain version summed in the kernel's order and
    within the reference's tolerances of the plain one, f32 and bf16, at
    decode M, chunk M and the context projections' M 1,600 / 1,500."""
    g = torch.Generator(device=gpu)
    g.manual_seed(m * 13 + k + n)
    pb, beta = xnor_layers.pack_weights(
        torch.randn((n, k), generator=g, device=gpu))
    for dtype, tol in ((torch.float32, (2e-5, 2e-5)),
                       (torch.bfloat16, (2 ** -8, 1e-6))):
        x = torch.randn((m, k), generator=g, device=gpu).to(dtype)
        kk, pp = _kernel_and_plain(kxnor.xnor_linear_fused, x, pb, beta, k)
        assert torch.equal(kk, kxnor.linear_kernel_order(x, pb, beta, k))
        torch.testing.assert_close(kk, pp, rtol=tol[0], atol=tol[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,i8,tol", [("f32", False, (2e-5, 2e-5)),
                                          ("bf16", False, BF16_ULP),
                                          ("bf16", True, BF16_ULP)])
@pytest.mark.parametrize("w,pos", [(8, [0, 17, 127, 64]),
                                   (2048, [32767, 17, 20000, 4095])])
@pytest.mark.parametrize("kv,g,dh", [(8, 4, 128), (6, 1, 64)])
def test_cuda_paged_decode_ctx_archs(gpu, kv, g, dh, dtype, i8, tol, w, pos):
    """Paged decode at llama-3.2-vision-11b's self-attention geometry (KV
    8, G 4, dh 128) and whisper-tiny's decoder (KV 6, G 1, dh 64, a head
    width the kernel meets nowhere else), block 16, 4 slots, at W 8 and W
    2048 (a split walk), bf16, f32 and int8 pools, against the plain
    version; rows 0-1 of the launch bitwise a 2-slot launch's."""
    q, ck, cv, table, scale, out_scale = _case(
        b=4, kv=kv, g=g, dh=dh, bs=16, w=w, i8=i8, seed=w + dh)
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    conv = (lambda a: torch.from_numpy(a).to(gpu)) if i8 else \
        (lambda a: torch.from_numpy(a).to(gpu, tdt))
    args = (torch.from_numpy(q).to(gpu, tdt), conv(ck), conv(cv),
            torch.from_numpy(table).to(gpu),
            torch.tensor(pos, dtype=torch.int32, device=gpu))
    kk, pp = _kernel_and_plain(kpaged.paged_decode_attention, *args,
                               scale=scale, out_scale=out_scale)
    torch.testing.assert_close(kk.float(), pp.float(), rtol=tol[0],
                               atol=tol[1])
    tq, tk, tv, tt, tp = args
    two = kpaged.paged_decode_attention(
        tq[:2].contiguous(), tk, tv, tt[:2].contiguous(), tp[:2].contiguous(),
        scale=scale, out_scale=out_scale)
    torch.cuda.synchronize()
    assert torch.equal(two, kk[:2])


@pytest.mark.cuda
@pytest.mark.parametrize("arch,dtype", [
    ("llama-3.2-vision-11b", torch.bfloat16),
    ("llama-3.2-vision-11b", torch.float32),
    ("whisper-tiny", torch.bfloat16),
    ("whisper-tiny", torch.float32)])
def test_cuda_cross_attention_rows_do_not_depend_on_the_batch(gpu, arch,
                                                              dtype):
    """A decode step's cross-attention at full width (llama-3.2-vision: 32
    heads over 8 KV heads of 128 and 1,600 context rows; whisper: 6 heads
    of 64 over 1,500 frames) at 1 to 8 slots: each slot's output row is
    the same bits whatever the batch (the session migration contract,
    hazard H2: the score and P.V products and the softmax run over B x H
    rows)."""
    import dataclasses

    import repro_torch.configs as configs
    from repro_torch.models import attention as attn_mod
    cfg = dataclasses.replace(configs.get(arch + "+xnor"), dtype=dtype)
    g = torch.Generator(device=gpu)
    g.manual_seed(cfg.d_model)
    d, hd = cfg.d_model, cfg.n_heads * cfg.d_head
    kvd = cfg.n_kv_heads * cfg.d_head
    p = {name: xnor_layers.pack_linear(
        (torch.randn((d, n), generator=g, device=gpu) / d ** 0.5).to(dtype))
         for name, n in (("wq", hd), ("wk", kvd), ("wv", kvd))}
    p["wo"] = xnor_layers.pack_linear(
        (torch.randn((hd, d), generator=g, device=gpu) / hd ** 0.5).to(dtype))
    ctx = torch.randn((8, cfg.n_ctx_tokens, d), generator=g,
                      device=gpu).to(dtype) * 0.1
    ctx_kv = tuple(torch.cat(t) for t in zip(*(      # per slot, as admitted
        attn_mod.make_ctx_kv(cfg, p, ctx[j:j + 1]) for j in range(8))))
    x = torch.randn((8, 1, d), generator=g, device=gpu).to(dtype)
    alone = torch.cat([attn_mod.decode_cross_attention(
        cfg, p, x[j:j + 1], tuple(t[j:j + 1] for t in ctx_kv))
        for j in range(8)])
    for b in range(2, 9):
        out = attn_mod.decode_cross_attention(
            cfg, p, x[:b], tuple(t[:b] for t in ctx_kv))
        assert torch.equal(out, alone[:b]), b


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kind,arch", [("cross", "llama-3.2-vision-11b"),
                                       ("dec", "whisper-tiny")])
def test_cuda_ctx_block_decode_rows_do_not_depend_on_the_batch(gpu, kind,
                                                               arch, dtype):
    """One layer of a context kind, binarized and packed at full width, in
    the decode the engine runs on the card (``dec``: its self-attention
    paged through the paged decode kernel, then cross-attention to the
    slot's ``ctx_kv``; ``cross``: cross-attention alone), at 1 to 8
    slots: each slot's output row is the same bits whatever the batch
    (hazard H2 at the block, the session migration contract)."""
    import dataclasses

    import repro_torch.configs as configs
    from repro_torch.models import blocks, registry
    from repro_torch.models import params as pdefs
    cfg = dataclasses.replace(configs.get(arch + "+xnor"), dtype=dtype)
    block = registry.get(kind)
    defs = block.defs(cfg, 1)
    g = torch.Generator(device=gpu)
    g.manual_seed(cfg.d_model + 1)
    p = blocks.layer_params(pdefs.pack(defs, pdefs.init(defs, g, gpu)), 0)
    slots, bs, w = 8, 16, 2
    state = block.paged_state_spec(cfg, 1, slots, 1 + slots * w, bs, gpu)
    for leaf in blocks.state_leaves(state):
        leaf.copy_(torch.randn(leaf.shape, generator=g, device=gpu))
    start = [t.clone() for t in blocks.state_leaves(state)]
    table = (torch.arange(slots * w, device=gpu, dtype=torch.int32)
             .reshape(slots, w) + 1)
    table = table if block.contract.paged_kv else None
    pos = torch.tensor([5, 17, 30, 0, 9, 22, 13, 31], device=gpu)
    x = torch.randn((slots, 1, cfg.d_model), generator=g,
                    device=gpu).to(dtype)

    def step(lo, hi):
        for leaf, t in zip(blocks.state_leaves(state), start):
            leaf.copy_(t)
        shared, per_slot = block.paged_split(state)
        st = block.paged_merge(shared, blocks.state_map(
            lambda l: l[:, lo:hi], per_slot))
        return block.decode(cfg, p, x[lo:hi], blocks._layer(st, 0),
                            pos[lo:hi], None if table is None
                            else table[lo:hi])
    alone = torch.cat([step(j, j + 1) for j in range(slots)])
    for b in range(2, slots + 1):
        assert torch.equal(step(0, b), alone[:b]), b


def _xlstm_block(kind, cfg, device, seed):
    """One packed layer of ``kind`` at ``cfg``'s width, drawn from a seeded
    generator on ``device``."""
    from repro_torch.models import blocks, registry
    from repro_torch.models import params as pdefs
    block = registry.get(kind)
    defs = block.defs(cfg, 1)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return block, blocks.layer_params(
        pdefs.pack(defs, pdefs.init(defs, g, device)), 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_cuda_xlstm_block_decode_rows_do_not_depend_on_the_batch(gpu, kind,
                                                                 dtype):
    """One xlstm-350m+xnor layer at full width (the mLSTM's memory 4 x 512
    x 512 f32 a slot), packed, decoding from a random per-slot state at 1
    to 8 slots: each slot's output row and new state are the bits it gets
    alone (hazard H2: the mLSTM's C q and |n q|, the f32 ``w_if``
    product and the sLSTM's recurrent product sum each row alone through
    ``layers.row_sum``)."""
    import dataclasses

    import repro_torch.configs as configs
    from repro_torch.models import blocks
    cfg = dataclasses.replace(configs.get("xlstm-350m+xnor"), dtype=dtype)
    block, p = _xlstm_block(kind, cfg, gpu, cfg.d_model + 2)
    g = torch.Generator(device=gpu)
    g.manual_seed(5)
    state = block.state_spec(cfg, 1, 8, 0, gpu)
    for leaf in blocks.state_leaves(state):
        leaf.copy_(torch.randn(leaf.shape, generator=g, device=gpu))
    start = [t.clone() for t in blocks.state_leaves(state)]
    x = torch.randn((8, 1, cfg.d_model), generator=g, device=gpu).to(dtype)

    def step(lo, hi):
        for leaf, t in zip(blocks.state_leaves(state), start):
            leaf.copy_(t)
        st = blocks.state_map(lambda l: l[:, lo:hi], state)
        y = block.decode(cfg, p, x[lo:hi], blocks._layer(st, 0), None, None)
        return [y] + [l[0, lo:hi].clone() for l in blocks.state_leaves(state)]
    alone = [torch.cat(t) for t in zip(*(step(j, j + 1) for j in range(8)))]
    for b in range(2, 9):
        for got, want in zip(step(0, b), alone):
            assert torch.equal(got, want[:b]), b


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["mlstm", "slstm", "bindense"])
def test_cuda_xlstm_and_bindense_blocks_match_the_cpu(gpu, kind):
    """One packed layer at smoke width (xlstm-350m+xnor's, xnor-cnn's), f32:
    prefill over 11 tokens, three decode steps and a ragged chunk on the
    card (the fused linear kernel, the card's sums) against the same
    weights and inputs on the CPU (the plain versions, the reference's
    sums), within 1e-4; the states too."""
    import repro_torch.configs as configs
    from repro_torch.models import blocks
    name = "xnor-cnn" if kind == "bindense" else "xlstm-350m+xnor"
    cfg = configs.get(name)
    cfg = cfg if kind == "bindense" else cfg.smoke(dtype=torch.float32)
    block, p = _xlstm_block(kind, cfg, "cpu", 11)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 11, cfg.d_model))
                         .astype(np.float32))
    steps = [torch.from_numpy(rng.standard_normal((2, 1, cfg.d_model))
                              .astype(np.float32)) for _ in range(3)]
    xc = torch.from_numpy(rng.standard_normal((1, 8, cfg.d_model))
                          .astype(np.float32))
    ctx = torch.from_numpy((rng.standard_normal(
        (2, max(cfg.n_ctx_tokens, 1), cfg.d_model)) * 0.1).astype(np.float32))
    ctx = ctx if cfg.n_ctx_tokens else None
    valid = torch.arange(8)[None] < 5

    def run(dev):
        pd = {k: v.to(dev) for k, v in p.items()}
        c = None if ctx is None else ctx.to(dev)
        y, st = block.fwd(cfg, pd, x.to(dev),
                          blocks.FwdOpts(want_state=True, s_max=16), c)
        outs = [y]
        for t in steps:
            if kind == "bindense":
                outs.append(block.decode(cfg, pd, t.to(dev), st, None, None))
                continue
            one = blocks.state_map(lambda l: l[None], st)
            outs.append(block.decode(cfg, pd, t.to(dev),
                                     blocks._layer(one, 0), None, None))
        first = blocks.state_map(lambda l: l[:1].clone(), st)
        outs.append(block.chunk(cfg, pd, xc.to(dev), first, None,
                                valid.to(dev), 5, None,
                                None if c is None else c[:1])[:, :5])
        return [o.cpu() for o in outs + blocks.state_leaves(st)
                + blocks.state_leaves(first)]
    for got, want in zip(run(gpu), run("cpu")):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# training on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-7b+xnor", "moonshot-v1-16b-a3b"])
def test_cuda_train_step_grads_match_cpu(gpu, arch):
    """One train step at smoke size, f32, from the same parameters and
    batch on the card and on the CPU: loss and gnorm within 1e-5, every
    gradient within 2e-5 of its leaf's largest |g| (the tolerances the CPU
    tests hold the port to against the reference; TF32 off)."""
    import repro_torch.configs as configs
    from repro_torch.core import verify
    from repro_torch.data import synthetic
    from repro_torch.train import train_step as train_mod

    cfg = configs.get(arch).smoke(dtype=torch.float32)
    params = train_mod.init_state(cfg, 0, device="cpu").params
    host = synthetic.batch(0, 3, 2, 16, cfg.vocab)
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = {}
        for dev in ("cpu", gpu):
            p = verify.tree_map(lambda t: t.to(dev, copy=True), params)
            loss, m, g = train_mod._grads(cfg, p, synthetic.to_device(
                host, dev))
            out[str(dev)] = (loss, m, dict(
                (verify.leaf_key(k), v)
                for k, v in verify.tree_flatten_with_path(g)))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was
    (lc, mc, gc), (lg, mg, gg) = out["cpu"], out["cuda"]
    assert abs(float(lg) - float(lc)) <= 1e-5 * abs(float(lc))
    torch.testing.assert_close(mg["aux"].cpu(), mc["aux"], rtol=1e-5,
                               atol=1e-6)
    for key, want in gc.items():
        got = gg[key].cpu()
        assert got.dtype == want.dtype and got.shape == want.shape, key
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 2e-5 * scale + 1e-12, key


@pytest.mark.cuda
@pytest.mark.parametrize("d", [256, 2048])
def test_cuda_train_mode_row_sums_do_not_depend_on_the_batch(gpu, d):
    """Under autograd ``layers.row_sum`` pads its rows with zeros instead
    of writing a buffer (autograd records no ``out=`` write): RMSNorm's
    output row keeps the bits it has alone at 1 to 8 rows (H2) and equals
    the inference form's, and the backward runs (its sums are autograd's
    own; training does not serve slots)."""
    from repro_torch.models import layers
    g = torch.Generator(device=gpu)
    g.manual_seed(d)
    x = torch.randn((8, 1, d), generator=g, device=gpu)
    scale = torch.randn((d,), generator=g, device=gpu)

    def norm(rows):
        leaf = rows.clone().requires_grad_(True)
        y = layers.rms_norm(leaf, scale)
        (y * y).sum().backward()
        return y.detach(), leaf.grad
    alone = [norm(x[j:j + 1]) for j in range(8)]
    with torch.no_grad():
        inference = torch.cat([layers.rms_norm(x[j:j + 1], scale)
                               for j in range(8)])
    assert torch.equal(torch.cat([a[0] for a in alone]), inference)
    for b in range(1, 9):
        y, grad = norm(x[:b])
        for j in range(b):
            assert torch.equal(y[j:j + 1], alone[j][0]), (b, j)
        assert torch.isfinite(grad).all()
        torch.testing.assert_close(grad, torch.cat([a[1] for a in alone[:b]]),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_cuda_sharded_engine_matches_single_device(gpu):
    """``ShardedCimEngine`` over 2 gloo ranks on the card against the
    single-device ``CimEngine`` on the card, bitwise, on the CPU tests'
    sweep (``mesh_ranks.engine_cases``): chunks in rank order rebuild
    xor, xnor and the ciphertext; every rank holds the digests."""
    from mesh_ranks import engine_cases, engine_rank
    from repro_torch.core import bitpack
    from repro_torch.core.engine import CimEngine
    from repro_torch.launch import mesh as mesh_mod

    ranks = mesh_mod.run_ranks(engine_rank, 2, 2, 0, "cuda")
    ref = CimEngine(device="cuda")
    for i, c in enumerate(engine_cases(0)):
        a, b = (bitpack.from_numpy_u32(c[k]).cuda() for k in "ab")
        key = [int(k) for k in c["key"]]
        for op, want in (("xor", ref.xor(a, b)), ("xnor", ref.xnor(a, b)),
                         ("cipher", ref.stream_cipher(a, key, c["ctr"]))):
            got = np.concatenate([r["cases"][i][op] for r in ranks])
            np.testing.assert_array_equal(got, bitpack.to_numpy_u32(want),
                                          err_msg=f"{op} case {i}")
        for r in ranks:
            assert r["cases"][i]["round_trip"]
            np.testing.assert_array_equal(
                r["cases"][i]["digest"],
                bitpack.to_numpy_u32(ref.digest(a, c["width"])))
            np.testing.assert_array_equal(
                r["cases"][i]["chunks"], bitpack.to_numpy_u32(
                    ref.digest_chunks(a, c["chunk"], c["width"])))


@pytest.mark.cuda
@pytest.mark.parametrize("heads, tp", [(28, 4), (28, 16), (40, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_row_parallel_xnor_chain_matches_its_plain_version(gpu, heads,
                                                                tp, dtype):
    """The row-parallel packed linear's share on each rank
    (``layers.row_partial``: the pack kernel on the rank's valid heads,
    its words padded with 1 bits to the block's, the ``xnor_gemm``
    kernel at its true K) against its plain version on the same inputs:
    dots and |x| sums bitwise; the ranks' dots summed equal the whole-K
    ``xnor_matmul`` of the kernel bitwise.  qwen2-7b's ``wo`` over 4
    ranks (7 heads a rank) and 16 (2; ranks 14-15 none), llama4-scout's
    over 16 (3; rank 13 one head, 14-15 none), M = 4."""
    from repro_torch.distributed import sharding
    from repro_torch.models import layers
    g = torch.Generator(device=gpu)
    g.manual_seed(heads + tp)
    k, n, m = heads * 128, 1024, 4
    x = torch.randn((m, k), generator=g, device=gpu).to(dtype)
    w = torch.randn((k, n), generator=g, device=gpu).to(dtype)
    packed = xnor_layers.pack_linear(w)
    pa, _ = kpack.pack(x)
    whole = kxnor.xnor_gemm(pa, packed.pb, k)
    entry = sharding.Heads("model", heads, 128, 1)
    total = torch.zeros_like(whole)
    launches = kxnor.xnor_gemm.launches
    for i in range(tp):
        bs, start, stop = sharding.extent(k, entry, tp, i)
        wb = xnor_layers.PackedLinear(
            sharding.shard_bits(packed.pb, k, bs, start, stop), packed.beta,
            k)
        got, want = _kernel_and_plain(layers.row_partial, x[:, start:stop],
                                      wb)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        total += got[0]
    assert kxnor.xnor_gemm.launches - launches == sum(
        1 for i in range(tp) if sharding.extent(k, entry, tp, i)[2]
        > sharding.extent(k, entry, tp, i)[1])
    assert torch.equal(total, whole)


@pytest.mark.cuda
@pytest.mark.parametrize("arch, kind", [
    ("qwen2-7b+xnor", "attn"), ("moonshot-v1-16b-a3b+xnor", "moe"),
    ("recurrentgemma-2b+xnor", "local"), ("recurrentgemma-2b+xnor", "rglru"),
    ("xlstm-350m+xnor", "mlstm"), ("xlstm-350m+xnor", "slstm")])
def test_cuda_tp_block_decode_rows_do_not_depend_on_the_batch(gpu, arch,
                                                               kind):
    """One bf16 layer at full width (attn; moe, its experts split over
    the ranks; local at recurrentgemma's 10 query heads and one KV head;
    rglru, mlstm and slstm on their blocks, their state's too), tensor
    parallel over 2 gloo ranks on the card, at 1 to 8 slots: each slot's
    output row has the same bits whatever the batch (hazard H2 at the
    model axis's sums and gathers: the row-parallel ``wo``, ``w2``,
    ``w_out`` and ``w_down``, the experts' rows, the gathered columns)."""
    from mesh_ranks import tp_block_rows_rank
    from repro_torch.launch import mesh as mesh_mod
    ranks = mesh_mod.run_ranks(tp_block_rows_rank, 2, arch, "bfloat16",
                               "cuda", kind, timeout_s=600)
    for r in ranks:
        assert r == [0] * 8, r


def _hold_tp_layer_grads(arch: str) -> None:
    """One bf16 layer at full width, its forward and backward through its
    checkpoint on 2 gloo ranks on the card (heads, ``d_ff`` or experts
    over ``model``; the collectives of its backward on autograd's device
    thread, the recompute under the rank's context) against the
    single-process layer: the output within 2^-5 of its largest |y|,
    every gradient block within 2^-5 of its leaf's largest |g| (the bf16
    training tolerance of tests/test_torch_train.py), and the gradients
    of the input and of the leaves replicated over ``model`` the same
    bits on both ranks."""
    from mesh_ranks import tp_layer_grad_rank
    from repro_torch.launch import mesh as mesh_mod
    ranks = mesh_mod.run_ranks(tp_layer_grad_rank, 2, arch, "bfloat16",
                               timeout_s=600)
    for r in ranks:
        assert r["y"] <= 2 ** -5, r["y"]
        bad = {k: v for k, v in r["leaves"].items() if v > 2 ** -5}
        assert not bad, bad
    assert set(ranks[0]["replicated"]) >= {"x", "ln1", "ln2"}
    for key, g in ranks[0]["replicated"].items():
        assert np.array_equal(g, ranks[1]["replicated"][key]), key


@pytest.mark.cuda
def test_cuda_tp_attn_layer_trains_like_the_single_process_layer(gpu):
    _hold_tp_layer_grads("qwen2-7b+xnor")


@pytest.mark.cuda
def test_cuda_tp_moe_layer_trains_like_the_single_process_layer(gpu):
    _hold_tp_layer_grads("moonshot-v1-16b-a3b+xnor")
