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
    n_split, _ = kpaged.split_plan(64, 16, sms)
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
    n_split, cols = kpaged.split_plan(w, b * kv, sms)
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
