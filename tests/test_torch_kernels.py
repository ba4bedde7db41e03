"""The port's bit-domain core and kernels against the JAX reference.

CPU part (runs everywhere): bitpack, the plain versions of the three
ported kernels and ``pack_linear``, held against ``repro`` bitwise in the
integer domain and allclose for attention, on the cases of
``tests/test_paged_kernel.py``.  Inputs are made with numpy from a seed
and passed to both packages.

f32 sums depend on reduction order, and XLA's CPU reduce and torch's sum
associate differently.  Where a float result is compared bitwise, the
inputs are dyadic rationals (multiples of 1/8 with small magnitudes), for
which every order gives the same sum; Gaussian inputs are compared at
allclose beside them.

The kernels themselves are held against these plain versions on the card
by ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import bitpack as jbitpack
from repro.core import xnor_layers as jxl
from repro.kernels import ref as jref
from repro_torch.core import bitpack, xnor_layers
from repro_torch.kernels import ops
from repro_torch.kernels import pack as kpack
from repro_torch.kernels import paged_attn as kpaged
from repro_torch.kernels import ref
from repro_torch.kernels import xnor_gemm as kxnor


_paged_ref = jax.jit(jref.paged_decode,
                     static_argnames=("window", "scale", "out_scale"))
_fused_ref = jax.jit(jref.xnor_linear_fused, static_argnames=("valid_k",))


def _dyadic(rng, shape):
    return (rng.integers(-64, 64, size=shape) / 8.0).astype(np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(a, dtype)


def _u32(x):
    return np.asarray(x, np.uint32)


# ---------------------------------------------------------------------------
# bitpack
# ---------------------------------------------------------------------------

SPECIALS = np.array([0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf],
                    np.float32)


@pytest.mark.parametrize("shape", [(5, 64), (3, 7, 96), (1, 32)])
def test_pack_bits_bitwise(shape):
    rng = np.random.default_rng(1)
    x = rng.standard_normal(shape).astype(np.float32)
    flat = x.reshape(-1)
    flat[:len(SPECIALS)] = SPECIALS          # -0.0 -> 1, NaN -> 0
    want = _u32(jbitpack.pack_bits(_j(x)))
    got = bitpack.to_numpy_u32(bitpack.pack_bits(_t(x)))
    assert got.dtype == np.uint32 and np.array_equal(got, want)
    # bool input packs its truth values
    b = x > 0.5
    assert np.array_equal(
        bitpack.to_numpy_u32(bitpack.pack_bits(torch.from_numpy(b))),
        _u32(jbitpack.pack_bits(jnp.asarray(b))))


def test_pack_bits_subnormals_follow_ieee():
    """A negative subnormal is < 0, so it packs to 0 in the port (and in
    the CUDA kernels, built without flush-to-zero).  XLA's CPU backend
    flushes subnormals to zero and packs it to 1 — a known difference of
    the reference on the CPU, not a port fault; it is kept out of the
    bitwise comparisons above."""
    x = np.zeros((1, 32), np.float32)
    x[0, :4] = [1e-45, -1e-45, 1e-40, -1e-40]
    got = int(bitpack.to_numpy_u32(bitpack.pack_bits(_t(x)))[0, 0])
    assert got == 0xFFFFFFFF & ~0b1010


@pytest.mark.parametrize("k", [1, 31, 33, 70, 96])
def test_pad_to_word_and_ragged_pack(k):
    rng = np.random.default_rng(k)
    x = rng.standard_normal((4, k)).astype(np.float32)
    xp = bitpack.pad_to_word(_t(x))
    want = np.asarray(jbitpack.pad_to_word(_j(x)))
    assert np.array_equal(xp.numpy(), want)
    assert np.array_equal(bitpack.to_numpy_u32(bitpack.pack_bits(xp)),
                          _u32(jbitpack.pack_bits(jnp.asarray(want))))
    assert bitpack.packed_width(k) == jbitpack.packed_width(k)
    with pytest.raises(ValueError):
        if k % 32:
            bitpack.pack_bits(_t(x))
        else:
            raise ValueError("word multiple: nothing to reject")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("k", [40, 64, 200])
def test_binarize_bitwise(dtype, k):
    rng = np.random.default_rng(k)
    x = _dyadic(rng, (6, k))
    x[0, :3] = [-0.0, 0.0, -0.125]
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    jp, ja = jbitpack.binarize(_j(x, jdt))
    tp, ta = bitpack.binarize(_t(x, tdt))
    assert np.array_equal(bitpack.to_numpy_u32(tp), _u32(jp))
    assert ta.dtype == torch.float32
    assert np.array_equal(ta.numpy(), np.asarray(ja))
    # the ops layer (dispatch by device: CPU -> plain) agrees
    op, oa = ops.binarize(_t(x, tdt))
    assert np.array_equal(bitpack.to_numpy_u32(op), _u32(jp))
    assert np.array_equal(oa.numpy(), np.asarray(ja))


def test_binarize_gaussian_allclose():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((9, 3584)).astype(np.float32)
    jp, ja = jbitpack.binarize(_j(x))
    tp, ta = bitpack.binarize(_t(x))
    assert np.array_equal(bitpack.to_numpy_u32(tp), _u32(jp))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-6)


def test_word_conversion_and_popcount():
    rng = np.random.default_rng(3)
    words = rng.integers(0, 2**32, size=(5, 7), dtype=np.uint32)
    t = bitpack.from_numpy_u32(words)
    assert t.dtype == torch.int32
    assert np.array_equal(bitpack.to_numpy_u32(t), words)
    assert np.array_equal(bitpack.popcount(t).numpy(),
                          np.bitwise_count(words).astype(np.int64))
    # a word's bits are its sign pattern: pack the reference's unpacking
    signs = jbitpack.unpack_bits(jnp.asarray(words))
    assert np.array_equal(bitpack.to_numpy_u32(
        bitpack.pack_bits(torch.from_numpy(np.array(signs)))), words)


def test_pack_wrapper_plain_on_cpu():
    """The pack wrapper on CPU tensors is the plain version, launches no
    kernel, and matches the reference pack on word-multiple K; ragged K
    pads as pad_to_word does."""
    rng = np.random.default_rng(11)
    x = _dyadic(rng, (7, 96))
    before = kpack.pack.launches
    planes, alpha = kpack.pack(_t(x))
    assert kpack.pack.launches == before
    jp, ja = jref.pack(_j(x))
    assert np.array_equal(bitpack.to_numpy_u32(planes), _u32(jp))
    assert np.array_equal(alpha.numpy(), np.asarray(ja))
    xr = _dyadic(rng, (3, 45))
    planes, alpha = kpack.pack(_t(xr))
    jp, ja = jbitpack.binarize(_j(xr))
    assert np.array_equal(bitpack.to_numpy_u32(planes), _u32(jp))
    assert np.array_equal(alpha.numpy(), np.asarray(ja))


# ---------------------------------------------------------------------------
# XNOR GEMM / fused linear / pack_linear
# ---------------------------------------------------------------------------

def _jax_packed(w):
    pb, beta = jxl.pack_weights(_j(w), impl="ref")
    return pb, beta, bitpack.from_numpy_u32(_u32(pb)), _t(np.asarray(beta))


@pytest.mark.parametrize("m,k,n", [(5, 70, 9), (17, 200, 33), (4, 64, 16)])
def test_xnor_gemm_bitwise(m, k, n):
    rng = np.random.default_rng(m * k)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((n, k)).astype(np.float32)
    pa = jbitpack.pack_bits(jbitpack.pad_to_word(_j(a)))
    pb = jbitpack.pack_bits(jbitpack.pad_to_word(_j(b)))
    want = np.asarray(jref.xnor_gemm(pa, pb, k))
    got = ref.xnor_gemm(bitpack.from_numpy_u32(_u32(pa)),
                        bitpack.from_numpy_u32(_u32(pb)), k)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert np.array_equal(
        ops.xnor_matmul(bitpack.from_numpy_u32(_u32(pa)),
                        bitpack.from_numpy_u32(_u32(pb)), k).numpy(), want)


@pytest.mark.parametrize("m,k,n", [(5, 70, 9), (17, 200, 33), (4, 64, 16)])
def test_xnor_linear_fused_bitwise_f32(m, k, n):
    rng = np.random.default_rng(m + k + n)
    x, w = _dyadic(rng, (m, k)), _dyadic(rng, (n, k))
    jpb, jbeta, pb, beta = _jax_packed(w)
    want = np.asarray(_fused_ref(_j(x), jpb, jbeta, k))
    got = ref.xnor_linear_fused(_t(x), pb, beta, k)
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)
    before = kxnor.xnor_linear_fused.launches
    via_ops = ops.xnor_linear_fused(_t(x), pb, beta, k)
    assert kxnor.xnor_linear_fused.launches == before
    assert np.array_equal(via_ops.numpy(), want)


def test_xnor_linear_fused_gaussian_and_pm1():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((8, 3584)).astype(np.float32)
    w = rng.standard_normal((40, 3584)).astype(np.float32)
    jpb, jbeta, pb, beta = _jax_packed(w)
    want = np.asarray(_fused_ref(_j(x), jpb, jbeta, 3584))
    got = ref.xnor_linear_fused(_t(x), pb, beta, 3584).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    # ±1 activations make alpha exactly 1: the exact integer dot times beta
    pm1 = rng.choice([-1.0, 1.0], (8, 96)).astype(np.float32)
    w96 = rng.standard_normal((6, 96)).astype(np.float32)
    jpb, jbeta, pb, beta = _jax_packed(w96)
    assert np.array_equal(ref.xnor_linear_fused(_t(pm1), pb, beta, 96).numpy(),
                          np.asarray(_fused_ref(_j(pm1), jpb,
                                                            jbeta, 96)))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_pack_linear_leading_axis(dtype):
    rng = np.random.default_rng(2)
    w = (_dyadic(rng, (3, 48, 10)) if dtype == "f32"
         else rng.standard_normal((3, 48, 10)).astype(np.float32))
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    jpl = jxl.pack_linear(_j(w, jdt), impl="ref")
    pl = xnor_layers.pack_linear(_t(w, tdt))
    assert pl.k == jpl.k == 48
    assert tuple(pl.pb.shape) == jpl.pb.shape == (3, 10, 2)
    assert np.array_equal(bitpack.to_numpy_u32(pl.pb), _u32(jpl.pb))
    assert pl.beta.dtype == torch.float32
    assert np.array_equal(pl.beta.numpy(), np.asarray(jpl.beta))
    # the layer slice is the per-layer PackedLinear
    one = pl[1]
    assert tuple(one.pb.shape) == (10, 2) and one.k == 48


def test_prepacked_width_mismatch_raises():
    rng = np.random.default_rng(4)
    pl = xnor_layers.pack_linear(_t(rng.standard_normal((40, 6))))
    with pytest.raises(ValueError):     # 33 and 40 both round to 2 words
        xnor_layers.xnor_linear_prepacked(_t(rng.standard_normal((2, 33))),
                                          pl.pb, pl.beta, pl.k)
    with pytest.raises(ValueError):
        xnor_layers.pack_linear(_t(np.ones(4, np.float32)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_float_binary_path_equals_packed(dtype):
    """Inside the port, the float STE forward and the packed fused path
    compute the same thing bit for bit (sign semantics, alpha, beta)."""
    rng = np.random.default_rng(6)
    x = _t(rng.standard_normal((2, 5, 72)), dtype)
    w = _t(rng.standard_normal((72, 11)), dtype)
    flt = xnor_layers.xnor_linear(x, w.t())
    pl = xnor_layers.pack_linear(w)
    fused = xnor_layers.xnor_linear_prepacked(x, pl.pb, pl.beta, pl.k)
    chain = xnor_layers.xnor_linear_prepacked(x, pl.pb, pl.beta, pl.k,
                                              mode="off")
    assert torch.equal(flt, fused) and torch.equal(fused, chain)
    # and against the reference's float path
    jy = jxl.xnor_linear(_j(x.float().numpy(), jnp.float32),
                         _j(w.float().numpy().T, jnp.float32))
    np.testing.assert_allclose(
        xnor_layers.xnor_linear(x.float(), w.float().t()).numpy(),
        np.asarray(jy), rtol=1e-6, atol=1e-6)


def test_fused_mode():
    assert ops.fused_mode("auto") == "kernel"
    assert ops.fused_mode("on") == "kernel"
    assert ops.fused_mode("off") == "ref"
    with pytest.raises(ValueError):
        ops.fused_mode("bogus")


@pytest.mark.parametrize("device,want", [("cuda", "kernel"), ("cpu", "ref"),
                                         (torch.device("cpu"), "ref")])
def test_fused_mode_auto_follows_device(device, want):
    """"auto" takes the kernels exactly on the card, as the reference's
    takes them exactly on a TPU; an explicit mode holds on any device."""
    assert ops.fused_mode("auto", device) == want
    assert ops.fused_mode("on", device) == "kernel"
    assert ops.fused_mode("off", device) == "ref"


# ---------------------------------------------------------------------------
# paged decode (cases of tests/test_paged_kernel.py)
# ---------------------------------------------------------------------------

def _case(*, b=3, kv=2, g=2, dh=16, bs=8, w=5, dtype="f32", i8=False,
          seed=0):
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
    return q, ck, cv, table, float(scale), float(out_scale), dtype


def _both(a, dtype):
    if a.dtype == np.int8:
        return jnp.asarray(a), torch.from_numpy(a)
    if dtype == "bf16":
        return jnp.asarray(a, jnp.bfloat16), _t(a, torch.bfloat16)
    return jnp.asarray(a, jnp.float32), _t(a)


def _paged_parity(case, pos, *, window, tol):
    q, ck, cv, table, scale, out_scale, dtype = case
    jq, tq = _both(q, dtype)
    jk, tk = _both(ck, dtype)
    jv, tv = _both(cv, dtype)
    pos = np.asarray(pos, np.int32)
    want = _paged_ref(jq, jk, jv, jnp.asarray(table), jnp.asarray(pos),
                             window=window, scale=scale, out_scale=out_scale)
    before = kpaged.paged_decode_attention.launches
    got = kpaged.paged_decode_attention(
        tq, tk, tv, torch.from_numpy(table), torch.from_numpy(pos),
        window=window, scale=scale, out_scale=out_scale)
    assert kpaged.paged_decode_attention.launches == before
    assert got.dtype == tq.dtype and tuple(got.shape) == q.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,tol", [("f32", 2e-5), ("bf16", 3e-2)])
@pytest.mark.parametrize("pos", [[0, 17, 39], [7, 8, 24]])
def test_paged_decode_monotone(dtype, tol, pos):
    _paged_parity(_case(dtype=dtype), pos, window=0, tol=tol)


@pytest.mark.parametrize("pos", [[3, 17, 39], [40, 41, 57], [45, 80, 113]])
def test_paged_decode_window_ring(pos):
    _paged_parity(_case(), pos, window=12, tol=2e-5)


def test_paged_decode_i8():
    _paged_parity(_case(i8=True), [5, 19, 38], window=0, tol=2e-5)
    _paged_parity(_case(i8=True), [45, 80, 113], window=12, tol=2e-5)


@pytest.mark.parametrize("kv,g", [(1, 3), (1, 4), (2, 7)])
def test_paged_decode_gqa(kv, g):
    _paged_parity(_case(kv=kv, g=g), [2, 13, 31], window=0, tol=2e-5)


@pytest.mark.parametrize("b,w,bs,seed,ring", [(1, 1, 1, 0, False),
                                              (3, 4, 8, 1, False),
                                              (4, 2, 16, 2, True),
                                              (2, 3, 5, 3, True)])
def test_paged_decode_random_layouts(b, w, bs, seed, ring):
    rng = np.random.default_rng(seed)
    cap = w * bs
    case = _case(b=b, kv=1, g=2, dh=8, bs=bs, w=w, seed=seed)
    pos = rng.integers(0, 3 * cap if ring else cap, size=(b,))
    window = int(rng.integers(1, cap + 1)) if ring else 0
    _paged_parity(case, pos.tolist(), window=window, tol=2e-5)
