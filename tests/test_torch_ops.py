"""The port's integer op layer against the JAX reference, on the CPU.

``xnor_matmul``, ``bulk_op``, ``digest`` and ``stream_cipher`` of
``repro_torch.kernels.ops`` (their plain versions, which CPU tensors take)
against ``repro.kernels.ops`` run as the reference's own tests run it:
``impl="interpret"`` (the Pallas body, interpreted) and ``impl="ref"``
(the oracle).  Inputs are uint32 words made with numpy from a seed;
everything is compared bitwise.  Also the byte layout (``as_words`` /
``host_words``) and ``unpack_bits``.

The CUDA kernels are held against these plain versions on the card by
``tests/test_torch_cuda.py``.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import bitpack as jbitpack
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import convert
from repro_torch.core import bitpack
from repro_torch.kernels import bulk, cipher, ops, parity, ref
from repro_torch.kernels import xnor_gemm as kxnor

LENGTHS = [1, 127, 128, 129, 128 * 512 + 3]
COUNTERS = [0, 12345, 2 ** 32 - 5]
KEY = (0x9E3779B9, 0x0BADF00D)


def _words(n, seed):
    return np.random.default_rng(seed).integers(0, 2 ** 32, size=n,
                                                dtype=np.uint32)


def _t(w: np.ndarray) -> torch.Tensor:
    return bitpack.from_numpy_u32(w)


def _u(t: torch.Tensor) -> np.ndarray:
    return bitpack.to_numpy_u32(t)


def _impls(n):
    """The reference's Pallas body is interpreted at the short lengths
    only: the long one runs its oracle."""
    return ("ref", "interpret") if n < 1000 else ("ref",)


# ---------------------------------------------------------------------------
# xnor_matmul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,n,kw,valid_k", [
    (5, 9, 3, 70),          # ragged M, N, Kw; K not a word multiple
    (64, 32, 8, 256),       # quickstart's shapes
    (4, 37, 7, 200),        # decode-sized M, odd Kw
    (17, 3, 1, 1),          # one bit
])
def test_xnor_matmul_bitwise(m, n, kw, valid_k):
    rng = np.random.default_rng(m * 100 + n)
    k = kw * 32
    xa = rng.standard_normal((m, valid_k)).astype(np.float32)
    xb = rng.standard_normal((n, valid_k)).astype(np.float32)
    pa = np.asarray(jbitpack.pack_bits(jbitpack.pad_to_word(jnp.asarray(xa))))
    pb = np.asarray(jbitpack.pack_bits(jbitpack.pad_to_word(jnp.asarray(xb))))
    assert pa.shape == (m, kw) and k >= valid_k
    got = ops.xnor_matmul(_t(pa), _t(pb), valid_k)
    assert got.dtype == torch.int32 and got.shape == (m, n)
    for impl in ("ref", "interpret"):
        want = np.asarray(jops.xnor_matmul(jnp.asarray(pa), jnp.asarray(pb),
                                           valid_k, impl=impl))
        assert np.array_equal(got.numpy(), want), impl
    # and the float-domain truth
    sa, sb = np.where(xa >= 0, 1, -1), np.where(xb >= 0, 1, -1)
    assert np.array_equal(got.numpy(), sa @ sb.T)


def test_xnor_gemm_wrapper_checks_shapes():
    with pytest.raises(ValueError):
        kxnor.xnor_gemm(torch.zeros((2, 3), dtype=torch.int32),
                        torch.zeros((2, 4), dtype=torch.int32), 96)


# ---------------------------------------------------------------------------
# bulk_op / digest / stream_cipher at ragged lengths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("op", ["xor", "xnor"])
def test_bulk_op_bitwise(n, op):
    a, b = _words(n, 1), _words(n, 2)
    got = _u(ops.bulk_op(_t(a), _t(b), op))
    for impl in _impls(n):
        want = np.asarray(jops.bulk_op(jnp.asarray(a), jnp.asarray(b), op,
                                       impl=impl))
        assert np.array_equal(got, want), impl


def test_bulk_op_rejects_what_the_reference_rejects():
    a = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        ops.bulk_op(a, a, "and")
    with pytest.raises(TypeError):
        ops.bulk_op(a.float(), a.float())
    with pytest.raises(ValueError):
        ops.bulk_op(a, torch.zeros(5, dtype=torch.int32))


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("width", [64, 96, 128, 256])
def test_digest_bitwise(n, width):
    w = _words(n, 3)
    got = _u(ops.digest(_t(w), width))
    assert got.shape == (width,)
    for impl in _impls(n):
        want = np.asarray(jops.digest(jnp.asarray(w), width, impl=impl))
        assert np.array_equal(got, want), impl


def test_digest_one_bit_flip_moves_one_bit():
    w = _words(128 * 512 + 3, 4)
    d0 = _u(ops.digest(_t(w)))
    w[40000] ^= 1 << 17
    d1 = _u(ops.digest(_t(w)))
    diff = np.unpackbits((d0 ^ d1).view(np.uint8))
    assert diff.sum() == 1


def test_parity_chunks_equal_slice_digests():
    w = _words(5 * 256 + 77, 5)
    rows = _u(ops.digest_chunks(_t(w), 256, 128))
    assert rows.shape == (6, 128)
    for i in range(6):
        want = np.asarray(jops.digest(jnp.asarray(w[i * 256:(i + 1) * 256]),
                                      128, impl="ref"))
        assert np.array_equal(rows[i], want), i
    assert np.array_equal(np.bitwise_xor.reduce(rows, axis=0),
                          _u(ops.digest(_t(w))))
    with pytest.raises(ValueError):          # chunks must be whole rows
        parity.parity_digest(_t(w), 128, 200)


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("counter", COUNTERS)
def test_stream_cipher_bitwise(n, counter):
    w = _words(n, 6)
    got = ops.stream_cipher(_t(w), KEY, counter)
    key = jnp.asarray(KEY, jnp.uint32)
    for impl in _impls(n):
        want = np.asarray(jops.stream_cipher(jnp.asarray(w), key, counter,
                                             impl=impl))
        assert np.array_equal(_u(got), want), impl
    assert np.array_equal(_u(ops.stream_cipher(got, KEY, counter)), w)


def test_keystream_wraps_like_the_reference():
    idx = np.array([0, 1, 2 ** 31, 2 ** 32 - 2, 2 ** 32 - 1], np.uint32)
    want = np.asarray(jref.keystream_word(jnp.asarray(idx), jnp.uint32(KEY[0]),
                                          jnp.uint32(KEY[1])))
    got = ref.keystream_word(torch.from_numpy(idx.astype(np.int64)), *KEY)
    assert np.array_equal(got.numpy().astype(np.uint32), want)
    with pytest.raises(ValueError):
        cipher.xor_cipher(torch.zeros(3, dtype=torch.int32), 0, 0, 2 ** 32)


def test_wrappers_take_any_length_without_padding():
    a, b = _t(_words(129, 7)), _t(_words(129, 8))
    assert bulk.bulk_xor(a, b).shape == (129,)
    assert parity.parity_digest(a, 128, 128).shape == (2, 128)
    assert cipher.xor_cipher(a, *KEY, 5).shape == (129,)


# ---------------------------------------------------------------------------
# byte layout
# ---------------------------------------------------------------------------

def _arrays():
    rng = np.random.default_rng(9)
    return {
        "f32": rng.standard_normal(9).astype(np.float32),
        "bf16_odd": rng.standard_normal(7).astype(ml_dtypes.bfloat16),
        "f16_odd": rng.standard_normal(5).astype(np.float16),
        "f16_even": rng.standard_normal((3, 4)).astype(np.float16),
        "i8_6": rng.integers(-128, 128, 6).astype(np.int8),
        "u8_7": rng.integers(0, 256, 7).astype(np.uint8),
        "i64": rng.integers(-2 ** 62, 2 ** 62, 5),
        "f64": rng.standard_normal((2, 3)),
        "bool_5": rng.integers(0, 2, 5).astype(bool),
    }


@pytest.mark.parametrize("name", sorted(_arrays()))
def test_as_words_and_host_words_match_reference(name):
    arr = _arrays()[name]
    want, nbytes = jops.host_words(arr)
    got, got_n = ops.host_words(arr)
    assert nbytes == got_n and np.array_equal(got, want)
    t = convert.from_numpy({"a": arr})["a"]
    assert np.array_equal(_u(ops.as_words(t)), want)
    assert np.array_equal(_u(ops.as_words(arr)), want)
    if arr.dtype.itemsize <= 4 and name != "bool_5":
        # the device bitcast of the reference gives the same stream
        dev = np.asarray(jops.as_words(jnp.asarray(arr)))
        assert np.array_equal(dev, want)


def test_as_words_is_a_view_where_the_bytes_allow():
    x = torch.arange(8, dtype=torch.bfloat16)
    w = ops.as_words(x)
    assert w.data_ptr() == x.data_ptr() and w.shape == (4,)
    x[0] = 5.0
    assert _u(w)[0] & 0xFFFF == int(torch.tensor([5.0], dtype=torch.bfloat16)
                                     .view(torch.int16).item())
    # an odd start (a slice of 2-byte elements) is copied, not refused
    assert np.array_equal(_u(ops.as_words(x[1:5])),
                          ops.host_words(x[1:5].view(torch.int16).numpy())[0])


# ---------------------------------------------------------------------------
# unpack_bits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [32, 45, 96])
@pytest.mark.parametrize("signed", [True, False])
def test_unpack_bits_round_trip(k, signed):
    rng = np.random.default_rng(k)
    x = rng.standard_normal((3, k)).astype(np.float32)
    planes = bitpack.pack_bits(bitpack.pad_to_word(torch.from_numpy(x)))
    got = bitpack.unpack_bits(planes, k, signed=signed)
    want = np.asarray(jbitpack.unpack_bits(jnp.asarray(_u(planes)), k,
                                           signed=signed))
    assert np.array_equal(got.numpy(), want)
    if signed:
        assert np.array_equal(got.numpy(), np.where(x >= 0, 1.0, -1.0))
        assert torch.equal(bitpack.pack_bits(bitpack.pad_to_word(got)),
                           planes)
