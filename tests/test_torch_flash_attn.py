"""Flash attention of the port against the JAX reference, on the CPU.

The grid of ``tests/test_flash_attn.py``: (BH, S, dh) in {(2, 64, 16),
(1, 128, 32), (3, 256, 8)} x causal or full at bq = bk = 32, block shapes
(16, 64), (64, 16) and (128, 32), and bf16.  The same numpy inputs go to
the JAX kernel in interpret mode and to the port's ``flash_attention``
(CPU tensors take its tiled plain version), and to both packages'
one-shot ``flash_attention_ref``.  Tolerances are the JAX suite's own:
2e-5 in f32, 3e-2 in bf16.  The online-softmax helpers are held against
the reference's at 1e-6 (the reference's helpers write into numpy arrays
standing in for refs).
"""

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import flash_attn as jflash
from repro.kernels import online_softmax as josm
from repro_torch.kernels import flash_attn, online_softmax
from repro_torch.kernels.flash_attn import flash_attention


def _mk(bh, s, dh, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((bh, s, dh)).astype(np.float32)
            for _ in range(3)]


def _t(arrs):
    return [torch.from_numpy(a.copy()) for a in arrs]


@pytest.mark.parametrize("bh,s,dh", [(2, 64, 16), (1, 128, 32), (3, 256, 8)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_matches_reference_kernel_and_oracle(bh, s, dh, causal):
    qkv = _mk(bh, s, dh)
    want = np.asarray(jflash.flash_attention(*qkv, causal=causal, bq=32,
                                             bk=32, interpret=True))
    got = flash_attention(*_t(qkv), causal=causal, bq=32, bk=32)
    assert got.dtype == torch.float32 and got.shape == (bh, s, dh)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    oracle = np.asarray(jflash.flash_attention_ref(*qkv, causal))
    ref = flash_attn.flash_attention_ref(*_t(qkv), causal)
    np.testing.assert_allclose(ref.numpy(), oracle, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("bq,bk", [(16, 64), (64, 16), (128, 32)])
def test_flash_block_shapes(bq, bk):
    qkv = _mk(2, 128, 16, seed=1)
    want = np.asarray(jflash.flash_attention(*qkv, causal=True, bq=bq, bk=bk,
                                             interpret=True))
    got = flash_attention(*_t(qkv), causal=True, bq=bq, bk=bk)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    oracle = np.asarray(jflash.flash_attention_ref(*qkv, True))
    np.testing.assert_allclose(got.numpy(), oracle, rtol=2e-5, atol=2e-5)


def test_flash_bf16():
    qkv = [a.astype(ml_dtypes.bfloat16) for a in _mk(2, 64, 16, seed=2)]
    tq = [torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
          for a in qkv]
    want = np.asarray(jflash.flash_attention(*qkv, causal=True, bq=32, bk=32,
                                             interpret=True), np.float32)
    got = flash_attention(*tq, causal=True, bq=32, bk=32)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=3e-2,
                               atol=3e-2)
    oracle = np.asarray(jflash.flash_attention_ref(*qkv, True), np.float32)
    ref = flash_attn.flash_attention_ref(*tq, True)
    assert ref.dtype == torch.bfloat16
    np.testing.assert_allclose(ref.float().numpy(), oracle, rtol=3e-2,
                               atol=3e-2)


@pytest.mark.parametrize("bq,bk", [(24, 32), (32, 48), (0, 32)])
def test_flash_rejects_tiles_that_do_not_divide_s(bq, bk):
    q, k, v = _t(_mk(1, 64, 8))
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(q, k, v, bq=bq, bk=bk)


def test_flash_rejects_mixed_dtypes_and_shapes():
    q, k, v = _t(_mk(1, 64, 8))
    with pytest.raises(ValueError, match="f32 or all bf16"):
        flash_attention(q, k.to(torch.bfloat16), v, bq=32, bk=32)
    with pytest.raises(ValueError, match="shape"):
        flash_attention(q, k[:, :32], v, bq=32, bk=32)


def test_online_softmax_matches_reference_helpers():
    rng = np.random.default_rng(3)
    rows, bk, dh = 8, 16, 12
    m_ref = np.zeros((rows, 1), np.float32)
    l_ref = np.zeros((rows, 1), np.float32)
    acc_ref = np.zeros((rows, dh), np.float32)
    josm.init(m_ref, l_ref, acc_ref)
    m, l, acc = online_softmax.init((rows,), dh)
    assert np.array_equal(m.numpy(), m_ref)
    for tile in range(3):
        s = (rng.standard_normal((rows, bk)) * 3).astype(np.float32)
        s[:, ::5] = josm.NEG_INF                    # masked keys
        v = rng.standard_normal((bk, dh)).astype(np.float32)
        josm.update(s, v, m_ref, l_ref, acc_ref)
        m, l, acc = online_softmax.update(torch.from_numpy(s),
                                          torch.from_numpy(v), m, l, acc)
        for got, want in ((m, m_ref), (l, l_ref), (acc, acc_ref)):
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                       atol=1e-6)
    np.testing.assert_allclose(
        online_softmax.finish(m, l, acc).numpy(),
        np.asarray(josm.finish(m_ref, l_ref, acc_ref)), rtol=1e-6, atol=1e-6)
    assert online_softmax.NEG_INF == josm.NEG_INF == flash_attn.NEG_INF
