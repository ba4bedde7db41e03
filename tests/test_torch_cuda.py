"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``cuda`` and skipped where ``torch.cuda.is_available()`` is
false (a CUDA kernel has no CPU mode); this file imports neither JAX nor
the reference package, so it runs on a machine with only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: bitwise for sign planes and for ±1 activations (alpha = 1
exactly); 2e-5 for f32; for bf16 activations 2^-8 relative, because the
kernels keep alpha in f32 while the plain versions round it through bf16
(half an ulp, 2^-9 relative); attention at the reference suite's f32 2e-5
and bf16 3e-2.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import xnor_layers
from repro_torch.kernels import cuda
from repro_torch.kernels import pack as kpack
from repro_torch.kernels import paged_attn as kpaged
from repro_torch.kernels import xnor_gemm as kxnor


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


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(4, 3584, 512), (32, 18944, 256),
                                   (5, 70, 9)])
def test_cuda_xnor_linear_fused(gpu, m, k, n):
    w = torch.randn((n, k), device=gpu)
    pb, beta = xnor_layers.pack_weights(w)
    pm1 = torch.where(torch.randn((m, k), device=gpu) >= 0, 1.0, -1.0)
    kk, pp = _kernel_and_plain(kxnor.xnor_linear_fused, pm1, pb, beta, k)
    assert torch.equal(kk, pp)              # alpha = 1 exactly: exact dots
    x = torch.randn((m, k), device=gpu)
    kk, pp = _kernel_and_plain(kxnor.xnor_linear_fused, x, pb, beta, k)
    torch.testing.assert_close(kk, pp, rtol=2e-5, atol=2e-5)
    # bf16: the kernel's alpha is f32, the plain one is rounded to bf16 —
    # a relative difference of at most 2^-9 in every output
    xb = x.to(torch.bfloat16)
    kk, pp = _kernel_and_plain(kxnor.xnor_linear_fused, xb, pb, beta, k)
    torch.testing.assert_close(kk, pp, rtol=2 ** -8, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,i8,tol", [("f32", False, 2e-5),
                                          ("bf16", False, 3e-2),
                                          ("bf16", True, 3e-2),
                                          ("f32", True, 2e-5)])
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
    torch.testing.assert_close(kk.float(), pp.float(), rtol=tol, atol=tol)
