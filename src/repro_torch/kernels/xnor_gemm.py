"""XNOR-popcount products: wrappers of ``csrc/xnor_gemm.cu`` and
``csrc/xnor_linear.cu``.

:func:`xnor_gemm` replaces ``repro/kernels/xnor_gemm.py::xnor_gemm`` (the
packed (M, Kw) x (N, Kw) product of the unfused chain);
:func:`xnor_linear_fused` replaces ``xnor_linear_fused`` there (binarize,
product and scales in one launch, the serving path).  CPU tensors run the
plain versions of :mod:`repro_torch.kernels.ref`; CUDA tensors launch the
kernels.
"""

from __future__ import annotations

import torch

from repro_torch.core import bitpack
from repro_torch.kernels import cuda, ref


def xnor_gemm(pa: torch.Tensor, pb: torch.Tensor,
              valid_k: int) -> torch.Tensor:
    """(M, Kw) x (N, Kw) int32 planes -> (M, N) int32 ``valid_k - 2*popc``.

    The kernel walks the true Kw words and masks ragged M, N and Kw
    itself: no operand is padded or copied."""
    cuda.check(pa.ndim == 2 and pb.ndim == 2 and pa.shape[1] == pb.shape[1],
               f"xnor_gemm needs (M, Kw) x (N, Kw), got {tuple(pa.shape)} "
               f"x {tuple(pb.shape)}")
    if not cuda.use_kernel(pa, pb):
        return ref.xnor_gemm(pa, pb, valid_k)
    cuda.check(pa.dtype == torch.int32 and pb.dtype == torch.int32,
               f"planes must be int32 words, got {pa.dtype}/{pb.dtype}")
    cuda.check(pa.is_contiguous() and pb.is_contiguous(),
               "xnor_gemm needs contiguous planes")
    m, kw = pa.shape
    n = pb.shape[0]
    cuda.check(8 * kw * 4 <= 227 * 1024 and -(-m // 8) <= 65535,
               f"xnor_gemm takes Kw <= 7264 and M <= 524280, got Kw={kw}, "
               f"M={m}")
    out = torch.empty((m, n), dtype=torch.int32, device=pa.device)
    if m == 0 or n == 0:
        return out
    with torch.cuda.device(pa.device):
        cuda.launch("xnor_gemm", pa.data_ptr(), pb.data_ptr(),
                    out.data_ptr(), m, n, kw, valid_k, cuda.stream(pa))
    xnor_gemm.launches += 1
    return out


xnor_gemm.launches = 0


def xnor_linear_fused(x: torch.Tensor, pb: torch.Tensor, beta: torch.Tensor,
                      valid_k: int) -> torch.Tensor:
    """(M, K) float x (N, Kw) int32 planes, (N,) f32 beta -> (M, N) f32.

    ``K == valid_k`` is the true width (no host-side pad: the kernel packs
    elements past K as bit 1, matching the planes' tail bits)."""
    cuda.check(x.ndim == 2 and pb.ndim == 2 and beta.ndim == 1,
               f"shapes {tuple(x.shape)}, {tuple(pb.shape)}, "
               f"{tuple(beta.shape)}")
    m, k = x.shape
    n, kw = pb.shape
    cuda.check(k == valid_k, f"activation width {k} != valid_k {valid_k}")
    cuda.check(kw == bitpack.packed_width(k),
               f"planes hold {kw} words, K={k} needs "
               f"{bitpack.packed_width(k)}")
    cuda.check(beta.shape[0] == n, f"beta {beta.shape[0]} != N {n}")
    if not cuda.use_kernel(x, pb, beta):
        return ref.xnor_linear_fused(x, pb, beta, valid_k)
    cuda.check(x.dtype in (torch.float32, torch.bfloat16),
               f"x must be f32/bf16, got {x.dtype}")
    cuda.check(pb.dtype == torch.int32 and beta.dtype == torch.float32,
               f"pb must be int32 and beta f32, got {pb.dtype}/{beta.dtype}")
    cuda.check(x.is_contiguous() and pb.is_contiguous()
               and beta.is_contiguous(), "xnor_linear_fused needs contiguous "
               "operands")
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        cuda.launch("xnor_linear_fused", x.data_ptr(),
                    cuda.DTYPE_CODES[x.dtype], pb.data_ptr(),
                    beta.data_ptr(), out.data_ptr(), m, k, kw, n,
                    cuda.stream(x))
    xnor_linear_fused.launches += 1
    return out


xnor_linear_fused.launches = 0
