"""Fused prepacked XNOR linear: wrapper of ``csrc/xnor_linear.cu``.

Replaces ``repro/kernels/xnor_gemm.py::xnor_linear_fused``.  The unfused
``xnor_gemm`` kernel is not ported yet; its plain version lives in
:mod:`repro_torch.kernels.ref`.
"""

from __future__ import annotations

import torch

from repro_torch.core import bitpack
from repro_torch.kernels import cuda, ref


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
