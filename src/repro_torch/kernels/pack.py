"""Fused sign-extract + bit-pack + alpha: wrapper of ``csrc/pack.cu``.

Replaces ``repro/kernels/pack.py::pack``.  CPU tensors run the plain
version (:func:`repro_torch.kernels.ref.pack`); CUDA tensors launch the
kernel.
"""

from __future__ import annotations

import torch

from repro_torch.core import bitpack
from repro_torch.kernels import cuda, ref


def pack(x: torch.Tensor):
    """(M, K) f32/bf16 -> ((M, ceil(K/32)) int32 planes, (M,) f32 alpha).

    Planes are the LSB-first sign bits (elements past K pack as bit 1);
    alpha = mean|x| over the true K.  The kernel keeps alpha in f32; the
    plain version rounds it through ``x.dtype`` as the reference does.
    """
    cuda.check(x.ndim == 2, f"pack needs (M, K), got {tuple(x.shape)}")
    if not cuda.use_kernel(x):
        return ref.pack(x)
    cuda.check(x.dtype in (torch.float32, torch.bfloat16),
               f"pack takes f32/bf16, got {x.dtype}")
    cuda.check(x.is_contiguous(), "pack needs a contiguous x")
    m, k = x.shape
    kw = bitpack.packed_width(k)
    planes = torch.empty((m, kw), dtype=torch.int32, device=x.device)
    alpha = torch.empty((m,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        cuda.launch("xnor_pack", x.data_ptr(), cuda.DTYPE_CODES[x.dtype],
                    planes.data_ptr(), alpha.data_ptr(), m, k, kw,
                    cuda.stream(x))
    pack.launches += 1
    return planes, alpha


pack.launches = 0
