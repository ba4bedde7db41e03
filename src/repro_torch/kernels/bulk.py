"""Bulk XOR / XNOR of word buffers: wrapper of ``csrc/bulk.cu``.

Replaces ``repro/kernels/bulk.py::bulk_xor``.  CPU tensors run the plain
version (:func:`repro_torch.kernels.ref.bulk_xor`); CUDA tensors launch
the kernel.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import cuda, ref


def bulk_xor(a: torch.Tensor, b: torch.Tensor,
             invert: bool = False) -> torch.Tensor:
    """Elementwise XOR (XNOR with ``invert``) of two flat int32 word
    buffers of any length -> a new (n,) int32 buffer.

    On the card the new buffer starts at ``a``'s offset mod 16 bytes when
    ``b`` shares it, so views such as ``a[1:]`` take the kernel's 16-byte
    path too."""
    cuda.check(a.ndim == 1 and a.shape == b.shape,
               f"bulk_xor needs two (n,) buffers, got {tuple(a.shape)} and "
               f"{tuple(b.shape)}")
    if not cuda.use_kernel(a, b):
        return ref.bulk_xor(a, b, invert)
    cuda.check(a.dtype == torch.int32 and b.dtype == torch.int32,
               f"bulk_xor takes int32 words, got {a.dtype}/{b.dtype}")
    cuda.check(a.is_contiguous() and b.is_contiguous(),
               "bulk_xor needs contiguous buffers")
    n = a.numel()
    if n == 0:
        return torch.empty_like(a)
    off = a.data_ptr() % 16 // 4
    if off and b.data_ptr() % 16 == a.data_ptr() % 16:
        out = torch.empty(n + 3, dtype=a.dtype, device=a.device)
        out = out[(off - out.data_ptr() % 16 // 4) % 4:][:n]
    else:
        out = torch.empty_like(a)
    with torch.cuda.device(a.device):
        cuda.launch("bulk_xor", a.data_ptr(), b.data_ptr(), out.data_ptr(),
                    n, int(invert), cuda.stream(a))
    bulk_xor.launches += 1
    return out


bulk_xor.launches = 0
