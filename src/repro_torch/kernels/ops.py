"""Public ops: shape handling around the kernels, dispatch by device.

Every op runs its CUDA kernel on CUDA tensors and its plain PyTorch version
(:mod:`repro_torch.kernels.ref`) on CPU tensors; the wrappers in
``pack.py``, ``xnor_gemm.py`` and ``paged_attn.py`` make that choice from
the tensor's device alone.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import cuda, ref
from repro_torch.kernels import pack as _pack
from repro_torch.kernels import xnor_gemm as _xnor_gemm


def fused_mode(mode: str = "auto") -> str:
    """Resolve the decode-path fusion setting to ``"kernel"`` or ``"ref"``.

    ``"kernel"`` routes the binarized linears and decode attention through
    the fused ops (kernels on CUDA, their plain versions on the CPU);
    ``"ref"`` keeps the unfused chain, which on CUDA needs the ``xnor_gemm``
    kernel this port does not have yet (:func:`xnor_matmul` raises there).
    """
    if mode in ("auto", "on", "kernel", "fused"):
        return "kernel"
    if mode in ("off", "ref", "unfused"):
        return "ref"
    raise ValueError(f"unknown fused-decode mode {mode!r}; expected "
                     "auto|on|kernel|fused|off|ref|unfused")


def binarize(x: torch.Tensor):
    """(..., K) float -> ((..., Kw) int32 planes, (...,) f32 alpha)."""
    lead, k = x.shape[:-1], x.shape[-1]
    planes, alpha = _pack.pack(x.reshape(-1, k).contiguous())
    return planes.reshape(*lead, -1), alpha.reshape(lead)


def xnor_matmul(pa: torch.Tensor, pb: torch.Tensor,
                valid_k: int) -> torch.Tensor:
    """±1 dot in the packed domain: (M, Kw) x (N, Kw) -> (M, N) int32."""
    if cuda.use_kernel(pa, pb):
        raise NotImplementedError(
            "the xnor_gemm kernel is not ported yet: use the fused path "
            "(fused_decode='auto') on CUDA")
    return ref.xnor_gemm(pa, pb, valid_k)


def xnor_linear_fused(x: torch.Tensor, pb: torch.Tensor, beta: torch.Tensor,
                      valid_k: int) -> torch.Tensor:
    """Single-launch packed linear: (M, K) x (N, Kw) planes -> (M, N) f32."""
    return _xnor_gemm.xnor_linear_fused(x.contiguous(), pb, beta, valid_k)
