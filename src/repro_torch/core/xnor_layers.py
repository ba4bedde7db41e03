"""XNOR-Net binary layers.

  y = (sign(x) . sign(W)^T) * alpha_x * beta_w,
      alpha_x = mean|x| per input row,  beta_w = mean|W| per output channel.

``xnor_linear`` runs the float-domain path (the straight-through
estimator, which trains) or, with ``packed=True``, packs both operands and runs
the XNOR-popcount product (the ``xnor_gemm`` kernel on CUDA);
``xnor_linear_prepacked`` is the serve path over resident sign planes.  All
agree bit for bit in their sign semantics.
"""

from __future__ import annotations

import torch

from repro_torch.core import bitpack
from repro_torch.kernels import ops


class PackedLinear:
    """A binarized linear's resident serve form: sign planes + scale.

      pb    (..., N, Kw) int32 — sign planes of w.T, packed along K
      beta  (..., N)     f32   — mean|w| per output channel
      k     int                — the true K; the planes round K up to whole
                                 words, so dispatch checks the activation
                                 width against ``k`` with a raise.
    """

    __slots__ = ("pb", "beta", "k")

    def __init__(self, pb: torch.Tensor, beta: torch.Tensor, k: int):
        self.pb, self.beta, self.k = pb, beta, k

    def __getitem__(self, i) -> "PackedLinear":
        """Slice the leading (layer) axis."""
        return PackedLinear(self.pb[i], self.beta[i], self.k)

    def to(self, device) -> "PackedLinear":
        return PackedLinear(self.pb.to(device), self.beta.to(device), self.k)

    def __repr__(self):
        return (f"PackedLinear(pb={tuple(self.pb.shape)}, "
                f"beta={tuple(self.beta.shape)}, k={self.k})")


def binarize_ste(x: torch.Tensor) -> torch.Tensor:
    """sign(x) (sign(0) = +1) written as the reference's straight-through
    expression, so the forward rounds exactly as it does there."""
    s = torch.where(x >= 0, 1.0, -1.0).to(x.dtype)
    clip = (x.abs() <= 1.0).to(x.dtype)
    return x * clip + (s - x * clip).detach()


class _Abs(torch.autograd.Function):
    """|x| with the JAX package's derivative: +1 where x >= 0 (zeros
    included), -1 below.  ``torch.abs`` gives 0 at 0, and a binary
    layer's input is often exactly 0 (a popcount dot of +-1 terms can
    be), where alpha = mean |x| would then pass another gradient."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x.abs()

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


def _mean_abs(x: torch.Tensor) -> torch.Tensor:
    """:func:`bitpack.mean_abs` (the same bits) through :class:`_Abs`."""
    return _Abs.apply(x).float().sum(-1) * (1.0 / x.shape[-1])


def xnor_linear(x: torch.Tensor, w: torch.Tensor, *,
                packed: bool = False) -> torch.Tensor:
    """Binary linear: x (..., K) @ w (N, K)^T -> (..., N).

    ``packed`` packs both operands and runs the XNOR-popcount product in
    the bit domain (inference); otherwise the float-domain sign product."""
    n, k = w.shape
    if packed:
        beta = bitpack.mean_abs(w.contiguous()).to(w.dtype)  # (N,)
        lead = x.shape[:-1]
        x2 = x.reshape(-1, k)
        alpha = bitpack.mean_abs(x2).to(x.dtype)              # (M,)
        pa, _ = ops.binarize(x2)
        pb, _ = ops.binarize(w)
        dots = ops.xnor_matmul(pa, pb, k)                     # (M, N) int32
        y = dots.float() * alpha[:, None] * beta[None, :]
        return y.reshape(*lead, n).to(x.dtype)
    alpha = _mean_abs(x).to(x.dtype)[..., None]
    beta = _mean_abs(w.contiguous()).to(w.dtype)
    y = torch.einsum("...k,nk->...n", binarize_ste(x).float(),
                     binarize_ste(w).float())
    return (y * alpha * beta).to(x.dtype)


def xnor_linear_prepacked(x: torch.Tensor, pb: torch.Tensor,
                          beta: torch.Tensor, valid_k: int, *,
                          mode: str = "auto") -> torch.Tensor:
    """Inference over weights packed offline: ``pb`` (N, Kw), ``beta`` (N,).

    ``mode`` (:func:`ops.fused_mode`) picks the single-launch fused linear
    or the unfused binarize -> xnor_matmul -> scale chain (the pack and
    ``xnor_gemm`` kernels on CUDA).  Every step of the unfused chain is
    integer-exact or the same torch op on both paths, so on the card it is
    bitwise equal to its plain version."""
    lead, k = x.shape[:-1], x.shape[-1]
    if k != valid_k:
        raise ValueError(
            f"activation width {k} != packed weight's true K {valid_k}")
    x2 = x.reshape(-1, k)
    if ops.fused_mode(mode, x.device) == "kernel":
        y = ops.xnor_linear_fused(x2, pb, beta, valid_k)
        return y.reshape(*lead, pb.shape[0]).to(x.dtype)
    alpha = bitpack.mean_abs(x2).to(x.dtype)
    pa, _ = ops.binarize(x2)
    dots = ops.xnor_matmul(pa, pb, valid_k)
    y = dots.float() * alpha[:, None] * beta[None, :]
    return y.reshape(*lead, pb.shape[0]).to(x.dtype)


def pack_weights(w: torch.Tensor):
    """Offline packing: (N, K) float -> ((N, Kw) int32 planes, (N,) beta).

    beta is the pack's alpha rounded through ``w.dtype``: the reference's
    ``mean(|w|)`` in the weight's dtype, carried as f32."""
    pb, alpha = ops.binarize(w)
    return pb, alpha.to(w.dtype).float()


def pack_linear(w: torch.Tensor) -> PackedLinear:
    """Pack a (..., K, N) linear weight (columns are output channels).

    Leading (layer) axes are packed one matrix at a time, which keeps the
    transposed copy of a single layer as the only temporary."""
    if w.ndim < 2:
        raise ValueError(f"pack_linear needs a (..., K, N) matrix, got "
                         f"{tuple(w.shape)}")
    *lead, k, n = w.shape
    flat = w.reshape(-1, k, n)
    pbs, betas = [], []
    for i in range(flat.shape[0]):
        pb, beta = pack_weights(flat[i].t().contiguous())
        pbs.append(pb)
        betas.append(beta)
    pb = torch.stack(pbs).reshape(*lead, n, -1)
    beta = torch.stack(betas).reshape(*lead, n)
    return PackedLinear(pb, beta, k)
