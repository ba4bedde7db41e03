"""Griffin's recurrent mixer (RecurrentGemma): the causal depthwise conv1d
and the RG-LRU, in plain PyTorch.

The JAX package computes these outside any Pallas kernel, so plain
PyTorch is their port on every device.  Each function keeps the numeric
form the reference has for it, not one shared form: the sequence RG-LRU
takes ``sqrt(max(1 - exp(2 log_a), 1e-12))``, the step
``sqrt(max(1 - a a, 1e-12))``; :func:`conv1d` and :func:`conv1d_carry`
sum in ``x.dtype``, :func:`conv1d_step` in f32.  The sequence RG-LRU
combines its elements in the reference's associative-scan order (the
odd/even recursion of ``jax.lax.associative_scan``).  The RG-LRU state
is f32.

The jitted reference reads the conv's output in two roundings: its
linears take the ``x.dtype`` sum, its RG-LRU (which casts to f32) the sum
with the last add unrounded (XLA drops a bf16 rounding that an f32 cast
reads right away).  So :func:`conv1d` and :func:`conv1d_carry` return
that f32 sum; rounded to ``x.dtype`` it is the reference's conv1d.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

F32 = torch.float32


# ---------------------------------------------------------------------------
# causal depthwise conv1d
# ---------------------------------------------------------------------------

def _taps(xp: torch.Tensor, kernel: torch.Tensor, s: int) -> torch.Tensor:
    """sum_i xp[:, i:i+s] * kernel[w-1-i], left to right, each product and
    each add but the last rounded to xp's dtype -> f32."""
    w = kernel.shape[0]
    k = kernel.to(xp.dtype)
    y = xp[:, 0:s] * k[w - 1]
    for i in range(1, w - 1):
        y = y + xp[:, i:i + s] * k[w - 1 - i]
    if w == 1:
        return y.float()
    return y.float() + (xp[:, w - 1:w - 1 + s] * k[0]).float()


def conv1d(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """x (B, S, D), kernel (W, D) depthwise causal:
    y_t = sum_w kernel[w] x_{t-w}, zeros before the sequence; f32, its
    last add unrounded (``.to(x.dtype)`` is the reference's result)."""
    w = kernel.shape[0]
    xp = torch.nn.functional.pad(x, (0, 0, w - 1, 0))
    return _taps(xp, kernel, x.shape[1])


def conv1d_carry(buf: torch.Tensor, x: torch.Tensor,
                 kernel: torch.Tensor) -> torch.Tensor:
    """Chunked-prefill form: the left context is the (B, W-1, D) carry
    buffer of the previous chunk instead of zeros (f32 as
    :func:`conv1d`)."""
    xp = torch.cat([buf.to(x.dtype), x], dim=1)
    return _taps(xp, kernel, x.shape[1])


def conv1d_carry_out(buf: torch.Tensor, x: torch.Tensor,
                     valid_len: int) -> torch.Tensor:
    """The carry after a chunk: the last W-1 *valid* inputs (with
    ``valid_len`` < W-1 the old buffer's tail is kept; padding never enters
    the history)."""
    w1 = buf.shape[1]
    hist = torch.cat([buf.to(x.dtype), x], dim=1)
    return hist[:, valid_len:valid_len + w1]


def conv1d_step(buf: torch.Tensor, x: torch.Tensor, kernel: torch.Tensor):
    """Decode step: buf (B, W-1, D) the previous inputs, x (B, 1, D).
    Sums the W taps in f32 and rounds once -> (y (B, 1, D), new buf)."""
    hist = torch.cat([buf, x], dim=1)                       # (B, W, D)
    y = torch.einsum("bwd,wd->bd", hist.to(F32), kernel.flip(0).to(F32))
    return y[:, None].to(x.dtype), hist[:, 1:]


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

class RGLRUState(NamedTuple):
    h: torch.Tensor   # (B, D) f32

    @classmethod
    def zeros(cls, b: int, d: int, device) -> "RGLRUState":
        return cls(torch.zeros((b, d), dtype=F32, device=device))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def _log_a(lam: torch.Tensor, r_gate: torch.Tensor, c: float):
    return (-c * _softplus(lam.to(F32))) * torch.sigmoid(r_gate.to(F32))


def _combine(left, right):
    a1, b1 = left
    a2, b2 = right
    return a1 * a2, a2 * b1 + b2


def _interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Along axis 1: a0, b0, a1, b1, ... (a may be one longer than b)."""
    n = a.shape[1] + b.shape[1]
    out = a.new_empty((a.shape[0], n) + tuple(a.shape[2:]))
    out[:, 0::2] = a
    out[:, 1::2] = b
    return out


def _assoc_scan(elems):
    """``jax.lax.associative_scan(_combine, elems, axis=1)`` in its
    combine order: pairs reduced, the half scanned recursively, the even
    elements combined from the odd results."""
    n = elems[0].shape[1]
    if n < 2:
        return elems
    reduced = _combine([e[:, 0:n - 1:2] for e in elems],
                       [e[:, 1::2] for e in elems])
    odd = _assoc_scan(list(reduced))
    if n % 2 == 0:
        even = _combine([e[:, :-1] for e in odd],
                        [e[:, 2::2] for e in elems])
    else:
        even = _combine(odd, [e[:, 2::2] for e in elems])
    even = [torch.cat([e[:, :1], r], dim=1) for e, r in zip(elems, even)]
    return [_interleave(e, o) for e, o in zip(even, odd)]


def rglru(x: torch.Tensor, r_gate: torch.Tensor, i_gate: torch.Tensor,
          lam: torch.Tensor, c: float, state: RGLRUState,
          valid: torch.Tensor | None = None):
    """Sequence form: x, r_gate, i_gate (B, S, D) (gates pre-sigmoid), lam
    (D,) raw Lambda.  h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t x_t),
    a_t = exp(-c softplus(lam) sigmoid(r_t)).  ``valid`` (B, S) bool makes
    padding steps the identity (a = 1, b = 0), so a ragged chunk's final
    state is the unpadded one.  x may be f32 where the gates are not (the
    conv's unrounded sum).  -> (h (B, S, D) in the gates' dtype, the
    model's; new state)."""
    log_a = _log_a(lam, r_gate, c)                          # (B, S, D)
    gated = torch.sigmoid(i_gate.to(F32)) * x.to(F32)
    if valid is not None:
        keep = valid[..., None]
        log_a = torch.where(keep, log_a, 0.0)
        gated = torch.where(keep, gated, 0.0)
    a = torch.exp(log_a)
    b_t = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a),
                                 min=1e-12)) * gated
    a_all = torch.cat([torch.ones_like(state.h[:, None]), a], dim=1)
    b_all = torch.cat([state.h[:, None], b_t], dim=1)
    _, h_all = _assoc_scan([a_all, b_all])
    return h_all[:, 1:].to(r_gate.dtype), RGLRUState(h_all[:, -1])


def rglru_step(x: torch.Tensor, r_gate: torch.Tensor, i_gate: torch.Tensor,
               lam: torch.Tensor, c: float, state: RGLRUState):
    """One decode token: x, r_gate, i_gate (B, 1, D)."""
    a = torch.exp(_log_a(lam, r_gate[:, 0], c))
    gated = torch.sigmoid(i_gate[:, 0].to(F32)) * x[:, 0].to(F32)
    h = a * state.h + torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * gated
    return h[:, None].to(x.dtype), RGLRUState(h)
