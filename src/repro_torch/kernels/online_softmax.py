"""The online-softmax (m, l, acc) accumulator of the fused attention
kernels, as plain functions on f32 tensors.

One streaming pass over key tiles keeps, per query row,

  m    the running max of the masked scores seen so far,
  l    the running sum of exp(score - m),
  acc  the running sum of exp(score - m) @ V,

with the correction ``exp(m_prev - m_new)`` rescaling the stale l and acc
whenever a tile raises the max.  :func:`merge` combines the states of
disjoint key ranges (the split table walk of ``csrc/paged_attn.cu``).
:func:`finish` normalises; ``acc / l``
equals masked softmax(scores) @ V in real arithmetic, and differs from the
one-shot softmax only in rounding.

Together these make the tiled plain version of
:func:`repro_torch.kernels.flash_attn.flash_attention` — the recurrence the
JAX kernel runs in interpret mode.  The CUDA kernels (``csrc/flash_attn.cu``,
``csrc/paged_attn.cu``) carry the same recurrence as device code.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30   # masking constant shared with models/attention.py


def init(rows: tuple, dh: int, device=None):
    """(m, l, acc) for a fresh query block: m (*rows, 1) at NEG_INF, l
    (*rows, 1) and acc (*rows, dh) at zero, all f32."""
    m = torch.full((*rows, 1), NEG_INF, dtype=torch.float32, device=device)
    l = torch.zeros((*rows, 1), dtype=torch.float32, device=device)
    acc = torch.zeros((*rows, dh), dtype=torch.float32, device=device)
    return m, l, acc


def update(s: torch.Tensor, v: torch.Tensor, m: torch.Tensor,
           l: torch.Tensor, acc: torch.Tensor):
    """Fold one masked score tile ``s`` (..., rows, bk) f32 and its value
    tile ``v`` (..., bk, dh) f32 into (m, l, acc); returns the new triple.

    Masked scores must already be ``NEG_INF``.  A tile whose rows are all
    masked must be skipped by the caller: ``exp(NEG_INF - NEG_INF) == 1``
    would poison l and acc while m still holds its initial value."""
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    p = torch.exp(s - m_new)
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1, keepdim=True)
    acc = acc * corr + torch.matmul(p, v)
    return m_new, l, acc


def merge(parts):
    """Combine partial states ``[(m, l, acc), ...]`` of disjoint key ranges
    into the state of their union: ``M = max m_i``, and each part weighs
    ``exp(m_i - M)``.  A part that saw no live key (``init``'s m = NEG_INF,
    l = 0, acc = 0) weighs nothing once any part has one; with none, the
    result is ``init``'s state again."""
    ms = torch.stack([p[0] for p in parts])
    m = ms.amax(dim=0)
    wgt = torch.exp(ms - m)
    l = (torch.stack([p[1] for p in parts]) * wgt).sum(dim=0)
    acc = (torch.stack([p[2] for p in parts]) * wgt).sum(dim=0)
    return m, l, acc


def finish(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """Normalise after the last tile: (..., rows, dh) f32 (``m`` is taken
    for symmetry with the reference and not needed)."""
    return acc / torch.clamp(l, min=1e-30)
