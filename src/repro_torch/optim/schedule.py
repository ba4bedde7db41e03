"""LR schedules: linear warmup + cosine, and WSD (warmup-stable-decay).
Each takes a step (int or tensor) and returns the rate as an f32 tensor
on the step's device."""

from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def warmup_cosine(step, *, peak_lr: float, warmup: int, total: int,
                  floor_frac: float = 0.1) -> torch.Tensor:
    step = _f32(step)
    warm = peak_lr * step / max(warmup, 1)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
    cos = peak_lr * (floor_frac + (1 - floor_frac)
                     * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup, warm, cos)


def wsd(step, *, peak_lr: float, warmup: int, total: int,
        decay_frac: float = 0.1, floor_frac: float = 0.05) -> torch.Tensor:
    step = _f32(step)
    decay_start = total * (1 - decay_frac)
    warm = peak_lr * step / max(warmup, 1)
    prog = torch.clamp((step - decay_start) / max(total - decay_start, 1),
                       0, 1)
    dec = peak_lr * (1 - (1 - floor_frac) * prog)
    return torch.where(step < warmup, warm,
                       torch.where(step < decay_start,
                                   torch.full_like(step, peak_lr), dec))
