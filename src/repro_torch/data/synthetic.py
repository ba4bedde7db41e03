"""Deterministic synthetic data pipeline.

Stateless and index-addressed: batch ``i`` is a pure function of (seed,
step, shape), so a restarted job resumes mid-epoch with no coordination
(the data side of fault tolerance).  The generator is a Zipf-ish unigram
mixture with short-range structure (every third token echoes a hash of
its predecessor), so cross-entropy has signal to learn.

:func:`batch` and :class:`Pipeline` are host numpy, bit for bit the JAX
package's; :func:`batch_on_device` draws uniform tokens on the device
from a ``torch.Generator``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device


def _mix(x: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):    # the hash wraps mod 2^64
        x = (x ^ (x >> 16)) * np.uint64(0x85EBCA6B)
        x = (x ^ (x >> 13)) * np.uint64(0xC2B2AE35)
    return x ^ (x >> 16)


def batch(seed: int, step: int, batch_size: int, seq_len: int, vocab: int,
          ctx_shape: tuple | None = None) -> dict:
    """-> {tokens (B,S) int32, labels (B,S) int32, [ctx (B,*ctx_shape) f32]}."""
    base = _mix(np.uint64(seed) * np.uint64(0x9E3779B97F4A7C15)
                + np.uint64(step))
    idx = (np.arange(batch_size * (seq_len + 1), dtype=np.uint64)
           .reshape(batch_size, seq_len + 1))
    h = _mix(idx + base)
    # zipf-ish skew: square a uniform in [0,1) then scale
    u = (h >> np.uint64(11)).astype(np.float64) / float(1 << 53)
    toks = (u * u * vocab).astype(np.int64)
    # short-range structure: every 3rd token echoes a hash of its predecessor
    echo = (_mix(toks[:, :-1].astype(np.uint64) + base) % np.uint64(vocab))
    mask = (idx[:, 1:] % np.uint64(3)) == 0
    stream = toks[:, 1:].copy()
    stream[mask] = echo.astype(np.int64)[mask]
    tokens = stream.astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((batch_size, 1), -1,
                                                    np.int32)], axis=1)
    out = {"tokens": tokens, "labels": labels}
    if ctx_shape is not None:
        ch = _mix(np.arange(batch_size * int(np.prod(ctx_shape)),
                            dtype=np.uint64) + base + np.uint64(7))
        ctx = ((ch >> np.uint64(11)).astype(np.float64) / float(1 << 53))
        out["ctx"] = (ctx.reshape(batch_size, *ctx_shape) * 0.2 - 0.1).astype(
            np.float32)
    return out


class Pipeline:
    """Step-indexed host loader with one-batch lookahead (prefetch)."""

    def __init__(self, cfg, batch_size: int, seq_len: int, seed: int = 0):
        self.cfg, self.b, self.s, self.seed = cfg, batch_size, seq_len, seed
        self._next = None
        self._next_step = None

    def _make(self, step: int) -> dict:
        ctx_shape = None
        if self.cfg.n_ctx_tokens:
            ctx_shape = (self.cfg.n_ctx_tokens, self.cfg.d_model)
        return batch(self.seed, step, self.b, self.s, self.cfg.vocab,
                     ctx_shape)

    def get(self, step: int) -> dict:
        if self._next_step == step and self._next is not None:
            out = self._next
        else:
            out = self._make(step)
        # prefetch the following batch synchronously-cheap (numpy)
        self._next_step = step + 1
        self._next = self._make(step + 1)
        return out


def to_device(host: dict, device="cuda") -> dict:
    """A host batch's arrays as tensors on ``device`` (CUDA unless the
    caller asks for the CPU)."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(v).to(dev) for k, v in host.items()}


def batch_on_device(seed: int, step: int, b: int, s: int, vocab: int, *,
                    device="cuda") -> dict:
    """Uniform tokens drawn on ``device`` from a ``torch.Generator`` seeded
    by (seed, step): {tokens (b, s) int32, labels (b, s) int32, the
    tokens shifted left with -1 in the last column}."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed((seed << 32) + step)
    toks = torch.randint(0, vocab, (b, s + 1), generator=gen, device=dev,
                         dtype=torch.int32)
    tail = torch.full((b, 1), -1, dtype=torch.int32, device=dev)
    return {"tokens": toks[:, :-1],
            "labels": torch.cat([toks[:, 1:-1], tail], dim=1)}
