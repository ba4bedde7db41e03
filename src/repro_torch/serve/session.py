"""Request/session model for the continuous-batching serve engine.

A :class:`Request` is what a user submits: a prompt, a generation budget,
optional modality context.  A :class:`Session` is the engine's per-request
record — slot assignment, emitted tokens, timing marks — and survives the
request's whole lifecycle (queued -> admitted -> decoding -> finished).

The synthetic trace generator lives here too: the launch entry point and
the chip smoke run replay a seeded mixed-length trace through the engine,
so throughput numbers are comparable across runs and machines.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np


@dataclasses.dataclass
class Request:
    """One generation request.

    ``max_new_tokens`` counts every emitted token including the one sampled
    from the prefill logits (matching ``serve_step.generate(n_new)``).
    """

    rid: int
    prompt: np.ndarray                 # (P,) int32 token ids
    max_new_tokens: int
    ctx: Any = None                    # (T_ctx, d) modality context, or None

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32)
        if self.prompt.ndim != 1 or self.prompt.size == 0:
            raise ValueError(f"prompt must be a non-empty 1-D token vector, "
                             f"got shape {self.prompt.shape}")
        if self.max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, "
                             f"got {self.max_new_tokens}")


@dataclasses.dataclass
class Session:
    """Engine-side lifecycle record of one request."""

    request: Request
    t_submit: float
    slot: int | None = None            # resident slot while decoding
    tokens: list[int] = dataclasses.field(default_factory=list)
    finish_reason: str | None = None   # "eos" | "length"
    t_admit: float | None = None
    t_first: float | None = None       # first token emitted (end of prefill)
    t_done: float | None = None
    step_first: int | None = None      # engine step of the first token — the
                                       # schedule-depth TTFT, deterministic
                                       # where wall TTFT is machine noise

    @property
    def done(self) -> bool:
        return self.finish_reason is not None

    @property
    def latency(self) -> float:
        """Submit-to-last-token wall time (NaN while still in flight)."""
        return float("nan") if self.t_done is None else \
            self.t_done - self.t_submit

    @property
    def ttft(self) -> float:
        """Submit-to-first-token wall time (NaN before the first token)."""
        return float("nan") if self.t_first is None else \
            self.t_first - self.t_submit

    @property
    def queue_wait(self) -> float:
        """Submit-to-admission wall time (NaN while still queued) — the
        scheduling share of TTFT; the remainder is prefill compute."""
        return float("nan") if self.t_admit is None else \
            self.t_admit - self.t_submit


@dataclasses.dataclass
class TranscriptStream:
    """One streaming-transcription input: an ordered sequence of fixed-size
    encoder windows (each ``(n_ctx_tokens, d_model)`` frame embeddings).

    Windows are transcribed incrementally: window ``w+1``'s decode prompt
    is conditioned on the transcript emitted for windows ``0..w``, so a
    stream is a chain of dependent one-window sessions.  Streams are
    independent of each other and interleave freely in the slot pool.
    """

    sid: int
    windows: list                      # [(n_ctx_tokens, d_model) float32]

    def __post_init__(self):
        if self.sid < 0:
            raise ValueError(f"stream id must be >= 0, got {self.sid}")
        if not self.windows:
            raise ValueError(f"stream {self.sid} has no windows")


def synthetic_audio_trace(n_streams: int, n_windows: int, *,
                          n_ctx_tokens: int, d_model: int,
                          seed: int = 0) -> list[TranscriptStream]:
    """Seeded synthetic audio streams: ``n_streams`` streams of
    ``n_windows`` frame-embedding windows (0.1 x standard normal) each.
    The draws depend only on (seed, knobs), never on an engine's
    schedule, so transcripts compare across slot counts and runs."""
    rng = np.random.default_rng(seed)
    out = []
    for sid in range(n_streams):
        windows = [rng.standard_normal((n_ctx_tokens, d_model))
                   .astype(np.float32) * 0.1 for _ in range(n_windows)]
        out.append(TranscriptStream(sid=sid, windows=windows))
    return out


def synthetic_trace(n_requests: int, vocab: int, *, seed: int = 0,
                    prompt_lens: tuple = (4, 8, 12, 16),
                    new_tokens: tuple = (4, 8, 12),
                    n_ctx_tokens: int = 0, d_model: int = 0,
                    prefix_frac: float = 0.0,
                    prefix_len: int = 0) -> list[Request]:
    """Seeded mixed-length request trace.

    Prompt and budget draws are independent per request, so slots free at
    staggered times and the admission path (prefill interleaved with decode)
    is genuinely exercised.  ``n_ctx_tokens > 0`` attaches a per-request
    modality context (vlm / enc-dec archs).

    ``prefix_len > 0`` models the production regime where most prompts
    open with one shared system prompt: a ``prefix_frac`` fraction of
    requests get ``prefix_len`` common leading tokens (and, for ctx archs,
    one shared ctx object — prefix sharing is keyed per-ctx).  The shared
    material and the membership coin come from a *separate* seeded stream,
    so the per-request draws — and with them every existing trace — are
    bit-identical to the ``prefix_len=0`` trace modulo the prepended
    prefix, and the trace depends only on (seed, knobs), never on any
    engine schedule.
    """
    rng = np.random.default_rng(seed)
    shared_prefix = shared_ctx = prng = None
    if prefix_len:
        prng = np.random.default_rng([seed, 0xC1A])
        shared_prefix = prng.integers(0, vocab, size=prefix_len) \
            .astype(np.int32)
        if n_ctx_tokens:
            shared_ctx = (prng.standard_normal((n_ctx_tokens, d_model))
                          .astype(np.float32) * 0.1)
    out = []
    for rid in range(n_requests):
        p = int(rng.choice(prompt_lens))
        n = int(rng.choice(new_tokens))
        prompt = rng.integers(0, vocab, size=p).astype(np.int32)
        ctx = None
        if n_ctx_tokens:
            ctx = (rng.standard_normal((n_ctx_tokens, d_model))
                   .astype(np.float32) * 0.1)
        if prefix_len and prng.random() < prefix_frac:
            prompt = np.concatenate([shared_prefix, prompt])
            if n_ctx_tokens:
                ctx = shared_ctx
        out.append(Request(rid=rid, prompt=prompt, max_new_tokens=n, ctx=ctx))
    return out
