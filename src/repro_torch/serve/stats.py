"""Serve-side counters and run reports (DESIGN.md §13–§15, §17).

:class:`EngineStats` is the per-engine counter block (steps, chunks,
block-pool occupancy, prefix-cache, migration and integrity-scrub
outcomes); :class:`ServeReport` is the per-run outcome of
:meth:`ServeEngine.run`.  Both are plain host data, so the router can
aggregate them across replicas.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.serve.session import Session


@dataclasses.dataclass
class EngineStats:
    """Engine-side counters, including block-pool occupancy (peak / mean
    blocks in use) so a run can report memory utilization alongside
    tok/s."""

    decode_steps: int = 0
    prefills: int = 0
    prefill_chunks: int = 0
    decode_dispatches: int = 0  # dispatches of the decode step traced on
                                # meta (ServeEngine.decode_roofline; 0
                                # until an audit runs)
    blocks_total: int = 0       # allocatable blocks (0: dense layout)
    blocks_in_use: int = 0
    blocks_peak: int = 0
    # prefix caching (DESIGN.md §15; all zero when disabled / dense)
    cow_copies: int = 0             # divergence-block copy-on-write copies
    prefix_hits: int = 0            # admissions that mapped >= 1 shared block
    prefix_shared_blocks: int = 0   # total blocks mapped read-only
    prefix_tokens: int = 0          # prompt tokens skipped via the cache
    prompt_tokens: int = 0          # prompt tokens admitted (paged path)
    fresh_blocks: int = 0           # blocks newly allocated at admission
    prefix_evictions: int = 0       # cached blocks reclaimed under pressure
    prefix_cached_blocks: int = 0   # current index size (registered blocks)
    # session migration (zero outside the replicated tier)
    migrations_out: int = 0         # sessions exported off this engine
    migrations_in: int = 0          # sessions imported into this engine
    # integrity scrubbing: DigestCache passes over the resident packed
    # weights and idle cached KV blocks, and the mismatches found
    scrub_passes: int = 0
    scrub_weight_leaves: int = 0    # param leaves verified, cumulative
    scrub_idle_blocks: int = 0      # idle cached blocks verified, cumulative
    scrub_corruptions: int = 0      # digest mismatches against the baseline
    _block_sum: int = 0
    _block_samples: int = 0

    def observe_blocks(self, in_use: int) -> None:
        self.blocks_in_use = in_use
        self.blocks_peak = max(self.blocks_peak, in_use)
        self._block_sum += in_use
        self._block_samples += 1

    @property
    def blocks_mean(self) -> float:
        if not self._block_samples:
            return 0.0
        return self._block_sum / self._block_samples

    @property
    def block_utilization(self) -> float:
        """Mean fraction of the pool in use (0 when dense)."""
        if not self.blocks_total:
            return 0.0
        return self.blocks_mean / self.blocks_total

    @property
    def prefix_hit_rate(self) -> float:
        """Fraction of admitted prompt tokens served from the prefix
        cache (skipped at prefill)."""
        if not self.prompt_tokens:
            return 0.0
        return self.prefix_tokens / self.prompt_tokens

    @property
    def blocks_per_request(self) -> float:
        """Mean *fresh* blocks allocated per admitted request — sharing
        drives this down."""
        if not self.prefills:
            return 0.0
        return self.fresh_blocks / self.prefills


@dataclasses.dataclass
class ServeReport:
    """Outcome of one :meth:`ServeEngine.run`."""

    sessions: dict[int, Session]
    wall: float
    decode_steps: int
    prefills: int
    stats: EngineStats | None = None

    @property
    def generated(self) -> int:
        return sum(len(s.tokens) for s in self.sessions.values())

    @property
    def tok_per_s(self) -> float:
        return self.generated / max(self.wall, 1e-9)

    def tokens(self, rid: int) -> np.ndarray:
        return np.asarray(self.sessions[rid].tokens, np.int32)

    def _quantiles(self, values, qs) -> dict[float, float]:
        vals = [v for v in values if v == v]       # drop NaN (in-flight)
        if not vals:
            # mirror the Session.latency/ttft contract: nothing finished
            # means the statistic does not exist yet — NaN, never a fake 0
            # that would read as "instant" to a dashboard or a gate
            return {q: float("nan") for q in qs}
        return {q: float(np.quantile(vals, q)) for q in qs}

    def latency_quantiles(self, qs=(0.5, 0.95)) -> dict[float, float]:
        return self._quantiles((s.latency for s in self.sessions.values()), qs)

    def ttft_quantiles(self, qs=(0.5, 0.95)) -> dict[float, float]:
        """Submit-to-first-token, including time spent queued."""
        return self._quantiles((s.ttft for s in self.sessions.values()), qs)

    def ttft_step_quantiles(self, qs=(0.5, 0.95)) -> dict[float, float]:
        """First-token engine-step index — TTFT in schedule depth.  On a
        dispatch-bound smoke model wall TTFT is dominated by per-step sync
        overhead; the step count is the deterministic quantity wall time
        tracks once prefill compute actually dominates."""
        return self._quantiles(
            (float("nan") if s.step_first is None else float(s.step_first)
             for s in self.sessions.values()), qs)

    def queue_wait_quantiles(self, qs=(0.5, 0.95)) -> dict[float, float]:
        """Submit-to-admission: the scheduling share of TTFT, separated so
        prefill cost and queueing backpressure are distinguishable."""
        return self._quantiles(
            (s.queue_wait for s in self.sessions.values()), qs)
