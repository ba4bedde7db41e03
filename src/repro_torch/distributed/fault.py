"""Fault tolerance: checkpoint-restart and straggler detection.

* restart      the step index addresses both the checkpoint and the
               stateless data pipeline, so a restart replays nothing and
               skips nothing (:class:`Runner`);
* verification every save and restore parity-checks each leaf
               (``checkpoint/ckpt.py``); a corrupt or unreadable
               checkpoint counts as a failed node and the runner falls
               back to the one before;
* stragglers   per-step wall times are watermarked against their
               trailing median; steps slower than ``straggler_factor``
               times it are logged and counted, and after
               ``max_strikes`` the policy asks for a re-shard (a recorded
               decision) (:class:`StragglerPolicy`, also the serve
               tier's).
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from statistics import median

from repro_torch.checkpoint import ckpt


@dataclass
class StragglerPolicy:
    straggler_factor: float = 2.0
    max_strikes: int = 3
    window: int = 20
    _times: list = field(default_factory=list)
    strikes: int = 0
    events: list = field(default_factory=list)

    def observe(self, step: int, dt: float) -> str:
        """Returns "ok" | "straggler" | "reshard"."""
        self._times = (self._times + [dt])[-self.window:]
        if len(self._times) < 5:
            return "ok"
        med = median(self._times[:-1])
        if dt > self.straggler_factor * med:
            self.strikes += 1
            self.events.append((step, dt, med))
            if self.strikes >= self.max_strikes:
                self.strikes = 0
                return "reshard"
            return "straggler"
        return "ok"


@dataclass
class Runner:
    """Restartable step loop around a (state, batch) -> state step: its
    checkpoints (``ckpt_%08d.npz`` + manifest under ``directory``, every
    ``save_every`` steps, the last ``keep_last`` kept, ciphered under
    ``root_key`` when given) are the JAX package's format, so either
    package resumes the other's.  Digests and the cipher run on
    ``device`` (CUDA unless the caller asks for the CPU)."""
    directory: str
    save_every: int = 50
    keep_last: int = 3
    root_key: str | None = None
    policy: StragglerPolicy = field(default_factory=StragglerPolicy)
    device: str = "cuda"
    fallbacks: list = field(default_factory=list)  # (step, error) skipped

    def resume_or_init(self, like, init_fn):
        """-> (the latest checkpoint that restores, its step), or
        (``init_fn()``, 0) when none does.  ``like`` gives the tree's
        structure, shapes and dtypes (``meta`` tensors will do)."""
        step = ckpt.latest_step(self.directory)
        while step is not None:
            try:
                state, _ = ckpt.restore(self.directory, step, like,
                                        root_key=self.root_key,
                                        device=self.device)
                return state, step
            except Exception as e:  # noqa: BLE001 -- any unreadable
                # checkpoint (parity mismatch, truncated zip, missing
                # manifest, a wrong key) is a failed node: fall back one
                self.fallbacks.append((step, repr(e)))
                prev = [s for s in self._steps() if s < step]
                step = max(prev) if prev else None
        return init_fn(), 0

    def maybe_save(self, step: int, state) -> bool:
        if step % self.save_every != 0:
            return False
        ckpt.save(self.directory, step, state, root_key=self.root_key,
                  device=self.device)
        self._gc()
        return True

    def observe_step(self, step: int, dt: float) -> str:
        return self.policy.observe(step, dt)

    def _steps(self) -> list:
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(m.group(1)) for f in os.listdir(self.directory)
                      if (m := re.match(r"ckpt_(\d+)\.npz$", f)))

    def _gc(self) -> None:
        for s in self._steps()[:-self.keep_last]:
            for name in (f"ckpt_{s:08d}.npz", f"manifest_{s:08d}.msgpack"):
                try:
                    os.remove(os.path.join(self.directory, name))
                except FileNotFoundError:
                    pass
