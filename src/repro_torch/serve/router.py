"""Replicated serving tier with verified live session migration.

:class:`Router` fronts N :class:`repro_torch.serve.engine.ServeEngine`
replicas, each on its own device from
:func:`repro_torch.launch.mesh.replica_devices` (replicas share a card
when there are fewer cards than replicas) and watched by a
:class:`repro_torch.distributed.fault.StragglerPolicy` fed the replica's
per-step wall time:

* **admission** routes each request to the least-loaded alive replica
  (in flight + queued; ties to the lowest index — deterministic);
* **migration** moves a live session between replicas through an
  encrypted checkpoint: the source's :meth:`export_session` wire is
  written with :func:`repro_torch.checkpoint.ckpt.save` (first hop) or
  :func:`~repro_torch.checkpoint.ckpt.save_delta` (later hops: leaves
  unchanged since the previous hop, such as the prompt, a modality
  context and its ``ctx_kv``, resolve through the chain), whose digests
  run the parity kernel and whose cipher runs the XOR cipher
  kernel on the card; the destination restores it against a spec derived
  from (cfg, geometry, request), never from the file, and
  :meth:`import_session` re-admits it token-identically;
* **kill drill**: :meth:`kill` marks a replica dead, resubmits its queued
  sessions and drains every admitted one onto the survivors by
  migration, stepping the survivors while none can accept;
* an **integrity scrubber** (:class:`IntegrityScrubber`) walks each
  replica every ``epoch_steps`` router steps: an incremental
  :class:`repro_torch.core.incremental.DigestCache` pass over the
  resident packed weights and over idle cached KV blocks, mismatches
  counted in ``EngineStats.scrub_corruptions``.

Replicas that share a card launch on that card's current stream, one
after the other: the paged decode kernel's merge tickets are one buffer
per device (``kernels/paged_attn.py``), safe only while its launches
never overlap.  :meth:`Router.step` checks that the stream has not
changed since construction.

Mirrors ``repro/serve/router.py``.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.core.engine import CimEngine
from repro_torch.core.incremental import DigestCache
from repro_torch.core.verify import leaf_key, tree_flatten_with_path
from repro_torch.distributed.fault import StragglerPolicy
from repro_torch.launch.mesh import replica_devices
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.session import Request, Session
from repro_torch.serve.stats import EngineStats, ServeReport


class IntegrityScrubber:
    """Digest verification of one replica's resident state.

    Weights: the first pass records each leaf's digest of the engine's
    (packed) params through a :class:`DigestCache`; later passes re-digest
    (an unchanged tensor costs nothing) and a digest that moved is a
    corruption — a serving engine's params never change.

    Idle cached KV blocks: each idle block's contents are baselined per
    ``(bid, idle_stamp)``; while the block stays idle nothing may write
    it, so a moved digest is a corruption.  A block revived, rewritten and
    re-idled carries a new stamp and is re-baselined instead.
    """

    def __init__(self, engine: ServeEngine, cache: DigestCache | None = None):
        self.engine = engine
        self.cache = cache if cache is not None else DigestCache(
            device=engine.device)
        self._weight_baseline: dict[str, bytes] | None = None
        # bid -> (idle stamp, {leaf key: digest bytes})
        self._block_baseline: dict[int, tuple[int, dict[str, bytes]]] = {}

    @staticmethod
    def _flat_digests(tree) -> dict[str, bytes]:
        return {leaf_key(p): np.asarray(d).tobytes()
                for p, d in tree_flatten_with_path(tree)}

    def scrub(self) -> int:
        """One pass; returns the mismatches found (also accumulated into
        the engine's ``scrub_*`` counters)."""
        eng, st = self.engine, self.engine.stats
        bad = 0
        digs = self._flat_digests(self.cache.digests(eng.params))
        if self._weight_baseline is None:
            self._weight_baseline = digs
        else:
            bad += sum(1 for k, v in digs.items()
                       if v != self._weight_baseline[k])
        st.scrub_weight_leaves += len(digs)
        if eng.paged and eng.blocks is not None:
            idle = set(eng.blocks.idle_blocks)
            for bid in list(self._block_baseline):
                if bid not in idle:
                    del self._block_baseline[bid]
            for bid in sorted(idle):
                stamp = eng.blocks.idle_stamp(bid)
                digs = self._flat_digests(self.cache.digests(
                    {f"idle_block/{bid}": eng.gather_block(bid)}))
                base = self._block_baseline.get(bid)
                if base is not None and base[0] == stamp:
                    bad += sum(1 for k, v in digs.items() if v != base[1][k])
                else:
                    self._block_baseline[bid] = (stamp, digs)
            st.scrub_idle_blocks += len(idle)
        st.scrub_passes += 1
        st.scrub_corruptions += bad
        return bad


@dataclasses.dataclass
class ReplicaHandle:
    """One replica: engine, device, fault-detection state, and the
    CimEngine its migration wires are digested and ciphered through."""

    index: int
    engine: ServeEngine
    device: torch.device
    policy: StragglerPolicy
    scrubber: IntegrityScrubber
    cim: CimEngine
    alive: bool = True

    @property
    def load(self) -> int:
        """In flight + queued: the admission routing metric."""
        return len(self.engine.pool.active) + self.engine.pool.queued

    def can_accept(self, request: Request) -> bool:
        """Whether an import or submit of ``request`` fits now (a free
        slot, and a wholly fresh block reservation fits the pool)."""
        eng = self.engine
        if not eng.pool.free_slots:
            return False
        if eng.blocks is None:
            return True
        need = sum(eng._blocks_per_class(request.prompt.shape[0],
                                         request.max_new_tokens).values())
        return need <= eng.blocks.reclaimable


@dataclasses.dataclass
class RouterReport:
    """Outcome of one :meth:`Router.run`: the merged sessions, per-replica
    stats and the migration / fault event log."""

    sessions: dict[int, Session]
    wall: float
    replicas: list[EngineStats]
    migrations: list[tuple[int, int, int, int]]   # (rid, src, dst, ckpt step)
    straggler_events: list[tuple[int, int, str]]  # (router step, replica, verdict)
    killed: list[int]

    @property
    def generated(self) -> int:
        return sum(len(s.tokens) for s in self.sessions.values())

    @property
    def tok_per_s(self) -> float:
        return self.generated / max(self.wall, 1e-9)

    def tokens(self, rid: int) -> np.ndarray:
        return np.asarray(self.sessions[rid].tokens, np.int32)

    @property
    def scrub_passes(self) -> int:
        return sum(r.scrub_passes for r in self.replicas)

    @property
    def scrub_corruptions(self) -> int:
        return sum(r.scrub_corruptions for r in self.replicas)

    def serve_report(self) -> ServeReport:
        """The merged sessions as a :class:`ServeReport`, so the quantile
        helpers apply across replicas."""
        agg = EngineStats()
        for r in self.replicas:
            for f in ("decode_steps", "prefills", "prefill_chunks",
                      "migrations_out", "migrations_in", "scrub_passes",
                      "scrub_weight_leaves", "scrub_idle_blocks",
                      "scrub_corruptions", "prefix_hits", "prefix_tokens",
                      "prompt_tokens", "fresh_blocks", "cow_copies"):
                setattr(agg, f, getattr(agg, f) + getattr(r, f))
        return ServeReport(sessions=dict(self.sessions), wall=self.wall,
                           decode_steps=agg.decode_steps,
                           prefills=agg.prefills, stats=agg)


class Router:
    """N-replica serving tier with live migration.

    Every replica is a full paged :class:`ServeEngine` over the same (cfg,
    params, s_max, block_size, prefill_chunk, temperature, seed) — the
    migration identity contract — on its device from
    :func:`replica_devices` (``device``: ``"cuda"`` by default, or
    ``"cpu"``).  ``ckpt_dir`` holds the migration wires, one directory per
    request (``rid_<rid>/``), encrypted under ``root_key``; later hops of
    a request extend its delta chain.  ``epoch_steps`` sets the scrubber
    cadence in router steps (0: off).
    """

    def __init__(self, cfg, params, n_replicas: int, *, slots: int,
                 s_max: int, ckpt_dir: str, root_key: str = "serve-mig",
                 epoch_steps: int = 8, eos_id: int | None = None,
                 temperature: float = 0.0, seed: int = 0, pack: bool = True,
                 block_size: int = 0, prefill_chunk: int = 0,
                 n_blocks: int = 0, prefix_cache: bool = True,
                 straggler_factor: float = 2.0, device="cuda"):
        self.ckpt_dir = ckpt_dir
        self.root_key = root_key
        self.epoch_steps = int(epoch_steps)
        self.replicas: list[ReplicaHandle] = []
        for i, dev in enumerate(replica_devices(n_replicas, device)):
            eng = ServeEngine(cfg, params, slots=slots, s_max=s_max,
                              eos_id=eos_id, temperature=temperature,
                              seed=seed, pack=pack, paged=True,
                              block_size=block_size,
                              prefill_chunk=prefill_chunk, n_blocks=n_blocks,
                              prefix_cache=prefix_cache, device=dev)
            cim = CimEngine(device=dev)
            self.replicas.append(ReplicaHandle(
                index=i, engine=eng, device=dev,
                policy=StragglerPolicy(straggler_factor=straggler_factor),
                scrubber=IntegrityScrubber(eng, DigestCache(cim)), cim=cim))
        # the stream every replica's launches go out on, per card
        self._streams = {h.device: torch.cuda.current_stream(h.device)
                         for h in self.replicas if h.device.type == "cuda"}
        self._requests: dict[int, Request] = {}
        self._where: dict[int, int] = {}          # rid -> replica index
        self._mig_step: dict[int, int] = {}       # rid -> last ckpt step
        self._mig_cache: dict[int, DigestCache] = {}
        self._step = 0
        self.migrations: list[tuple[int, int, int, int]] = []
        self.straggler_events: list[tuple[int, int, str]] = []
        self.killed: list[int] = []

    # -- admission -----------------------------------------------------------

    def _alive(self) -> list[ReplicaHandle]:
        return [h for h in self.replicas if h.alive]

    def submit(self, request: Request) -> Session:
        """Route to the least-loaded alive replica (ties: lowest index)."""
        alive = self._alive()
        if not alive:
            raise RuntimeError("no alive replica")
        h = min(alive, key=lambda h: (h.load, h.index))
        session = h.engine.submit(request)
        self._requests[request.rid] = request
        self._where[request.rid] = h.index
        return session

    # -- the step loop -------------------------------------------------------

    def _check_streams(self) -> None:
        for dev, stream in self._streams.items():
            if torch.cuda.current_stream(dev) != stream:
                raise RuntimeError(
                    f"Router.step on another stream of {dev} than at "
                    "construction: replicas sharing a card must launch on "
                    "one stream (the paged decode kernel's merge tickets "
                    "are one buffer per device)")

    def step(self) -> bool:
        """Advance every alive replica one engine step, feed each step's
        wall time to its straggler policy, and scrub on epoch boundaries.
        Returns False once every alive replica is drained."""
        self._check_streams()
        self._step += 1
        busy = False
        for h in self._alive():
            if h.engine.pool.idle():
                continue
            t0 = time.monotonic()
            busy |= h.engine.step()
            verdict = h.policy.observe(self._step, time.monotonic() - t0)
            if verdict != "ok":
                self.straggler_events.append((self._step, h.index, verdict))
        if self.epoch_steps and self._step % self.epoch_steps == 0:
            self.scrub()
        return busy

    def scrub(self) -> int:
        """One scrubber pass over every alive replica; returns mismatches."""
        return sum(h.scrubber.scrub() for h in self._alive())

    # -- migration -----------------------------------------------------------

    def _wire_dir(self, rid: int) -> str:
        return os.path.join(self.ckpt_dir, f"rid_{rid}")

    def migrate(self, rid: int, src: int, dst: int) -> Session:
        """Move live session ``rid`` from replica ``src`` to ``dst``
        through an encrypted (delta) checkpoint.  The source slot is
        released only after the wire is written and verified; the
        destination restores against its own derived spec."""
        if src == dst:
            raise ValueError(f"migrate({rid}): src == dst == {src}")
        hs, hd = self.replicas[src], self.replicas[dst]
        if not hd.alive:
            raise RuntimeError(f"migrate({rid}): replica {dst} is dead")
        request = self._requests[rid]
        if not hd.can_accept(request):
            raise RuntimeError(f"migrate({rid}): replica {dst} is full")
        wire = hs.engine.export_session(rid)
        d = self._wire_dir(rid)
        step = self._mig_step.get(rid, 0) + 1
        cache = self._mig_cache.setdefault(rid, DigestCache(hs.cim))
        if step == 1:
            ckpt.save(d, step, wire, root_key=self.root_key,
                      engine=cache.engine)
            cache.digests(wire)        # prime: exact dirtiness on hop 2
            cache.mark_saved()
        else:
            # delta against the previous hop: the prompt, the context,
            # its ctx_kv and any KV blocks unchanged since resolve through
            # the chain, not re-stored
            ckpt.save_delta(d, step, wire, root_key=self.root_key,
                            cache=cache)
        self._mig_step[rid] = step
        like = hd.engine.export_spec(request)
        restored, _ = ckpt.restore(d, step, like, root_key=self.root_key,
                                   engine=hd.cim, device=hd.device)
        session = hd.engine.import_session(request, restored)
        hs.engine.release_migrated(rid)
        self._where[rid] = dst
        self.migrations.append((rid, src, dst, step))
        return session

    # -- fault drill ---------------------------------------------------------

    def kill(self, index: int) -> None:
        """Kill-a-replica drill: mark ``index`` dead, resubmit its queued
        sessions to the survivors, and drain its admitted sessions onto
        them by migration, stepping the survivors whenever none can accept
        (finishing requests free slots and blocks, so the drain always
        progresses)."""
        h = self.replicas[index]
        if not h.alive:
            raise RuntimeError(f"replica {index} is already dead")
        if len(self._alive()) < 2:
            raise RuntimeError("kill(): no surviving replica to drain onto")
        h.alive = False
        self.killed.append(index)
        for sess in h.engine.pool.drain_queue():
            rid = sess.request.rid
            del h.engine.sessions[rid]
            new = self.submit(sess.request)
            new.t_submit = sess.t_submit   # queue time survives the reroute
        admitted = sorted(s.request.rid
                          for s in h.engine.pool.active.values())
        for rid in admitted:
            dst = self._await_capacity(self._requests[rid])
            self.migrate(rid, index, dst.index)

    def _await_capacity(self, request: Request,
                        max_steps: int = 100_000) -> ReplicaHandle:
        """The least-loaded alive replica that can accept ``request``,
        stepping the alive replicas until one can."""
        for _ in range(max_steps):
            fits = [h for h in self._alive() if h.can_accept(request)]
            if fits:
                return min(fits, key=lambda h: (h.load, h.index))
            if not self.step():
                break     # everyone drained yet nobody fits: impossible
        raise RuntimeError(
            f"no replica can accept request {request.rid} "
            f"(prompt {request.prompt.shape[0]}, "
            f"budget {request.max_new_tokens})")

    # -- drive to completion -------------------------------------------------

    def run(self, kill_at: int | None = None,
            victim: int | None = None) -> RouterReport:
        """Drain every replica; with ``kill_at`` set, run the kill drill at
        that router step (victim: the most-loaded replica by default)."""
        t0 = time.monotonic()
        while True:
            if kill_at is not None and self._step + 1 >= kill_at \
                    and len(self._alive()) > 1:
                v = victim if victim is not None else max(
                    self._alive(), key=lambda h: (h.load, -h.index)).index
                self.kill(v)
                kill_at = None
            if not self.step():
                break
        sessions = {rid: self.replicas[idx].engine.sessions[rid]
                    for rid, idx in self._where.items()}
        return RouterReport(sessions=sessions,
                            wall=time.monotonic() - t0,
                            replicas=[h.engine.stats for h in self.replicas],
                            migrations=list(self.migrations),
                            straggler_events=list(self.straggler_events),
                            killed=list(self.killed))
