"""Host-side residency allocators for the serve tier (DESIGN.md §13–§15).

:class:`SlotPool` owns batch-slot bookkeeping (FIFO admission into the
lowest free slot); :class:`BlockPool` owns the shared paged-KV block pool
(refcounts, copy-on-write holds, the idle cached tier and its LRU
eviction).  Both are pure host state machines — no device state — so the
determinism of the whole engine reduces to these classes being
deterministic, which the unit tests pin, and so one process can hold many
of them without touching device state.
"""

from __future__ import annotations

import bisect
import collections

from repro_torch.serve.session import Session


class SlotPool:
    """Slot bookkeeping: FIFO admission into the lowest free slot.

    Pure host-side state machine (no device state) — determinism of the
    whole engine reduces to this class being deterministic.
    """

    def __init__(self, n_slots: int):
        if n_slots < 1:
            raise ValueError(f"need at least one slot, got {n_slots}")
        self.n_slots = n_slots
        self._free = list(range(n_slots))        # kept sorted ascending
        self._queue: collections.deque[Session] = collections.deque()
        self._active: dict[int, Session] = {}

    # -- queue side ----------------------------------------------------------

    def submit(self, session: Session) -> None:
        self._queue.append(session)

    @property
    def queued(self) -> int:
        return len(self._queue)

    def peek(self) -> Session | None:
        """The session the next admit() would pop (FIFO head), or None."""
        return self._queue[0] if self._queue else None

    def drain_queue(self) -> list[Session]:
        """Remove and return every queued (not yet admitted) session: the
        router's kill drill resubmits these to surviving replicas."""
        out = list(self._queue)
        self._queue.clear()
        return out

    # -- slot side -----------------------------------------------------------

    @property
    def free_slots(self) -> list[int]:
        return list(self._free)

    @property
    def active(self) -> dict[int, Session]:
        return dict(self._active)

    def admissible(self) -> bool:
        return bool(self._queue) and bool(self._free)

    def admit(self) -> tuple[Session, int]:
        """Pop the oldest queued session into the lowest free slot."""
        if not self._queue:
            raise RuntimeError("admit() with an empty queue")
        if not self._free:
            raise RuntimeError("admit() with no free slot")
        session = self._queue.popleft()
        slot = self._free.pop(0)
        session.slot = slot
        self._active[slot] = session
        return session, slot

    def place(self, session: Session, slot: int) -> None:
        """Seat a session directly in a specific free slot, bypassing the
        queue: a migration import lands the session in the slot its state
        was scattered into."""
        if slot not in self._free:
            raise RuntimeError(f"place({slot}): slot is not free")
        self._free.remove(slot)
        session.slot = slot
        self._active[slot] = session

    def evict(self, slot: int) -> Session:
        """Free a slot; its session leaves the active set."""
        if slot not in self._active:
            raise KeyError(f"slot {slot} is not active")
        session = self._active.pop(slot)
        self._free.append(slot)
        self._free.sort()
        return session

    def idle(self) -> bool:
        return not self._queue and not self._active


class BlockPool:
    """Host allocator for the shared paged-KV block pool (DESIGN.md §14/§15).

    Physical block 0 is the reserved *trash* block — dead-slot and padding
    writes are routed there and never read — so ids 1..n_blocks-1 are
    allocatable.  Allocation is lowest-id-first and per-request (free by
    request id reclaims everything the request held), which keeps the whole
    engine deterministic for a fixed trace.  Pure host logic, like
    :class:`SlotPool`, so it is unit-testable without a model.

    Prefix sharing (§15) adds per-block refcounts: a block may be *held*
    by several requests at once (:meth:`share` maps an existing block into
    another request read-only; a block is writable only while exactly one
    request holds it and it is not cached) and may be marked *cached*
    (registered in a :class:`repro_torch.serve.prefix.PrefixIndex`).  A cached
    block whose refcount drops to zero is not freed but parked in an *idle*
    tier — content kept resident, revived by a later :meth:`share`,
    reclaimed least-recently-idle-first by :meth:`evict_idle` under pool
    pressure.  Uncached blocks go straight back to the free list, exactly
    the pre-§15 behavior.  LRU order uses a logical clock, never wall time,
    so eviction (and with it the whole engine) stays deterministic for a
    fixed trace.
    """

    def __init__(self, n_blocks: int):
        if n_blocks < 2:
            raise ValueError(
                f"need at least 2 blocks (block 0 is the reserved trash "
                f"block), got {n_blocks}")
        self.n_blocks = n_blocks
        self._free = list(range(1, n_blocks))    # kept sorted ascending
        self._held: dict[int, list[int]] = {}    # rid -> block ids
        self._ref: dict[int, int] = {}           # bid -> holders (>= 1)
        self._cached: set[int] = set()           # registered in a PrefixIndex
        self._idle: dict[int, int] = {}          # cached, ref 0: bid -> stamp
        self._clock = 0                          # deterministic LRU time

    @property
    def capacity(self) -> int:
        """Allocatable blocks (excludes the trash block)."""
        return self.n_blocks - 1

    @property
    def available(self) -> int:
        """Immediately allocatable (free list only — idle cached blocks
        need :meth:`evict_idle` first)."""
        return len(self._free)

    @property
    def idle(self) -> int:
        """Cached blocks with no holder (evictable, content resident)."""
        return len(self._idle)

    @property
    def reclaimable(self) -> int:
        """free + idle: the upper bound an admission gate may count on.
        Idle blocks a plan itself will :meth:`share` must be excluded by
        the caller — revival precedes the fresh allocation, so they
        cannot also be evicted to cover it."""
        return len(self._free) + len(self._idle)

    @property
    def in_use(self) -> int:
        """Blocks held by at least one request (idle cached blocks are
        resident but not in use)."""
        return self.capacity - len(self._free) - len(self._idle)

    @property
    def free_blocks(self) -> list[int]:
        return list(self._free)

    @property
    def idle_blocks(self) -> list[int]:
        """Idle cached blocks, eviction (LRU) order."""
        return sorted(self._idle, key=self._idle.__getitem__)

    def refcount(self, bid: int) -> int:
        return self._ref.get(bid, 0)

    def cached(self, bid: int) -> bool:
        return bid in self._cached

    def is_idle(self, bid: int) -> bool:
        """True when ``bid`` sits in the idle tier (cached, no holder) —
        evictable now, but not after a :meth:`share` revives it."""
        return bid in self._idle

    def idle_stamp(self, bid: int) -> int | None:
        """The logical-clock stamp of ``bid``'s current stay in the idle
        tier (None if not idle).  Strictly increasing across stays: the
        integrity scrubber keys its baselines on (bid, stamp), so a block
        revived, rewritten and re-idled is re-baselined, not flagged."""
        return self._idle.get(bid)


    def alloc(self, rid: int, n: int) -> list[int]:
        """n lowest free block ids, charged to request ``rid``."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            raise RuntimeError(
                f"block pool exhausted: request {rid} needs {n} blocks, "
                f"{len(self._free)} free (admission must gate on available, "
                f"evicting idle cached blocks first)")
        ids = self._free[:n]
        del self._free[:n]
        self._held.setdefault(rid, []).extend(ids)
        for bid in ids:
            self._ref[bid] = 1
        return ids

    def share(self, rid: int, ids: list[int]) -> None:
        """Map existing blocks into ``rid`` read-only (refcount + 1 each).

        Sharing an idle cached block revives it: it leaves the eviction
        tier with its contents intact.  Sharing a free block (or the trash
        block, or a block ``rid`` already holds) is a caller bug."""
        held = self._held.setdefault(rid, [])
        for bid in ids:
            if bid <= 0 or bid >= self.n_blocks:
                raise ValueError(f"share({bid}): not an allocatable block id")
            if bid in held:
                raise RuntimeError(
                    f"share({bid}): request {rid} already holds it")
            if bid in self._idle:
                del self._idle[bid]
                self._ref[bid] = 1
            elif self._ref.get(bid, 0) > 0:
                self._ref[bid] += 1
            else:
                raise RuntimeError(f"share({bid}): block is free")
            held.append(bid)

    def _release(self, bid: int) -> None:
        r = self._ref[bid] - 1
        if r > 0:
            self._ref[bid] = r
            return
        del self._ref[bid]
        if bid in self._cached:
            self._clock += 1
            self._idle[bid] = self._clock
        else:
            bisect.insort(self._free, bid)

    def free(self, rid: int) -> int:
        """Drop every hold ``rid`` has; returns how many.  Blocks whose
        refcount hits zero return to the free list, except cached ones,
        which park in the idle tier."""
        ids = self._held.pop(rid, [])
        for bid in ids:
            self._release(bid)
        return len(ids)

    def drop(self, rid: int, bid: int) -> None:
        """Release ``rid``'s hold on one block — the copy-on-write path:
        after duplicating a shared divergence block into a private one the
        request lets go of the original."""
        held = self._held.get(rid)
        if held is None or bid not in held:
            raise KeyError(f"drop({bid}): not held by request {rid}")
        held.remove(bid)
        if not held:
            del self._held[rid]
        self._release(bid)

    def set_cached(self, bid: int) -> None:
        """Mark a held block as index-registered: its last release parks
        it in the idle tier instead of freeing it."""
        if self._ref.get(bid, 0) < 1:
            raise RuntimeError(f"set_cached({bid}): block is not held")
        self._cached.add(bid)

    def evict_idle(self, n: int) -> list[int]:
        """Reclaim the ``n`` least-recently-idled cached blocks back to
        the free list; the caller must drop their index entries.  Held
        (refcount > 0) blocks are never evicted."""
        if n > len(self._idle):
            raise RuntimeError(
                f"evict_idle({n}): only {len(self._idle)} blocks idle")
        victims = sorted(self._idle, key=self._idle.__getitem__)[:n]
        for bid in victims:
            del self._idle[bid]
            self._cached.discard(bid)
            bisect.insort(self._free, bid)
        return victims

    def held(self, rid: int) -> list[int]:
        return list(self._held.get(rid, []))
