"""Continuous-batching serve engine over one resident decode state.

A FIFO request queue feeds a fixed pool of batch slots over one resident
:class:`repro_torch.models.lm.DecodeState`:

* **paged KV** (default): attention state lives in a shared block pool
  addressed through host-owned per-slot block tables (:class:`BlockPool`
  allocates; tables are mirrored to the device when they change);
  ``paged=False`` keeps the slot-dense layout (``(slots, KV, s_max, dh)``
  caches): exact-length batch-1 prefill scattered into the slot;
* **admission**: a request's worst-case blocks are reserved (the FIFO head
  waits otherwise) and its prompt is consumed by **chunked prefill**, one
  ``prefill_chunk``-sized piece per engine step, interleaved with decode;
* **prefix cache** with copy-on-write (DESIGN.md §15): full prompt blocks
  are registered in a content-addressed index; a later prompt with the
  same prefix maps them read-only, copies the block its first write would
  land in, and prefills only the rest;
* **eviction** on EOS or budget: the slot frees, its blocks return to the
  pool (cached ones park in the idle tier), its table row is zeroed so the
  dead slot's writes land in the trash block 0;
* **sampling**: greedy at temperature 0; above it, Gumbel noise from a
  threefry twin (:mod:`repro_torch.core.prng`) keyed by the engine seed
  folded with a (request, step) seed, so a draw never depends on the slot
  or the batch — the contract session migration rests on;
* **modality context**: a request of a vlm or enc-dec arch brings its
  ``ctx`` (patch embeddings or frames); an enc-dec arch's frames are
  encoded once at admission, and every prefill chunk projects the cross
  layers' keys and values from it into the slot's state; prefix sharing
  is keyed on the context as well as the tokens;
* **session export/import** (paged layout): a live slot's blocks,
  per-slot state, position, tokens and chunked-prefill progress lift out
  as a flat wire tree and re-admit into any engine of the same (cfg,
  s_max, block_size, prefill_chunk, temperature, seed),
  token-identically; the replicated tier
  (:mod:`repro_torch.serve.router`) ships it as an encrypted checkpoint.

With ``pack=True`` and a ``quant="xnor"`` arch the engine serves from
packed weights (:func:`repro_torch.models.lm.pack_params`): sign planes +
beta; the float copies of binarized linears are not kept.  This mirrors
``repro/serve/engine.py``, token for token.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import prng
from repro_torch.core.xnor_layers import PackedLinear
from repro_torch.kernels import cuda
from repro_torch.models import blocks, lm
from repro_torch.models.params import tree_map
from repro_torch.serve.pools import BlockPool, SlotPool
from repro_torch.serve.prefix import PrefixIndex
from repro_torch.serve.session import Request, Session
from repro_torch.serve.stats import EngineStats, ServeReport


def _sample_tokens(cfg, logits: torch.Tensor, key: torch.Tensor,
                   seeds: torch.Tensor | None,
                   temperature: float) -> torch.Tensor:
    """Last-position sampling over the true vocab (pad ids never drawn):
    argmax at temperature 0, else argmax of ``row / T + gumbel`` with row
    ``b``'s noise keyed by ``fold_in(key, seeds[b])`` — draws depend only on
    the (request, step) seed, never on the slot or the batch.  ``seeds``
    may be None at temperature 0."""
    lg = logits[:, -1, :cfg.vocab].float()
    if temperature > 0.0:
        keys = prng.fold_in(key, seeds.to(torch.int64))       # (B, 2)
        lg = lg / temperature + prng.gumbel(keys, (lg.shape[-1],))
    return lg.argmax(dim=-1).to(torch.int32)[:, None]


def _insert_slot(resident: lm.DecodeState, one: lm.DecodeState,
                 slot: int) -> None:
    """Scatter a freshly prefilled batch-1 dense state into resident slot
    ``slot``, in place (leaves are layer-stacked, batch at axis 1; ``ctx``
    and ``pos`` carry the batch at axis 0).  An enc-dec arch keeps no
    resident context (its ``ctx_kv`` lives in the layers' states), so the
    prefill's encoded frames are dropped."""
    for r, o in zip(resident.seg_states, one.seg_states):
        for rl, ol in zip(blocks.state_leaves(r), blocks.state_leaves(o)):
            rl[:, slot] = ol[:, 0]
    resident.pos[slot] = one.pos
    if resident.ctx is not None:
        resident.ctx[slot] = one.ctx[0]


def _host(v) -> np.ndarray:
    """A wire leaf (tensor on any device, or array) as a host array."""
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


@dataclasses.dataclass
class _PrefillProgress:
    """Host bookkeeping for one slot's in-flight chunked prefill."""

    session: Session
    padded: np.ndarray          # prompt suffix zero-padded to n_chunks * C
    p_len: int                  # suffix length = prompt length - skip
    n_chunks: int
    next_chunk: int
    rows: dict                  # this slot's (1, W) device table rows
    seeds: torch.Tensor | None  # (1,) device seed of the prefill sample
    ctx: torch.Tensor | None    # (1, T_ctx, d) raw (vlm) or encoded
                                # (enc-dec) context, or None
    skip: int = 0               # positions served from shared prefix blocks
    chain: list = dataclasses.field(default_factory=list)
                                # full prompt's (key, parent, tokens) chain
    registered: int = 0         # prompt blocks registered so far


class ServeEngine:
    """Continuous-batching serve engine over one resident paged state.

    Args:
      cfg: ArchConfig. ``quant="xnor"`` archs serve from packed weights
        unless ``pack=False``.
      params: float parameter tree (``lm.init_params`` or
        ``convert.from_jax``); moved to ``device`` and packed there.
      slots: resident batch width (concurrent requests).
      s_max: per-slot cache capacity; a request needs
        ``len(prompt) + max_new_tokens - 1 <= s_max``.
      eos_id: token id that ends a request early (None: budget only).
      temperature: 0 = greedy; > 0 = Gumbel sampling with per-(request,
        step) keys.
      seed: engine sampling seed.
      paged: block-paged KV (default) or the slot-dense layout.
      prefix_cache: content-addressed prefix sharing over the pool,
        auto-disabled for archs whose state cannot be rebuilt from cached
        blocks (``engine.prefix_caching`` reports the effective setting).
      device: ``"cuda"`` (default) or ``"cpu"``; asking for CUDA without
        it raises.
    """

    def __init__(self, cfg, params, *, slots: int, s_max: int,
                 eos_id: int | None = None, temperature: float = 0.0,
                 seed: int = 0, pack: bool = True, paged: bool = True,
                 block_size: int = 0, prefill_chunk: int = 0,
                 n_blocks: int = 0, prefix_cache: bool = True,
                 device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.slots = slots
        self.s_max = s_max
        self.eos_id = eos_id
        self.temperature = float(temperature)
        params = tree_map(lambda t: t.to(self.device), params)
        self.params = lm.pack_params(cfg, params) if pack else params
        self.pool = SlotPool(slots)
        self.sessions: dict[int, Session] = {}
        self.stats = EngineStats()
        self._key = prng.PRNGKey(seed, device=self.device)
        self.paged = bool(paged)
        self._step_idx = 0                 # engine steps since construction
        # host-side mirrors of the device batch (tiny, moved every step)
        self._tokens = np.zeros((slots, 1), np.int32)
        self._active = np.zeros((slots,), bool)
        self._prefilling: dict[int, _PrefillProgress] = {}
        # memoized FIFO-head prefix plan: ((rid, index generation), plan)
        self._plan_cache: tuple[tuple[int, int], tuple] | None = None
        self._dev_tables = None
        if not self.paged:
            self._widths, self._tables = {}, {}
            self.blocks, self._prefix, self._share_cls = None, None, None
            self._state = lm.decode_state_spec(cfg, slots, s_max,
                                               device=self.device,
                                               per_slot_pos=True)
            return
        self.block_size = block_size or cfg.block_size
        self.prefill_chunk = prefill_chunk or cfg.prefill_chunk
        self._widths = lm.paged_table_widths(cfg, s_max, self.block_size,
                                             self.prefill_chunk)
        if n_blocks <= 0:
            # enough for every slot at full table width
            n_blocks = 1 + slots * max(sum(self._widths.values()), 1)
        self.n_blocks = n_blocks
        self.blocks = BlockPool(n_blocks) if self._widths else None
        self.stats.blocks_total = n_blocks - 1 if self.blocks else 0
        self._share_cls = lm.prefix_table_class(cfg)
        self._prefix = (PrefixIndex(self.block_size)
                        if prefix_cache and self.blocks is not None
                        and self._share_cls is not None
                        and lm.prefix_cache_eligible(cfg) else None)
        # host-owned block tables, mirrored to the device on change
        self._tables = {c: np.zeros((slots, w), np.int32)
                        for c, w in self._widths.items()}
        self._state = lm.paged_decode_state_spec(
            cfg, slots, n_blocks=n_blocks, block_size=self.block_size,
            device=self.device)

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _blocks_per_class(self, prompt_len: int,
                          max_new_tokens: int) -> dict[str, int]:
        """Worst-case blocks per table class for one request: positions
        0..P+G-2 are cached; the single source for the admission gate and
        the allocation."""
        nb = -(-(prompt_len + max_new_tokens - 1) // self.block_size)
        return {c: min(nb, w) for c, w in self._widths.items()}

    def _blocks_needed(self, prompt_len: int, max_new_tokens: int) -> int:
        return sum(self._blocks_per_class(prompt_len,
                                          max_new_tokens).values())

    # -- request lifecycle ---------------------------------------------------

    def submit(self, request: Request) -> Session:
        if request.rid in self.sessions:
            raise ValueError(f"duplicate request id {request.rid}")
        need = request.prompt.shape[0] + request.max_new_tokens - 1
        if need > self.s_max:
            raise ValueError(
                f"request {request.rid} needs {need} cache positions, "
                f"engine capacity is s_max={self.s_max}")
        if self.blocks is not None:
            nb = self._blocks_needed(request.prompt.shape[0],
                                     request.max_new_tokens)
            if nb > self.blocks.capacity:
                raise ValueError(
                    f"request {request.rid} needs {nb} blocks, pool "
                    f"capacity is {self.blocks.capacity} "
                    f"(n_blocks={self.n_blocks} incl. trash block)")
        session = Session(request, t_submit=time.monotonic())
        self.sessions[request.rid] = session
        self.pool.submit(session)
        return session

    def _seed_for(self, rid: int, step: int) -> int:
        return (rid * 1_000_003 + step) % (2**31 - 1)

    def _seeds(self, seeds) -> torch.Tensor | None:
        """Sampling seeds on the device; None at temperature 0, where
        nothing is drawn (greedy decode copies no seeds to the card)."""
        if self.temperature <= 0.0:
            return None
        return self._dev(np.asarray(seeds, np.int32))

    def _finish(self, session: Session, reason: str) -> None:
        session.finish_reason = reason
        session.t_done = time.monotonic()
        if session.slot is not None and session.slot in self.pool.active:
            slot = session.slot
            self.pool.evict(slot)
            self._active[slot] = False
            self._tokens[slot] = 0   # dead slots feed a constant token id
            # the zeroed table row routes the dead slot's writes to the
            # trash block; cached blocks park in the pool's idle tier
            if self.blocks is not None:
                if self._prefix is not None:
                    self._register_finished(session, slot)
                self.blocks.free(session.request.rid)
            for t in self._tables.values():
                t[slot, :] = 0
            self._dev_tables = None

    def _register_finished(self, session: Session, slot: int) -> None:
        """Register the request's full written blocks on release — prompt
        and generated region (positions 0..P+G-2 are written)."""
        req = session.request
        written = req.prompt.shape[0] + len(session.tokens) - 1
        seq = req.prompt
        if len(session.tokens) > 1:
            seq = np.concatenate(
                [seq, np.asarray(session.tokens[:-1], np.int32)])
        row = self._tables[self._share_cls][slot]
        for i, (key, parent, toks) in enumerate(
                self._prefix.chain(seq[:written], req.ctx)):
            bid = int(row[i])
            if self._prefix.register(key, parent, bid, toks):
                self.blocks.set_cached(bid)
        self.stats.prefix_cached_blocks = len(self._prefix)

    def _ctx_for(self, req: Request) -> torch.Tensor | None:
        """The request's context on the device, (1, T_ctx, d): an enc-dec
        arch's frames are encoded here once under the paged layout (its
        chunks read the encoded frames; the dense prefill encodes them
        itself).  An arch with ``n_ctx_tokens`` raises without one."""
        if req.ctx is not None:
            ctx = self._dev(np.asarray(req.ctx)[None])
            if self.paged and self.cfg.is_encdec():
                with torch.inference_mode():
                    ctx = lm.encode(self.cfg, self.params, ctx)
            return ctx
        if self.cfg.n_ctx_tokens:
            raise ValueError(
                f"arch {self.cfg.name} needs per-request ctx; request "
                f"{req.rid} has none")
        return None

    def _post_prefill(self, session: Session, slot: int, tok: int) -> bool:
        """Record the prefill-sampled token; True when the request joins
        the decode batch (it did not already finish)."""
        session.tokens.append(tok)
        session.t_first = time.monotonic()
        session.step_first = self._step_idx
        if self.eos_id is not None and tok == self.eos_id:
            self._finish(session, "eos")
            return False
        if session.request.max_new_tokens == 1:
            self._finish(session, "length")
            return False
        self._tokens[slot, 0] = tok
        self._active[slot] = True
        return True

    @property
    def prefix_caching(self) -> bool:
        """Whether prefix sharing is effectively on for this engine."""
        return self._prefix is not None

    # -- session migration ---------------------------------------------------

    def _require_paged(self, what: str) -> None:
        if not self.paged:
            raise RuntimeError(
                f"{what} requires the block-paged layout: the dense layout "
                "has no per-slot block addressing to extract state through")

    def export_session(self, rid: int) -> dict:
        """A live admitted session as a flat wire tree: the slot's blocks
        gathered through its table rows, position, generated tokens,
        chunked-prefill progress and timing.  Leaf names and dtypes are the
        reference's (``meta`` int64 (8,), ``times`` float64 (5,), ``tokens``
        and ``prompt`` int32, ``state`` as :func:`lm.export_slot`, on this
        engine's device, and the request's raw ``ctx`` where it has one),
        so either package restores the other's wire.  A pure read: the
        slot keeps running until :meth:`release_migrated`."""
        self._require_paged("export_session")
        session = self.sessions[rid]
        slot = session.slot
        if slot is None or slot not in self.pool.active:
            raise RuntimeError(
                f"request {rid} is not admitted; queued sessions migrate by "
                "resubmission, finished ones by their tokens")
        prog = self._prefilling.get(slot)
        rows = {c: self._dev(t[slot]) for c, t in self._tables.items()}
        payload = lm.export_slot(self.cfg, self._state, slot, rows)
        req = session.request
        toks = np.zeros((req.max_new_tokens,), np.int32)
        toks[:len(session.tokens)] = session.tokens
        meta = np.array([
            req.rid, req.max_new_tokens, len(session.tokens),
            int(self._active[slot]), int(prog is not None),
            prog.next_chunk if prog is not None else 0,
            prog.skip if prog is not None else 0,
            int(self._tokens[slot, 0]),
        ], np.int64)

        def _t(v):
            return np.nan if v is None else float(v)
        times = np.array([session.t_submit, _t(session.t_admit),
                          _t(session.t_first), _t(session.step_first),
                          _t(session.t_done)], np.float64)
        wire = {"meta": meta, "times": times, "tokens": toks,
                "prompt": np.asarray(req.prompt, np.int32), "state": payload}
        if req.ctx is not None:
            wire["ctx"] = np.asarray(req.ctx)
        return wire

    def export_spec(self, request: Request) -> dict:
        """The shape and dtype tree (``meta`` tensors) of
        :meth:`export_session`'s wire for this geometry: the ``like`` tree
        a migration checkpoint restores against — shapes come from (cfg,
        geometry, request), never from the file."""
        self._require_paged("export_spec")

        def like(shape, dtype):
            return torch.empty(shape, dtype=dtype, device="meta")
        spec = {"meta": like((8,), torch.int64),
                "times": like((5,), torch.float64),
                "tokens": like((request.max_new_tokens,), torch.int32),
                "prompt": like(request.prompt.shape, torch.int32),
                "state": lm.export_slot_spec(self.cfg, self._state,
                                             self._widths)}
        if request.ctx is not None:
            c = np.asarray(request.ctx)
            spec["ctx"] = like(c.shape, torch.from_numpy(c[:0]).dtype)
        return spec

    def release_migrated(self, rid: int) -> None:
        """Drop a session exported elsewhere: free its slot and blocks
        without the finish path (no finish_reason, no t_done, no prefix
        registration; blocks it registered as a donor stay cached)."""
        self._require_paged("release_migrated")
        session = self.sessions.pop(rid)
        slot = session.slot
        self._prefilling.pop(slot, None)
        self.pool.evict(slot)
        self._active[slot] = False
        self._tokens[slot] = 0
        if self.blocks is not None:
            self.blocks.free(rid)
        for t in self._tables.values():
            t[slot, :] = 0
        self._dev_tables = None
        self.stats.migrations_out += 1

    def import_session(self, request: Request, wire: dict) -> Session:
        """Re-admit an exported session token-identically: seat it in a
        free slot, allocate fresh private blocks, scatter the wire's state
        and rebuild the host bookkeeping, mid-chunked-prefill progress
        included.  Identity needs the source's (cfg, s_max, block_size,
        prefill_chunk, temperature, seed); ``slots`` and ``n_blocks`` may
        differ."""
        self._require_paged("import_session")
        rid = request.rid
        if rid in self.sessions:
            raise ValueError(f"duplicate request id {rid}")
        meta = _host(wire["meta"])
        if int(meta[0]) != rid:
            raise ValueError(
                f"wire is for request {int(meta[0])}, not {rid}")
        if not np.array_equal(_host(wire["prompt"]), request.prompt):
            raise ValueError(f"request {rid}: wire prompt differs from the "
                             "submitted prompt")
        p_len = request.prompt.shape[0]
        if p_len + request.max_new_tokens - 1 > self.s_max:
            raise ValueError(f"request {rid} does not fit s_max={self.s_max}")
        if not self.pool.free_slots:
            raise RuntimeError("import_session: no free slot")
        per = self._blocks_per_class(p_len, request.max_new_tokens)
        if self.blocks is not None:
            if sum(per.values()) > self.blocks.reclaimable:
                raise RuntimeError("import_session: not enough free blocks")
        n_tok = int(meta[2])
        times = _host(wire["times"])
        session = Session(request, t_submit=float(times[0]))
        session.tokens = [int(t) for t in _host(wire["tokens"])[:n_tok]]

        def _t(v):
            return None if np.isnan(v) else float(v)
        session.t_admit = _t(times[1])
        session.t_first = _t(times[2])
        session.step_first = None if np.isnan(times[3]) else int(times[3])
        slot = self.pool.free_slots[0]
        self.pool.place(session, slot)
        self.sessions[rid] = session
        if self.blocks is not None:
            fresh = {c: self._alloc_blocks(rid, n) for c, n in per.items()}
            for c, ids in fresh.items():
                row = self._tables[c][slot]
                row[:] = 0
                row[:len(ids)] = ids
            self.stats.fresh_blocks += sum(len(v) for v in fresh.values())
            self.stats.observe_blocks(self.blocks.in_use)
        self._dev_tables = None
        rows = {c: self._dev(t[slot]) for c, t in self._tables.items()}
        lm.import_slot(self.cfg, self._state, slot, rows, wire["state"])
        self._tokens[slot, 0] = int(meta[7])
        self._active[slot] = bool(meta[3])
        if bool(meta[4]):           # mid-chunked-prefill: rebuild progress
            skip, next_chunk = int(meta[6]), int(meta[5])
            c = self.prefill_chunk
            n_suffix = p_len - skip
            n_chunks = -(-n_suffix // c)
            padded = np.zeros((n_chunks * c,), np.int32)
            padded[:n_suffix] = request.prompt[skip:]
            chain = ([] if self._prefix is None
                     else self._prefix.chain(request.prompt, request.ctx))
            self._prefilling[slot] = _PrefillProgress(
                session=session, padded=padded, p_len=n_suffix,
                n_chunks=n_chunks, next_chunk=next_chunk,
                rows=self._slot_table_rows(slot),
                seeds=self._seeds([self._seed_for(rid, 0)]),
                ctx=self._ctx_for(request), skip=skip, chain=chain)
        self.stats.migrations_in += 1
        return session

    def gather_block(self, bid: int) -> tuple:
        """Physical block ``bid`` across every shared pool, on the engine's
        device: the scrubber's unit of verification for idle cached
        blocks."""
        self._require_paged("gather_block")
        return lm.gather_block(self.cfg, self._state, bid)

    # -- admission -----------------------------------------------------------

    def _prefix_plan(self, req: Request) -> tuple[list[int], int, int | None]:
        """``(shared, skip, cow_src)``: the cached blocks the request can
        map read-only, the prompt positions that skips (capped at P-1: the
        last prompt position is always recomputed for its logits), and the
        shared block its first write would land in (the copy-on-write
        source), if any."""
        p_len = req.prompt.shape[0]
        if self._prefix is None:
            return [], 0, None
        ids, n_full, child = self._prefix.lookup(req.prompt, req.ctx)
        shared = list(ids)
        skip = n_full * self.block_size
        if child is not None and (n_full > 0 or child[1] > 0):
            shared.append(child[0])
            skip += child[1]
        skip = min(skip, p_len - 1)
        if skip <= 0:
            return [], 0, None
        w0 = skip // self.block_size
        cow = shared[w0] if w0 < len(shared) else None
        return shared, skip, cow

    def _fresh_needed(self, req: Request,
                      plan: tuple[list[int], int, int | None]) -> dict:
        """Fresh blocks per table class given a plan: shared blocks cost
        nothing, the copy-on-write target one extra."""
        shared, _, cow = plan
        per = self._blocks_per_class(req.prompt.shape[0], req.max_new_tokens)
        if shared:
            per = dict(per)
            per[self._share_cls] -= len(shared) - (1 if cow is not None else 0)
        return per

    def _alloc_blocks(self, rid: int, n: int) -> list[int]:
        """Alloc, reclaiming LRU idle cached blocks when the free list runs
        short (the admission gate checked free + idle covers the need)."""
        short = n - self.blocks.available
        if short > 0:
            for bid in self.blocks.evict_idle(short):
                self._prefix.drop_block(bid)
                self.stats.prefix_evictions += 1
            self.stats.prefix_cached_blocks = len(self._prefix)
        return self.blocks.alloc(rid, n)

    def _head_plan(self, req: Request) -> tuple[list[int], int, int | None]:
        """The FIFO head's plan, memoized on (rid, index generation)."""
        if self._prefix is None:
            return self._prefix_plan(req)
        tag = (req.rid, self._prefix.generation)
        if self._plan_cache is None or self._plan_cache[0] != tag:
            self._plan_cache = (tag, self._prefix_plan(req))
        return self._plan_cache[1]

    def _admissible(self) -> tuple | None:
        """The FIFO head's plan when it can be admitted, else None.  Gates
        on fresh blocks against free + evictable idle, excluding idle
        blocks the plan itself revives; with nothing in flight a plan
        blocked only by that deficit degrades to a wholly fresh one."""
        head = self.pool.peek()
        if head is None or not self.pool.free_slots:
            return None
        plan = self._head_plan(head.request)
        if self.blocks is None:
            return plan
        need = sum(self._fresh_needed(head.request, plan).values())
        revived = sum(1 for b in plan[0] if self.blocks.is_idle(b))
        if need <= self.blocks.reclaimable - revived:
            return plan
        if plan[0] and not self.pool.active:
            fresh = ([], 0, None)
            n = sum(self._fresh_needed(head.request, fresh).values())
            if n <= self.blocks.reclaimable:
                return fresh
        return None

    def _slot_table_rows(self, slot: int) -> dict:
        return {c: self._dev(t[slot:slot + 1]) for c, t in self._tables.items()}

    def _admit(self) -> None:
        """Fill free slots from the queue: chunked prefill under the paged
        layout, else an exact-length batch-1 prefill scattered into the
        slot."""
        if self.paged:
            return self._admit_paged()
        while self.pool.admissible():
            session, slot = self.pool.admit()
            req = session.request
            session.t_admit = time.monotonic()
            with torch.inference_mode():
                logits, one = lm.prefill(self.cfg, self.params,
                                         self._dev(req.prompt[None, :]),
                                         self.s_max, ctx=self._ctx_for(req))
                tok = _sample_tokens(
                    self.cfg, logits, self._key,
                    self._seeds([self._seed_for(req.rid, 0)]),
                    self.temperature)
                self.stats.prefills += 1
                if self._post_prefill(session, slot, int(tok[0, 0])):
                    _insert_slot(self._state, one, slot)

    def _admit_paged(self) -> None:
        """Map the head's shared prefix blocks, reserve fresh blocks,
        copy-on-write the divergence block, and queue the chunked prefill
        of the unshared suffix (dispatched one chunk per step)."""
        while (plan := self._admissible()) is not None:
            session, slot = self.pool.admit()
            req = session.request
            session.t_admit = time.monotonic()
            p_len = req.prompt.shape[0]
            shared, skip, cow_src = plan
            if self.blocks is not None:
                if shared:
                    self.blocks.share(req.rid, shared)
                fresh = {cls_name: self._alloc_blocks(req.rid, n)
                         for cls_name, n in
                         self._fresh_needed(req, plan).items()}
                for cls_name, ids in fresh.items():
                    row = self._tables[cls_name][slot]
                    row[:] = 0
                    if cls_name == self._share_cls and shared:
                        row[:len(shared)] = shared
                        tail = ids
                        if cow_src is not None:
                            # repoint the first-write block at a private
                            # copy, made below before any later launch
                            row[skip // self.block_size] = ids[0]
                            tail = ids[1:]
                        row[len(shared):len(shared) + len(tail)] = tail
                    else:
                        row[:len(ids)] = ids
                self._dev_tables = None
                if cow_src is not None:
                    lm.paged_copy_block(self.cfg, self._state, cow_src,
                                        fresh[self._share_cls][0])
                    self.blocks.drop(req.rid, cow_src)
                    self.stats.cow_copies += 1
                self.stats.fresh_blocks += sum(len(v) for v in fresh.values())
                self.stats.observe_blocks(self.blocks.in_use)
            self.stats.prompt_tokens += p_len
            if shared:
                self.stats.prefix_hits += 1
                self.stats.prefix_shared_blocks += len(shared)
                self.stats.prefix_tokens += skip
            c = self.prefill_chunk
            n_suffix = p_len - skip
            n_chunks = -(-n_suffix // c)
            padded = np.zeros((n_chunks * c,), np.int32)
            padded[:n_suffix] = req.prompt[skip:]
            chain = ([] if self._prefix is None
                     else self._prefix.chain(req.prompt, req.ctx))
            self._prefilling[slot] = _PrefillProgress(
                session=session, padded=padded, p_len=n_suffix,
                n_chunks=n_chunks, next_chunk=0,
                rows=self._slot_table_rows(slot),
                seeds=self._seeds([self._seed_for(req.rid, 0)]),
                ctx=self._ctx_for(req), skip=skip, chain=chain)
            self.stats.prefills += 1

    def _register_upto(self, prog: _PrefillProgress, slot: int,
                       n_done: int) -> None:
        """Register the prompt's first ``n_done`` full blocks.  Launches run
        in issue order on the stream, so a later sharer's reads see the
        content the key promises, even from a still-prefilling donor."""
        row = self._tables[self._share_cls][slot]
        n = min(n_done, len(prog.chain))
        while prog.registered < n:
            key, parent, toks = prog.chain[prog.registered]
            bid = int(row[prog.registered])
            if self._prefix.register(key, parent, bid, toks):
                self.blocks.set_cached(bid)
            prog.registered += 1
        self.stats.prefix_cached_blocks = len(self._prefix)

    @torch.inference_mode()
    def _prefill_step(self) -> None:
        """Advance every in-flight chunked prefill by exactly one chunk; a
        prompt that finishes joins the decode batch this same step."""
        for slot in sorted(self._prefilling):
            prog = self._prefilling[slot]
            c = self.prefill_chunk
            j = prog.next_chunk
            piece = self._dev(prog.padded[None, j * c:(j + 1) * c])
            n_valid = min(c, prog.p_len - j * c)
            logits, self._state = lm.prefill_chunk_step(
                self.cfg, self.params, piece, self._state, slot, n_valid,
                prog.rows, fresh=j == 0, start=prog.skip, ctx=prog.ctx)
            self.stats.prefill_chunks += 1
            prog.next_chunk += 1
            if self._prefix is not None:
                done = prog.skip + min((j + 1) * c, prog.p_len)
                self._register_upto(prog, slot, done // self.block_size)
            if prog.next_chunk == prog.n_chunks:
                del self._prefilling[slot]
                tok = _sample_tokens(self.cfg, logits, self._key, prog.seeds,
                                     self.temperature)
                self._post_prefill(prog.session, slot, int(tok[0, 0]))

    def _device_tables(self) -> dict:
        if self._dev_tables is None:
            self._dev_tables = {c: self._dev(t)
                                for c, t in self._tables.items()}
        return self._dev_tables

    def decode_roofline(self) -> dict:
        """Roofline audit of this engine's decode step (nothing runs).

        Traces one paged decode step and its sampling on ``meta`` copies
        of the engine's parameters, state, tables, tokens and seeds, under
        ``cuda.dry_run`` with the branches of the engine's device, and
        returns the ``analysis.roofline`` dict with the step's analytic
        byte floor (``roofline_bytes``), ``achieved_bytes`` and
        ``dispatches``, also kept in ``stats.decode_dispatches``.  Nothing
        else moves: the state, the pool and the launch counts stay as
        they were."""
        if not self.paged:
            raise ValueError("decode_roofline needs the paged layout")
        from repro_torch.roofline import analysis
        cfg, temperature = self.cfg, self.temperature

        def meta(t):
            if isinstance(t, PackedLinear):
                return PackedLinear(meta(t.pb), meta(t.beta), t.k)
            return torch.empty_like(t, device="meta")

        def fn(params, tokens, state, tables, active, key, seeds):
            logits, state = lm.paged_decode_step(cfg, params, tokens, state,
                                                 tables, active=active)
            return _sample_tokens(cfg, logits, key, seeds, temperature), state

        state = lm.DecodeState(
            meta(self._state.pos),
            [blocks.state_map(meta, s) for s in self._state.seg_states],
            None if self._state.ctx is None else meta(self._state.ctx))
        args = (tree_map(meta, self.params),
                torch.empty((self.slots, 1), dtype=torch.int32,
                            device="meta"),
                state, {c: torch.empty(t.shape, dtype=torch.int32,
                                       device="meta")
                        for c, t in self._tables.items()},
                torch.empty((self.slots,), dtype=torch.bool, device="meta"),
                meta(self._key),
                torch.empty((self.slots,), dtype=torch.int32, device="meta"))
        with torch.inference_mode():
            _, counter = analysis.trace(fn, *args,
                                        card=cuda.on_card(self.device))
        r = analysis.roofline(counter)
        self.stats.decode_dispatches = counter.dispatches
        kv_itemsize = 1 if cfg.kv_cache_dtype == "i8" else cfg.dtype.itemsize
        r["roofline_bytes"] = analysis.decode_roofline_bytes(
            param_bytes=analysis.tree_bytes(self.params), widths=self._widths,
            layers_per_class=lm.paged_decode_layer_classes(cfg),
            slots=self.slots, block_size=self.block_size,
            n_kv_heads=cfg.n_kv_heads, d_head=cfg.d_head,
            kv_itemsize=kv_itemsize)
        r["achieved_bytes"] = r["hlo_bytes_per_chip"]
        r["dispatches"] = self.stats.decode_dispatches
        return r

    @torch.inference_mode()
    def _decode_once(self) -> None:
        """One batched decode step; slots still mid-prefill ride along
        inertly (their writes go to the trash block)."""
        active_sessions = {s: sess for s, sess in self.pool.active.items()
                           if s not in self._prefilling}
        seeds = None
        if self.temperature > 0.0:
            seeds = np.zeros((self.slots,), np.int32)
            for slot, sess in active_sessions.items():
                seeds[slot] = self._seed_for(sess.request.rid,
                                             len(sess.tokens))
        tokens, active = self._dev(self._tokens), self._dev(self._active)
        if self.paged:
            logits, self._state = lm.paged_decode_step(
                self.cfg, self.params, tokens, self._state,
                self._device_tables(), active=active)
            if self.blocks is not None:
                self.stats.observe_blocks(self.blocks.in_use)
        else:
            logits, self._state = lm.decode_step(
                self.cfg, self.params, tokens, self._state, active=active)
        self.stats.decode_steps += 1
        toks = _sample_tokens(self.cfg, logits, self._key, self._seeds(seeds),
                              self.temperature).cpu().numpy()  # step's sync
        for slot, sess in active_sessions.items():
            t = int(toks[slot, 0])
            sess.tokens.append(t)
            self._tokens[slot, 0] = t
            if self.eos_id is not None and t == self.eos_id:
                self._finish(sess, "eos")
            elif len(sess.tokens) >= sess.request.max_new_tokens:
                self._finish(sess, "length")

    def step(self) -> bool:
        """Admit, advance in-flight prefills by one chunk each, then decode
        once; returns False when fully drained."""
        self._step_idx += 1
        self._admit()
        if self._prefilling:
            self._prefill_step()
        if any(s not in self._prefilling for s in self.pool.active):
            self._decode_once()
        return not self.pool.idle()

    def run(self) -> ServeReport:
        """Drain queue + slots; returns the per-request report."""
        t0 = time.monotonic()
        while self.step():
            pass
        return ServeReport(sessions=dict(self.sessions),
                           wall=time.monotonic() - t0,
                           decode_steps=self.stats.decode_steps,
                           prefills=self.stats.prefills,
                           stats=self.stats)
