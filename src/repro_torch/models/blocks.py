"""Decoder blocks and the per-segment machinery of the serve path.

A model's depth plan is a list of (kind, count) segments
(``ArchConfig.segments()``); a segment's parameters are stacked on a
leading layer axis, and the segment runs as a Python loop over it.  Only
the ``attn`` kind (GQA self-attention + SwiGLU FFN) is ported so far.

Every kind implements:
  defs(cfg, n)                                stacked ParamDefs
  fwd(cfg, p, x, opts)                        full sequence -> (x, state)
  decode(cfg, p, x, state, pos, table, valid) one token per slot; dense
                                              cache when ``table`` is None
  chunk(cfg, p, x, state, pos0, valid, table) one chunked-prefill piece
  state_spec(cfg, n, batch, s_max, device)    dense decode state
  paged_state_spec(cfg, n, n_blocks, block_size, device)
and, from :class:`PagedLayout`, the session migration surface
(``export_slot`` / ``import_slot``).  States are updated in place.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models import layers, registry
from repro_torch.models.attention import KVCache, PagedKVCache
from repro_torch.models.params import ParamDef
from repro_torch.models.registry import BlockContract, register


class FwdOpts(NamedTuple):
    want_state: bool = False  # prefill: return the decode state
    s_max: int = 0            # cache capacity when want_state


def _norm_def(cfg, n):
    return ParamDef((n, cfg.d_model), torch.float32, init="ones")


def _sub(p: dict, prefix: str) -> dict:
    cut = len(prefix)
    return {k[cut:]: v for k, v in p.items() if k.startswith(prefix)}


def layer_params(p: dict, i: int) -> dict:
    """Layer ``i`` of a segment's stacked parameters (views, no copies)."""
    return {k: v[i] for k, v in p.items()}


def _kv_from_seq(cfg, k, v, s_max: int, rolling: bool = False) -> KVCache:
    """(B, S, KV, dh) k/v -> one layer's KVCache of capacity ``s_max``.
    ``rolling`` (local windows) keeps the trailing ``s_max`` tokens laid
    out so that slot == position % s_max."""
    s = k.shape[1]
    if rolling and s > s_max:
        shift = s % s_max
        k = torch.roll(k[:, -s_max:], shift, dims=1)
        v = torch.roll(v[:, -s_max:], shift, dims=1)
    ck, cv = k.transpose(1, 2), v.transpose(1, 2)
    pad = s_max - ck.shape[2]
    if pad > 0:
        ck = torch.nn.functional.pad(ck, (0, 0, 0, pad))
        cv = torch.nn.functional.pad(cv, (0, 0, 0, pad))
    if cfg.kv_cache_dtype == "i8":
        return KVCache(attn_mod.i8_encode(cfg, ck), attn_mod.i8_encode(cfg, cv))
    return KVCache(ck.to(cfg.dtype).contiguous(), cv.to(cfg.dtype).contiguous())


def _kv_dtype(cfg) -> torch.dtype:
    return torch.int8 if cfg.kv_cache_dtype == "i8" else cfg.dtype


class PagedLayout:
    """Serving state derived from the kind's contract: a kind with
    ``paged_kv`` keeps one layer-stacked :class:`PagedKVCache` pool per
    segment (the paged layout) or one :class:`KVCache` (the dense one).
    Per-slot dense state is not ported yet."""

    @classmethod
    def _require_ported(cls):
        c = cls.contract
        if c.per_slot_state:
            raise NotImplementedError(
                f"kind {c.kind!r}: per-slot decode state is not ported")

    @classmethod
    def paged_state_spec(cls, cfg, n, n_blocks, block_size, device):
        cls._require_ported()
        if not cls.contract.paged_kv:
            return None
        return PagedKVCache.zeros(cfg, n_blocks, block_size, _kv_dtype(cfg),
                                  device, n)

    @classmethod
    def state_spec(cls, cfg, n, batch, s_max, device):
        cls._require_ported()
        if not cls.contract.paged_kv:
            return None
        return KVCache.zeros(cfg, batch, s_max, _kv_dtype(cfg), device, n)

    # -- slot extraction / injection (session migration) ---------------------

    @classmethod
    def export_slot(cls, state, ids: torch.Tensor):
        """One slot's state out of the layer-stacked paged pool ->
        ``(shared, None)``, the reference's ``(shared, per_slot)`` pair with
        no per-slot leaves: pool blocks gathered in table-row order through
        ``ids`` (the slot's full (W,) row; unused entries name the trash
        block 0, whose garbage travels along and is never read).  A pure
        gather."""
        idx = ids.to(state[0].device, torch.int64)
        return (type(state)(*(l.index_select(1, idx) for l in state)), None)

    @classmethod
    def import_slot(cls, state, ids: torch.Tensor, payload) -> None:
        """Inverse of :meth:`export_slot`, in place: the payload's blocks
        go to the *destination* row ``ids`` (same width, fresh ids; unused
        entries 0, so the carried garbage lands in the trash block)."""
        idx = ids.to(state[0].device, torch.int64)
        for l, q in zip(state, payload[0]):
            l[:, idx] = q.to(l.device, l.dtype)


@register
class AttnBlock(PagedLayout):
    contract = BlockContract("attn", paged_kv=True, table_class="full",
                             prefix_shareable=True)

    @classmethod
    def defs(cls, cfg, n):
        defs = {"ln1": _norm_def(cfg, n), "ln2": _norm_def(cfg, n)}
        defs |= {f"attn_{k}": v for k, v in attn_mod.attn_defs(cfg, n).items()}
        defs |= {f"ffn_{k}": v for k, v in layers.ffn_defs(cfg, n).items()}
        return defs

    @classmethod
    def _ffn(cls, cfg, p, x, a):
        """The residual around attention output ``a`` and the FFN.  ln2
        reads the residual sum in f32, unrounded: XLA folds the bf16
        rounding of x + a into the norm's cast to f32 (it allows excess
        precision), while the residual stream itself stays rounded."""
        h = layers.rms_norm(x.float() + a, p["ln2"], dtype=x.dtype)
        x = x + a
        return x + layers.ffn(cfg, _sub(p, "ffn_"), h)

    @classmethod
    def fwd(cls, cfg, p, x, opts: FwdOpts):
        """Full-sequence prefill: x (B, S, d) -> (x, KVCache or None)."""
        h = layers.rms_norm(x, p["ln1"])
        ap = _sub(p, "attn_")
        state = None
        if opts.want_state:
            positions = torch.arange(h.shape[1], device=h.device)
            k, v = attn_mod._project_kv(cfg, ap, h, positions)
            state = _kv_from_seq(cfg, k, v, opts.s_max)
        a = attn_mod.attention(cfg, ap, h, causal=True)
        return cls._ffn(cfg, p, x, a), state

    @classmethod
    def decode(cls, cfg, p, x, state, pos, table, valid=None):
        """One token per slot; ``table`` None reads the dense cache."""
        h = layers.rms_norm(x, p["ln1"])
        if table is None:
            a = attn_mod.decode_attention(cfg, _sub(p, "attn_"), h, state,
                                          pos)
        else:
            a = attn_mod.paged_attention(cfg, _sub(p, "attn_"), h, state,
                                         table, pos, valid=valid)
        return cls._ffn(cfg, p, x, a)

    @classmethod
    def chunk(cls, cfg, p, x, state, pos0, valid, table):
        """One chunked-prefill piece: x (1, C, d) at positions
        pos0 .. pos0 + C - 1; ``valid`` (1, C) marks the real tokens."""
        h = layers.rms_norm(x, p["ln1"])
        a = attn_mod.paged_attention(cfg, _sub(p, "attn_"), h, state, table,
                                     pos0, valid=valid)
        return cls._ffn(cfg, p, x, a)


# ---------------------------------------------------------------------------
# segment machinery
# ---------------------------------------------------------------------------

def segment_defs(cfg, segments=None) -> list:
    return [(kind, n, registry.get(kind).defs(cfg, n))
            for kind, n in (segments or cfg.segments())]


def segment_fwd(cfg, seg_params: list, x, opts: FwdOpts = FwdOpts()):
    """Every segment over a full sequence -> (x, per-segment layer-stacked
    states, or Nones without ``opts.want_state``)."""
    states = []
    for (kind, n), p in seg_params:
        block = registry.get(kind)
        sts = []
        for i in range(n):
            x, st = block.fwd(cfg, layer_params(p, i), x, opts)
            sts.append(st)
        states.append(None if sts[0] is None else
                      type(sts[0])(*(torch.stack(ls) for ls in zip(*sts))))
    return x, states


def _block_table(block, tables):
    """The block's (B, W) table under paged serving, else None — resolved
    through its declared table class."""
    if tables is None or not block.contract.paged_kv:
        return None
    return tables[block.contract.table_class]


def _layer_state(state, i):
    return None if state is None else state.layer(i)


def segment_decode(cfg, seg_params: list, x, states: list, pos,
                   tables: dict | None = None, active=None):
    """One token for every slot through every segment.  ``tables`` None
    reads the dense caches; otherwise the attn-family blocks go through
    their block tables.  ``active`` (B,) bool trash-routes inactive slots'
    paged writes (a dense cache's dead rows are inert by overwrite)."""
    valid = None if active is None else active[:, None]
    for ((kind, n), p), st in zip(seg_params, states):
        block = registry.get(kind)
        table = _block_table(block, tables)
        for i in range(n):
            x = block.decode(cfg, layer_params(p, i), x, _layer_state(st, i),
                             pos, table, valid=valid)
    return x


def segment_chunk(cfg, seg_params: list, x, states: list, pos0, valid,
                  tables: dict):
    """One chunked-prefill piece (B=1, S=C) through every segment;
    ``tables`` rows are this slot's (1, W) rows."""
    for ((kind, n), p), st in zip(seg_params, states):
        block = registry.get(kind)
        table = _block_table(block, tables)
        for i in range(n):
            x = block.chunk(cfg, layer_params(p, i), x, _layer_state(st, i),
                            pos0, valid, table)
    return x


def segment_copy_block(cfg, states: list, src: int, dst: int) -> None:
    """Copy physical block ``src`` -> ``dst`` in every shared pool (the
    device half of copy-on-write prefix sharing).  Block ids are unique
    across table classes, so copying in every pool is safe."""
    for st in states:
        if st is not None:
            st.copy_block(src, dst)


def segment_export_slot(cfg, states: list, ids: dict) -> tuple:
    """One slot's state out of every segment: ``ids`` maps table class ->
    the slot's full (W,) row, resolved through each kind's contract.
    Returns a tuple of per-segment ``(shared, per_slot)`` payloads."""
    return tuple(registry.get(kind).export_slot(
        st, ids[registry.get(kind).contract.table_class])
        for (kind, _), st in zip(cfg.segments(), states))


def segment_import_slot(cfg, states: list, ids: dict, payloads) -> None:
    """Inverse of :func:`segment_export_slot`, in place, into the
    destination rows ``ids``."""
    for (kind, _), st, pl in zip(cfg.segments(), states, payloads):
        block = registry.get(kind)
        block.import_slot(st, ids[block.contract.table_class], pl)


def segment_gather_block(cfg, states: list, bid: int) -> tuple:
    """Physical block ``bid`` of every shared pool (None for segments with
    no pool): the integrity scrubber's view of an idle cached block."""
    out = []
    for st in states:
        out.append(None if st is None
                   else type(st)(*(l[:, bid].clone() for l in st)))
    return tuple(out)


def segment_states(cfg, segments, batch: int, s_max: int, device) -> list:
    """Dense decode states per segment, layer-stacked:
    ``(n, batch, KV, s_max, dh)`` caches."""
    return [registry.get(kind).state_spec(cfg, n, batch, s_max, device)
            for kind, n in segments]


def segment_paged_states(cfg, segments, n_blocks: int, block_size: int,
                         device) -> list:
    """Layer-stacked paged pools per segment
    ``(n, n_blocks, KV, block_size, dh)``."""
    return [registry.get(kind).paged_state_spec(cfg, n, n_blocks, block_size,
                                                device)
            for kind, n in segments]
