"""Decoder blocks and the per-segment machinery of the paged serve path.

A model's depth plan is a list of (kind, count) segments
(``ArchConfig.segments()``); a segment's parameters are stacked on a
leading layer axis, and the segment runs as a Python loop over it.  Only
the ``attn`` kind (GQA self-attention + SwiGLU FFN) is ported so far.

Every kind implements, for paged serving:
  defs(cfg, n)                               stacked ParamDefs
  decode(cfg, p, x, state, pos, table, valid) one token per slot
  chunk(cfg, p, x, state, pos0, valid, table) one chunked-prefill piece
  paged_state_spec(cfg, n, n_blocks, block_size, device)
"""

from __future__ import annotations

import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models import layers, registry
from repro_torch.models.attention import PagedKVCache
from repro_torch.models.params import ParamDef
from repro_torch.models.registry import BlockContract, register


def _norm_def(cfg, n):
    return ParamDef((n, cfg.d_model), torch.float32, init="ones")


def _sub(p: dict, prefix: str) -> dict:
    cut = len(prefix)
    return {k[cut:]: v for k, v in p.items() if k.startswith(prefix)}


def layer_params(p: dict, i: int) -> dict:
    """Layer ``i`` of a segment's stacked parameters (views, no copies)."""
    return {k: v[i] for k, v in p.items()}


class PagedLayout:
    """Paged-serving state derived from the kind's contract: a kind with
    ``paged_kv`` keeps one layer-stacked :class:`PagedKVCache` pool per
    segment.  Per-slot dense state is not ported yet."""

    @classmethod
    def paged_state_spec(cls, cfg, n, n_blocks, block_size, device):
        c = cls.contract
        if c.per_slot_state:
            raise NotImplementedError(
                f"kind {c.kind!r}: per-slot decode state is not ported")
        if not c.paged_kv:
            return None
        dt = torch.int8 if cfg.kv_cache_dtype == "i8" else cfg.dtype
        return PagedKVCache.zeros(cfg, n_blocks, block_size, dt, device, n)


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
    def _attn_ffn(cls, cfg, p, x, state, table, pos, valid):
        h = layers.rms_norm(x, p["ln1"])
        x = x + attn_mod.paged_attention(cfg, _sub(p, "attn_"), h, state,
                                         table, pos, valid=valid)
        h = layers.rms_norm(x, p["ln2"])
        return x + layers.ffn(cfg, _sub(p, "ffn_"), h)

    @classmethod
    def decode(cls, cfg, p, x, state, pos, table, valid=None):
        return cls._attn_ffn(cfg, p, x, state, table, pos, valid)

    @classmethod
    def chunk(cls, cfg, p, x, state, pos0, valid, table):
        """One chunked-prefill piece: x (1, C, d) at positions
        pos0 .. pos0 + C - 1; ``valid`` (1, C) marks the real tokens."""
        return cls._attn_ffn(cfg, p, x, state, table, pos0, valid)


# ---------------------------------------------------------------------------
# segment machinery
# ---------------------------------------------------------------------------

def segment_defs(cfg, segments=None) -> list:
    return [(kind, n, registry.get(kind).defs(cfg, n))
            for kind, n in (segments or cfg.segments())]


def _block_table(block, tables):
    """The block's table, resolved through its declared table class."""
    if not block.contract.paged_kv:
        return None
    return tables[block.contract.table_class]


def _layer_state(state, i):
    return None if state is None else state.layer(i)


def segment_decode(cfg, seg_params: list, x, states: list, pos, tables: dict,
                   active=None):
    """One token for every slot through every segment.  ``active`` (B,)
    bool trash-routes inactive slots' KV writes (mid-prefill and dead slots
    ride along in the batch)."""
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


def segment_paged_states(cfg, segments, n_blocks: int, block_size: int,
                         device) -> list:
    """Layer-stacked paged pools per segment
    ``(n, n_blocks, KV, block_size, dh)``."""
    return [registry.get(kind).paged_state_spec(cfg, n, n_blocks, block_size,
                                                device)
            for kind, n in segments]
