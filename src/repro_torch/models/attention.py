"""GQA attention: full-sequence prefill, decode against a slot-dense KV
cache, decode / chunked prefill through the block-paged pool, and
cross-attention to a request's modality context.

Layouts, as in the JAX package:
  q            (B, S, H, dh)
  k, v         (B, S, KV, dh) — compact GQA form; expanded to (B, S, H,
               dh) only in the full-sequence path
  KV cache     (B, KV, S_max, dh) — the dense decode layout
  paged pool   (n_blocks, KV, block_size, dh) — shared, no batch axis,
               addressed through per-slot int32 block tables
  ctx_kv       (k, v) each (B, T_ctx, KV, dh) — the context's keys and
               values, projected once a sequence (no RoPE)
Scores accumulate in f32; softmax is f32.  The reference computes the
dense products with ``einsum`` outside any kernel, so the dense path is
plain PyTorch on every device, in the reference's rounding order.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import ops, paged_attn
from repro_torch.models import layers
from repro_torch.models.params import ParamDef

NEG_INF = -1e30


def i8_encode(cfg, x: torch.Tensor) -> torch.Tensor:
    """Fixed-point encode for the int8 cache (scale ``cfg.kv_i8_scale``)."""
    return torch.clamp(torch.round(x.float() * cfg.kv_i8_scale),
                       -127, 127).to(torch.int8)


def attn_defs(cfg, n: int, cross: bool = False) -> dict:
    """Stacked projections; the cross projections (``cross``) carry no
    q/k/v bias."""
    d, H, KV, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    defs = {
        "wq": ParamDef((n, d, H * dh), cfg.dtype, binarize=True),
        "wk": ParamDef((n, d, KV * dh), cfg.dtype, binarize=True),
        "wv": ParamDef((n, d, KV * dh), cfg.dtype, binarize=True),
        "wo": ParamDef((n, H * dh, d), cfg.dtype, binarize=True),
    }
    if cfg.qkv_bias and not cross:
        defs |= {
            "bq": ParamDef((n, H * dh), cfg.dtype, init="zeros"),
            "bk": ParamDef((n, KV * dh), cfg.dtype, init="zeros"),
            "bv": ParamDef((n, KV * dh), cfg.dtype, init="zeros"),
        }
    if cfg.qk_norm:
        defs |= {
            "q_norm": ParamDef((n, dh), torch.float32, init="ones"),
            "k_norm": ParamDef((n, dh), torch.float32, init="ones"),
        }
    return defs


def _project_q(cfg, p, x, positions):
    """-> (B, S, H, dh); ``positions`` None applies no RoPE."""
    b, s, _ = x.shape
    q = layers.linear(x, p["wq"], cfg.quant, p.get("bq"))
    q = q.reshape(b, s, cfg.n_heads, cfg.d_head)
    if cfg.qk_norm:
        q = layers.rms_norm(q, p["q_norm"])
    if positions is None:
        return q
    return layers.apply_rope(q, positions, cfg.rope_theta)


def _project_kv(cfg, p, x, positions):
    """-> k, v each (B, S, KV, dh); ``positions`` None applies no RoPE."""
    b, s, _ = x.shape
    k = layers.linear(x, p["wk"], cfg.quant, p.get("bk"))
    v = layers.linear(x, p["wv"], cfg.quant, p.get("bv"))
    k = k.reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    v = v.reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    if cfg.qk_norm:
        k = layers.rms_norm(k, p["k_norm"])
    if positions is None:
        return k, v
    return layers.apply_rope(k, positions, cfg.rope_theta), v


def _expand_kv(cfg, k, v):
    """(B, S, KV, dh) -> (B, S, H, dh): repeat each KV head q_per_kv times."""
    if cfg.q_per_kv == 1:
        return k, v
    return (torch.repeat_interleave(k, cfg.q_per_kv, dim=2),
            torch.repeat_interleave(v, cfg.q_per_kv, dim=2))


def _sdpa(cfg, q, k, v, mask):
    """q (B, Sq, H, dh), k/v (B, Sk, H, dh), mask (1|B, Sq, Sk) or None;
    f32 scores and softmax, P rounded to v's dtype before P.V."""
    scale = cfg.d_head ** -0.5
    scores = torch.einsum("bqhd,bshd->bhqs", q.float(), k.float()) * scale
    if mask is not None:
        scores = torch.where(mask[:, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqs,bshd->bqhd", probs.to(v.dtype).float(),
                       v.float())
    return out.to(q.dtype)


def _causal_mask(sq: int, sk: int, q0: int, window: int = 0, device=None):
    """(1, sq, sk) bool: query i (position q0 + i) sees key j iff
    j <= q0 + i and (no window or j > q0 + i - window)."""
    qpos = q0 + torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    m = kpos <= qpos
    if window:
        m &= kpos > qpos - window
    return m[None]


def attention(cfg, p: dict, x: torch.Tensor, *, causal: bool = True,
              window: int = 0, q_chunk: int = 0,
              positions: torch.Tensor | None = None) -> torch.Tensor:
    """Self-attention over a full sequence (training, prefill): x (B, S, d)
    -> (B, S, d).

    ``q_chunk > 0`` (with S > q_chunk, a multiple of it) runs the queries
    in chunks of that size, bounding the live scores to q_chunk x S; a
    window that is a multiple of q_chunk slices each chunk's keys to the
    ``window + q_chunk`` band that reaches it (:func:`_band_mask`)
    instead of masking the whole sequence."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)
    q = _project_q(cfg, p, x, positions)
    k, v = _expand_kv(cfg, *_project_kv(cfg, p, x, positions))
    if not q_chunk or s <= q_chunk:
        mask = _causal_mask(s, s, 0, window, x.device) if causal else None
        out = _sdpa(cfg, q, k, v, mask)
    else:
        if s % q_chunk:
            raise ValueError(f"sequence {s} is not a multiple of "
                             f"q_chunk {q_chunk}")
        outs = []
        for q0 in range(0, s, q_chunk):
            qc = q[:, q0:q0 + q_chunk]
            if window and window % q_chunk == 0:
                span = window + q_chunk
                k0 = max(q0 + q_chunk - span, 0)
                mask = _band_mask(q_chunk, span, q0, k0, window, x.device)
                outs.append(_sdpa(cfg, qc, k[:, k0:k0 + span],
                                  v[:, k0:k0 + span], mask))
            else:
                mask = (_causal_mask(q_chunk, s, q0, window, x.device)
                        if causal else None)
                outs.append(_sdpa(cfg, qc, k, v, mask))
        out = torch.cat(outs, dim=1)
    return layers.linear(out.reshape(b, s, cfg.n_heads * cfg.d_head),
                         p["wo"], cfg.quant)


def _band_mask(sq: int, span: int, q0: int, k0: int, window: int,
               device=None):
    """(1, sq, span) bool for a query chunk at q0 against the keys
    k0 .. k0 + span - 1 (``k0`` already clamped at 0): causal within the
    trailing window."""
    qpos = q0 + torch.arange(sq, device=device)[:, None]
    kpos = k0 + torch.arange(span, device=device)[None, :]
    return ((kpos <= qpos) & (kpos > qpos - window))[None]


def cross_attention(cfg, p: dict, x: torch.Tensor, ctx_kv) -> torch.Tensor:
    """x (B, S, d) attends to every context token, no mask and no RoPE
    across modalities: ``ctx_kv`` is (k, v) each (B, T_ctx, KV, dh) from
    :func:`make_ctx_kv`.  -> (B, S, d).  The reference computes it with
    its ``_sdpa`` einsums outside any kernel, so the port is plain PyTorch
    on every device, in the same rounding order."""
    b, s, _ = x.shape
    q = _project_q(cfg, p, x, None)
    out = _sdpa(cfg, q, *_expand_kv(cfg, *ctx_kv), None)
    return layers.linear(out.reshape(b, s, cfg.n_heads * cfg.d_head),
                         p["wo"], cfg.quant)


def make_ctx_kv(cfg, p: dict, ctx: torch.Tensor):
    """The context's keys and values: ctx (B, T_ctx, d) -> (k, v) each
    (B, T_ctx, KV, dh), projected once and kept as per-slot state."""
    return _project_kv(cfg, p, ctx, None)


def decode_cross_attention(cfg, p: dict, x: torch.Tensor,
                           ctx_kv) -> torch.Tensor:
    """One token per slot against the slot's resident ``ctx_kv``, x (B, S,
    d) -> (B, S, d).  Each slot's score and P.V products and softmax run
    alone, at a batch of one: library products over B x H rows pick their
    kernel, and with it the order of their sums, by the batch (hazard H2;
    phase 2 of ``chip_smoke.py`` prints how far the batched form departs),
    and a session must keep its bits in an engine of other ``slots``.  The
    projections are row by row already.  A KV head's G query heads read
    its keys and values in place, not expanded as :func:`cross_attention`
    expands them; scores and softmax are f32 and P is rounded to v's dtype
    before P.V, as in ``_sdpa``."""
    b, s, _ = x.shape
    q = _project_q(cfg, p, x, None).reshape(b, s, cfg.n_kv_heads,
                                            cfg.q_per_kv, cfg.d_head)
    scale = cfg.d_head ** -0.5
    out = []
    for j in range(b):
        k, v = (t[j:j + 1] for t in ctx_kv)
        scores = torch.einsum("bqkgd,bskd->bkgqs", q[j:j + 1].float(),
                              k.float()) * scale
        probs = torch.softmax(scores, dim=-1)
        out.append(torch.einsum("bkgqs,bskd->bqkgd",
                                probs.to(v.dtype).float(), v.float()))
    out = torch.cat(out).to(q.dtype)
    return layers.linear(out.reshape(b, s, cfg.n_heads * cfg.d_head),
                         p["wo"], cfg.quant)


class KVCache(NamedTuple):
    """The dense decode cache: per-slot rows (B, KV, S_max, dh), layer-
    stacked in a segment as (n_layers, B, KV, S_max, dh).  Updated in
    place, like the paged pools."""

    k: torch.Tensor
    v: torch.Tensor

    @classmethod
    def zeros(cls, cfg, batch: int, s_max: int, dtype, device,
              n_layers: int):
        shp = (n_layers, batch, cfg.n_kv_heads, s_max, cfg.d_head)
        return cls(torch.zeros(shp, dtype=dtype, device=device),
                   torch.zeros(shp, dtype=dtype, device=device))


def decode_attention(cfg, p: dict, x: torch.Tensor, cache: KVCache,
                     pos: torch.Tensor, window: int = 0) -> torch.Tensor:
    """One token per row against a resident dense cache.

    x (B, 1, d); ``pos`` a scalar (homogeneous batch) or (B,) per-slot
    positions: the cache holds ``pos`` valid entries before the call.  The
    new key and value are written in place at ``pos`` (``pos % s_max`` for
    a rolling window buffer).  Returns (B, 1, d)."""
    b = x.shape[0]
    s_max = cache.k.shape[2]
    pos_b = pos.to(torch.int64).expand(b)
    positions = pos_b[:, None]
    q = _project_q(cfg, p, x, positions)                  # (B, 1, H, dh)
    q = q.reshape(b, 1, cfg.n_kv_heads, cfg.q_per_kv, cfg.d_head)
    k, v = _project_kv(cfg, p, x, positions)

    slot_b = pos_b % s_max if window else pos_b
    knew, vnew = k[:, 0], v[:, 0]                          # (B, KV, dh)
    i8 = cache.k.dtype == torch.int8
    if i8:
        knew, vnew = i8_encode(cfg, knew), i8_encode(cfg, vnew)
    rows = torch.arange(b, device=x.device)
    cache.k[rows, :, slot_b] = knew.to(cache.k.dtype)
    cache.v[rows, :, slot_b] = vnew.to(cache.v.dtype)

    scale = cfg.d_head ** -0.5
    if i8:
        scale = scale / cfg.kv_i8_scale
    scores = torch.einsum("bqkgd,bksd->bkgqs", q.float(),
                          cache.k.to(q.dtype).float()) * scale
    kpos = torch.arange(s_max, device=x.device)
    if window:
        # rolling buffer: slot s holds position pos - ((slot - s) mod s_max)
        age = torch.remainder(slot_b[:, None] - kpos[None, :], s_max)
        valid = age < torch.clamp(pos_b[:, None] + 1, max=window)
    else:
        valid = kpos[None, :] <= pos_b[:, None]            # (B, s_max)
    scores = torch.where(valid[:, None, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bksd->bqkgd", probs.to(q.dtype).float(),
                       cache.v.to(q.dtype).float()).to(x.dtype)
    if i8:
        out = out / cfg.kv_i8_scale
    out = out.reshape(b, 1, cfg.n_heads * cfg.d_head)
    return layers.linear(out, p["wo"], cfg.quant)


class PagedKVCache(NamedTuple):
    """One layer's shared block pool (n_blocks, KV, block_size, dh).
    Physical block 0 is the trash block: writes of dead slots and padding
    tokens land there and are never read back.  The tensors are updated in
    place (they are views into the segment's layer-stacked pools)."""

    k: torch.Tensor
    v: torch.Tensor

    @classmethod
    def zeros(cls, cfg, n_blocks: int, block_size: int, dtype, device,
              n_layers: int):
        shp = (n_layers, n_blocks, cfg.n_kv_heads, block_size, cfg.d_head)
        return cls(torch.zeros(shp, dtype=dtype, device=device),
                   torch.zeros(shp, dtype=dtype, device=device))

    def copy_block(self, src: int, dst: int) -> None:
        """``dst := src`` in both pools, every layer (copy-on-write)."""
        axis = self.k.ndim - 4
        for t in (self.k, self.v):
            t.select(axis, dst).copy_(t.select(axis, src))


def paged_attention(cfg, p: dict, x: torch.Tensor, cache: PagedKVCache,
                    table: torch.Tensor, pos: torch.Tensor, *,
                    window: int = 0, valid: torch.Tensor | None = None):
    """Scatter the new tokens into the pool, then attend through the table.

      decode          — x (B, 1, d), ``pos`` (B,) per-slot positions;
      chunked prefill — x (1, C, d), ``pos`` (1,) = chunk start.

    Token at absolute position q lives at block ``table[b, (q // bs) % W]``,
    offset ``q % bs``; ``valid`` (B, C) routes padding / dead-slot writes
    to the trash block 0.  C == 1 under the fused mode (the default on the
    card) runs the paged decode kernel; C > 1, and C == 1 otherwise, run the
    gather / mask / softmax chain — the reference's XLA code, which has no
    kernel of its own, so plain PyTorch is its port on any device.
    Returns out (B, C, d); the pool is updated in place.
    """
    b, c, _ = x.shape
    fused = ops.fused_mode(cfg.fused_decode, x.device) == "kernel"
    bs = cache.k.shape[2]
    w = table.shape[1]
    cap = w * bs
    qpos = (pos.to(torch.int64).expand(b)[:, None]
            + torch.arange(c, device=x.device)[None, :])      # (B, C)
    q = _project_q(cfg, p, x, qpos)
    q = q.reshape(b, c, cfg.n_kv_heads, cfg.q_per_kv, cfg.d_head)
    k, v = _project_kv(cfg, p, x, qpos)                        # (B, C, KV, dh)

    i8 = cache.k.dtype == torch.int8
    if i8:
        k, v = i8_encode(cfg, k), i8_encode(cfg, v)
    phys = torch.gather(table.to(torch.int64), 1, (qpos // bs) % w)
    if valid is not None:
        phys = torch.where(valid, phys, 0)
    off = qpos % bs
    # (phys, off) broadcast to (B, C); the KV slice stays: target (B, C, KV,
    # dh).  Live tokens hit distinct (block, offset) pairs; only trash-block
    # writes may collide, and those are never read.
    cache.k[phys, :, off] = k.to(cache.k.dtype)
    cache.v[phys, :, off] = v.to(cache.v.dtype)

    scale = cfg.d_head ** -0.5
    if i8:
        scale = scale / cfg.kv_i8_scale
    if c == 1 and fused:
        out = paged_attn.paged_decode_attention(
            q[:, 0].contiguous(), cache.k, cache.v, table,
            qpos[:, 0].to(torch.int32), window=window, scale=float(scale),
            out_scale=float(1.0 / cfg.kv_i8_scale) if i8 else 1.0)
        out = out.reshape(b, 1, cfg.n_heads * cfg.d_head).to(x.dtype)
        return layers.linear(out, p["wo"], cfg.quant)

    idx = table.to(torch.int64)
    gk = cache.k[idx].permute(0, 2, 1, 3, 4).reshape(b, cfg.n_kv_heads, cap,
                                                     cfg.d_head)
    gv = cache.v[idx].permute(0, 2, 1, 3, 4).reshape(b, cfg.n_kv_heads, cap,
                                                     cfg.d_head)
    scores = torch.einsum("bqkgd,bksd->bkgqs", q.float(),
                          gk.to(q.dtype).float()) * scale
    kslot = torch.arange(cap, device=x.device)[None, None, :]
    if window:
        age = torch.remainder(torch.remainder(qpos[:, :, None], cap) - kslot,
                              cap)
        valid_k = age < torch.clamp(qpos[:, :, None] + 1, max=window)
    else:
        valid_k = kslot <= qpos[:, :, None]                    # (B, C, cap)
    scores = torch.where(valid_k[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bksd->bqkgd", probs.to(q.dtype).float(),
                       gv.to(q.dtype).float()).to(x.dtype)
    if i8:
        out = out / cfg.kv_i8_scale
    out = out.reshape(b, c, cfg.n_heads * cfg.d_head)
    return layers.linear(out, p["wo"], cfg.quant)
