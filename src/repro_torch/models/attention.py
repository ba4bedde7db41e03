"""GQA attention over the block-paged KV cache (the serve path).

Layouts, as in the JAX package:
  q            (B, S, H, dh)
  k, v         (B, S, KV, dh) — compact GQA form, never expanded
  paged pool   (n_blocks, KV, block_size, dh) — shared, no batch axis,
               addressed through per-slot int32 block tables
Scores accumulate in f32; softmax is f32.
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


def attn_defs(cfg, n: int) -> dict:
    d, H, KV, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    defs = {
        "wq": ParamDef((n, d, H * dh), cfg.dtype, binarize=True),
        "wk": ParamDef((n, d, KV * dh), cfg.dtype, binarize=True),
        "wv": ParamDef((n, d, KV * dh), cfg.dtype, binarize=True),
        "wo": ParamDef((n, H * dh, d), cfg.dtype, binarize=True),
    }
    if cfg.qkv_bias:
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
    """-> (B, S, H, dh)"""
    b, s, _ = x.shape
    q = layers.linear(x, p["wq"], cfg.quant, p.get("bq"))
    q = q.reshape(b, s, cfg.n_heads, cfg.d_head)
    if cfg.qk_norm:
        q = layers.rms_norm(q, p["q_norm"])
    return layers.apply_rope(q, positions, cfg.rope_theta)


def _project_kv(cfg, p, x, positions):
    """-> k, v each (B, S, KV, dh)"""
    b, s, _ = x.shape
    k = layers.linear(x, p["wk"], cfg.quant, p.get("bk"))
    v = layers.linear(x, p["wv"], cfg.quant, p.get("bv"))
    k = k.reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    v = v.reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    if cfg.qk_norm:
        k = layers.rms_norm(k, p["k_norm"])
    return layers.apply_rope(k, positions, cfg.rope_theta), v


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

    def layer(self, i: int) -> "PagedKVCache":
        return PagedKVCache(self.k[i], self.v[i])

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
    to the trash block 0.  C == 1 under the fused mode runs the paged
    decode kernel; C > 1, and C == 1 with ``fused_decode="off"``, run the
    gather / mask / softmax chain — the reference's XLA code, which has no
    kernel of its own, so plain PyTorch is its port on any device.
    Returns out (B, C, d); the pool is updated in place.
    """
    b, c, _ = x.shape
    fused = ops.fused_mode(cfg.fused_decode) == "kernel"
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
