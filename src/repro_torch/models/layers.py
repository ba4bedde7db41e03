"""Shared neural layers: RMSNorm, projections (optionally XNOR-binarized),
RoPE, SwiGLU FFN, embeddings and the full-precision lm head."""

from __future__ import annotations

import torch

from repro_torch.core import xnor_layers
from repro_torch.models.params import ParamDef


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).sum(-1, keepdim=True) * (1.0 / x.shape[-1])
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def linear(x: torch.Tensor, w, quant: str = "none",
           bias: torch.Tensor | None = None) -> torch.Tensor:
    """x (..., K) @ w (K, N).  ``w`` may be a packed
    :class:`~repro_torch.core.xnor_layers.PackedLinear` (serve form), a
    float weight under ``quant="xnor"`` (binary float path), or a plain
    float weight."""
    if isinstance(w, xnor_layers.PackedLinear):
        y = xnor_layers.xnor_linear_prepacked(x, w.pb, w.beta, valid_k=w.k)
    elif quant == "xnor":
        y = xnor_layers.xnor_linear(x, w.t())
    else:
        y = torch.matmul(x, w)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


# --- RoPE -------------------------------------------------------------------

def rope_freqs(d_head: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, d_head, 2, dtype=torch.float32,
                        device=device) / d_head
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x (B, S, H, dh); positions (B, S) or (S,).  NeoX-style halves, f32."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    if positions.ndim == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs             # (B, S, dh/2)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --- SwiGLU FFN ---------------------------------------------------------------

def ffn_defs(cfg, n: int) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    return {
        "w1": ParamDef((n, d, ff), cfg.dtype, binarize=True),
        "w3": ParamDef((n, d, ff), cfg.dtype, binarize=True),
        "w2": ParamDef((n, ff, d), cfg.dtype, binarize=True),
    }


def ffn(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    g = linear(x, p["w1"], cfg.quant)
    h = g * torch.sigmoid(g) * linear(x, p["w3"], cfg.quant)
    return linear(h, p["w2"], cfg.quant)


# --- embedding / unembedding --------------------------------------------------

def embed_defs(cfg) -> dict:
    v = cfg.padded_vocab
    return {
        "tokens": ParamDef((v, cfg.d_model), cfg.dtype, init="embed"),
        "final_norm": ParamDef((cfg.d_model,), torch.float32, init="ones"),
        "lm_head": ParamDef((cfg.d_model, v), cfg.dtype),
    }


def embed(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    return p["tokens"][tokens]


def logits(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    # the lm head stays full precision even under quant="xnor"
    return torch.matmul(rms_norm(x, p["final_norm"]), p["lm_head"])
