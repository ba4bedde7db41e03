"""Shared neural layers: RMSNorm, projections (optionally XNOR-binarized),
RoPE, SwiGLU FFN, the tanh GELU, embeddings and the full-precision lm
head."""

from __future__ import annotations

import math

import torch

from repro_torch.core import xnor_layers
from repro_torch.models.params import ParamDef


# PyTorch's CUDA reduction spreads a row wider than a warp over 512 / rows
# threads below 16 rows, and gives it one warp from 16 rows on (fault F4)
SUM_ROWS = 16


def row_sum(x: torch.Tensor, square: bool = False) -> torch.Tensor:
    """``(x * x if square else x).sum(-1, keepdim=True)``, each row's bits
    whatever the number of rows beside it.  On the card PyTorch's
    reduction splits a row over more threads the fewer rows there are, so
    a decode step's rows (the engine's slots) would change each other's
    bits (fault F4); fewer than ``SUM_ROWS`` rows of more than 32 are
    summed in a ``SUM_ROWS``-row buffer (zero-padded under autograd).  On
    the CPU torch's own sum, which reads each row alone."""
    n = x.shape[-1]
    if not x.is_cuda or n <= 32 or x.numel() >= SUM_ROWS * n:
        return (x * x if square else x).sum(-1, keepdim=True)
    return _padded_sum(x, square)


def _padded_sum(x: torch.Tensor, square: bool = False) -> torch.Tensor:
    """``row_sum`` from a ``SUM_ROWS``-row buffer: ``x`` (or its square)
    written into its first rows, one reduction; the other rows are left
    unset and their sums dropped."""
    flat = x.reshape(-1, x.shape[-1])
    if flat.requires_grad and torch.is_grad_enabled():
        # autograd does not record writes into a buffer: pad instead
        rows = flat * flat if square else flat
        buf = torch.nn.functional.pad(rows, (0, 0, 0,
                                             SUM_ROWS - flat.shape[0]))
    else:
        buf = flat.new_empty((SUM_ROWS, flat.shape[1]))
        rows = buf[:flat.shape[0]]
        if square:
            torch.mul(flat, flat, out=rows)
        else:
            rows.copy_(flat)
    return buf.sum(-1, keepdim=True)[:flat.shape[0]].reshape(
        *x.shape[:-1], 1)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
             dtype: torch.dtype | None = None) -> torch.Tensor:
    """RMSNorm in f32, rounded to ``dtype`` (``x.dtype`` by default)."""
    x32 = x.float()
    var = row_sum(x32, square=True) * (1.0 / x.shape[-1])
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(dtype or x.dtype)


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
        "w1": ParamDef((n, d, ff), (None, "fsdp", "tp"),
                       cfg.dtype, binarize=True),
        "w3": ParamDef((n, d, ff), (None, "fsdp", "tp"),
                       cfg.dtype, binarize=True),
        "w2": ParamDef((n, ff, d), (None, "tp", "fsdp"),
                       cfg.dtype, binarize=True),
    }


def silu(g: torch.Tensor, f32: bool = False) -> torch.Tensor:
    """``jax.nn.silu(g)`` as the reference computes it: negate, exp, add
    1, divide 1 by the sum and multiply by g, each step rounded to g's
    dtype (``torch.sigmoid`` rounds once from f32).  ``f32`` returns the
    last product unrounded, in f32: what the jitted reference reads where
    an f32 cast follows.  Subnormals are the platform's: XLA's CPU and
    the TPU flush them to zero, torch keeps them unless
    ``torch.set_flush_denormal`` is on."""
    r = torch.reciprocal(torch.exp(-g) + 1)
    return g.float() * r.float() if f32 else g * r


def silu_mul(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu(g) * u`` as the reference computes it
    (:func:`silu`, then the product)."""
    return silu(g) * u


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (the tanh form, its default) as the reference
    computes it: x (0.5 (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3)))) with
    every step rounded to x's dtype and the constants rounded to it first
    (``x ** 3`` is x (x x)).  The jitted reference keeps each bf16 step
    (``torch.nn.functional.gelu(approximate="tanh")`` rounds once from
    f32 and differs on about 2 % of bf16 inputs); subnormals are the
    platform's, as in :func:`silu`."""
    def c(v):
        return torch.tensor(v, dtype=torch.float32).to(x.dtype)
    inner = x + c(0.044715) * (x * (x * x))
    cdf = c(0.5) * (1.0 + torch.tanh(c(math.sqrt(2 / math.pi)) * inner))
    return x * cdf


def ffn(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    g = linear(x, p["w1"], cfg.quant)
    h = silu_mul(g, linear(x, p["w3"], cfg.quant))
    return linear(h, p["w2"], cfg.quant)


# --- embedding / unembedding --------------------------------------------------

def embed_defs(cfg) -> dict:
    v = cfg.padded_vocab
    return {
        "tokens": ParamDef((v, cfg.d_model), ("tp", "fsdp"), cfg.dtype,
                           init="embed"),
        "final_norm": ParamDef((cfg.d_model,), (None,), torch.float32,
                               init="ones"),
        # the d axis whole: fsdp on the contraction would gather the
        # (tokens, vocab) logits instead of this weight
        "lm_head": ParamDef((cfg.d_model, v), (None, "tp"), cfg.dtype),
    }


def embed(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    return p["tokens"][tokens]


def logits(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    # the lm head stays full precision even under quant="xnor"
    return torch.matmul(rms_norm(x, p["final_norm"]), p["lm_head"])
