"""Shared neural layers: RMSNorm, projections (optionally XNOR-binarized),
RoPE, SwiGLU FFN, the tanh GELU, embeddings and the full-precision lm
head.

Under the tensor-parallel context (:mod:`repro_torch.distributed.ctx`)
a column-parallel linear is :func:`linear` on the rank's block of
output columns; :func:`row_linear` is the row-parallel one (the rank's
block of K, then a sum over the model axis); the embedding is looked up
in the rank's block of the vocab and :func:`logits` gathers the vocab
blocks (or, for the training loss, keeps the rank's).  A replicated
activation enters a rank's share through ``ctx.enter``, whose backward
sums its gradient over the model axis, so the layers train.  Outside a
context every function runs as on one device."""

from __future__ import annotations

import math

import torch

from repro_torch.core import xnor_layers
from repro_torch.distributed import ctx
from repro_torch.kernels import cuda, ops
from repro_torch.models import cpu_math
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
    if not cuda.on_card(x) or n <= 32 or x.numel() >= SUM_ROWS * n:
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
             dtype: torch.dtype | None = None, cols: slice | None = None
             ) -> torch.Tensor:
    """RMSNorm in f32, rounded to ``dtype`` (``x.dtype`` by default).
    ``cols``: the statistics over the whole row, the output of those
    elements alone (``scale`` holds just theirs)."""
    x32 = x.float()
    var = row_sum(x32, square=True) * (1.0 / x.shape[-1])
    if cols is not None:
        x32, scale = x32[..., cols], scale[:cols.stop - cols.start]
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(dtype or x.dtype)


def matmul(x: torch.Tensor, w: torch.Tensor, f32: bool = False
           ) -> torch.Tensor:
    """x (..., K) @ w (K, N), rounded to x's dtype (``f32``: left f32).
    On the card PyTorch's product; on the CPU the reference's CPU dot
    order (:mod:`cpu_math`, fault F7), not the host BLAS's."""
    if cuda.on_card(x):
        return torch.matmul(x.float(), w.float()) if f32 \
            else torch.matmul(x, w)
    y = cpu_math.matmul(x, w)
    return y if f32 else y.to(x.dtype)


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(eq, a, b)`` of one contracted index in f32: on the
    card PyTorch's, on the CPU in the reference's CPU dot order
    (:func:`cpu_math.einsum`)."""
    if cuda.on_card(a):
        return torch.einsum(eq, a.float(), b.float())
    return cpu_math.einsum(eq, a, b)


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
        y = matmul(x, w)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def row_linear(x: torch.Tensor, w, quant: str, k: int) -> torch.Tensor:
    """The row-parallel linear: ``x`` (..., Kv) is this rank's valid part
    of a K block of the whole K = ``k``, ``w`` its block of the weight
    ((Kb, N) float, or packed planes of the block, Kb >= Kv) -> x @ W over
    the whole K (..., N), summed over the model axis (:func:`linear`
    outside a tensor-parallel context).

    Float weights: each rank's partial product stays f32 until after the
    sum, then rounds once to x's dtype, as one matmul rounds once.
    Packed weights: the fused kernel's alpha is a mean over the whole K,
    so the chain is the unfused one of ``xnor_layers.
    xnor_linear_prepacked`` (:func:`row_partial`), its int32 dots and the
    rows' f32 |x| sums summed over the ranks, then ``dots * alpha *
    beta``.  alpha is the one the single-process linear takes on the same
    device: on the CPU the unfused chain's, sum * (1/K) rounded to x's
    dtype (``bitpack.mean_abs``); on the card the fused kernel's, sum / K
    in f32 (``xnor_gemm.alpha_kernel_order``), which differs from it in
    the order of the f32 sum alone: a binarized layer turns a rounding of
    its input into flipped signs downstream."""
    if ctx.tp_size() == 1:
        return linear(x, w, quant)
    lead, kv = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(math.prod(lead), kv)
    if isinstance(w, xnor_layers.PackedLinear):
        if w.k != k:
            raise ValueError(f"packed weight's K {w.k} != {k}")
        dots, sums = row_partial(x2, w)
        total = ctx.reduce_sum(sums)
        alpha = total / k if ops.fused_mode("auto", x.device) == "kernel" \
            else (total * (1.0 / k)).to(x.dtype)
        y = ctx.sum_exact(dots).float() * alpha[:, None] * w.beta[None, :]
        return y.reshape(*lead, w.pb.shape[0]).to(x.dtype)
    wv = w[:kv]
    if quant == "xnor":
        # |x| through xnor_layers._Abs: +1 at 0, as the single-process STE
        # (fault F6); the partials stay f32 until after the sum
        part = torch.matmul(xnor_layers.binarize_ste(x2).float(),
                            xnor_layers.binarize_ste(wv).float())
        alpha = (ctx.reduce_sum(row_sum(
            xnor_layers._Abs.apply(x2).float())[:, 0])
            * (1.0 / k)).to(x.dtype)
        beta = (ctx.reduce_sum(xnor_layers._Abs.apply(wv).float().sum(0))
                * (1.0 / k)).to(w.dtype)
        y = ctx.reduce_sum(part) * alpha[:, None] * beta
    else:
        y = ctx.reduce_sum(matmul(x2, wv, f32=True))
    return y.reshape(*lead, w.shape[-1]).to(x.dtype)


def row_partial(x: torch.Tensor, w) -> tuple[torch.Tensor, torch.Tensor]:
    """One rank's share of a packed row-parallel linear: x (M, Kv), the
    valid part of its K block, against ``w``'s planes of the block (N, Kw)
    -> (int32 dots (M, N), each row's f32 sum of |x|).  The pack kernel
    packs x, its words are padded to the block's with 1 bits (the
    block's padding is 1 bits too, so they XOR to 0) and the ``xnor_gemm``
    kernel counts at the true Kv."""
    sums = row_sum(x.abs().float())[:, 0]
    if not x.shape[1]:
        return x.new_zeros((x.shape[0], w.pb.shape[0]),
                           dtype=torch.int32), sums
    pa, _ = ops.binarize(x)
    if pa.shape[-1] < w.pb.shape[-1]:
        pa = torch.nn.functional.pad(pa, (0, w.pb.shape[-1] - pa.shape[-1]),
                                     value=-1)
    return ops.xnor_matmul(pa, w.pb, x.shape[1]), sums


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
    r = torch.reciprocal(cpu_math.exp(-g) + 1)
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
    cdf = c(0.5) * (1.0 + cpu_math.tanh(c(math.sqrt(2 / math.pi)) * inner))
    return x * cdf


def ffn(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    """The SwiGLU FFN; under tensor parallelism w1 / w3 are the rank's
    ceil-div block of d_ff columns (``x`` enters through ``ctx.enter``)
    and w2 its rows (:func:`row_linear`)."""
    x = ctx.enter(x)
    g = linear(x, p["w1"], cfg.quant)
    h = silu_mul(g, linear(x, p["w3"], cfg.quant))
    if ctx.tp_size() == 1:
        return linear(h, p["w2"], cfg.quant)
    _, start, stop = ctx.extent(cfg.d_ff)
    return row_linear(h[..., :stop - start], p["w2"], cfg.quant, cfg.d_ff)


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
    """The table's rows of ``tokens``; under tensor parallelism the table
    is the rank's block of the vocab: a row outside it reads 0 and the
    ranks' rows are summed (exact: one term is non-zero)."""
    table = p["tokens"]
    if ctx.tp_size() == 1:
        return table[tokens]
    rows = table.shape[0]
    local = tokens.long() - ctx.tp_rank() * rows
    hit = (local >= 0) & (local < rows)
    out = torch.where(hit[..., None], table[local.clamp(0, rows - 1)], 0)
    return ctx.sum_exact(out.to(table.dtype))


def logits(cfg, p: dict, x: torch.Tensor, gather: bool = True
           ) -> torch.Tensor:
    """The full-precision lm head (even under quant="xnor"); under tensor
    parallelism over the rank's vocab block, the blocks then gathered, or
    (``gather`` False: the training loss's vocab-parallel CE) this
    rank's block, its padding columns included."""
    h = rms_norm(x, p["final_norm"])
    if ctx.tp_size() == 1:
        return matmul(h, p["lm_head"])
    y = matmul(ctx.enter(h), p["lm_head"])
    return ctx.gather_last(y)[..., :cfg.padded_vocab] if gather else y
