"""Mixture-of-Experts FFN: top-k routing with grouped GShard-style dispatch
(the JAX package's ``models/moe.py``).

Tokens are processed in groups of ``tg = min(group_len, S)``, one dispatch
problem a group.  Each expert keeps ``capacity(cfg, tg)`` places a group;
a choice past them is dropped (its combine weight is zero, the residual
carries the token), with choice-major priority: every token's first
choice queues before any token's second.  The router stays f32 and the
experts stay in ``cfg.dtype`` even under ``quant="xnor"`` (binary routers
collapse; no leaf here is ``binarize``).

The expert products are the reference's: capacity buffers (E, G, C, d),
three batched products a layer over every expert, and the dispatch and
combine contractions.  Rounding follows the reference's jitted program:
the router reads the ``cfg.dtype`` norm output cast to f32; routing,
softmax, top-k and the gate normalization run in f32; each expert product
rounds to ``cfg.dtype`` once, from an f32 sum (``layers.silu_mul`` keeps
the reference's SwiGLU chain); the combine weights round to ``cfg.dtype``
and each token's kept contributions are summed in f32 in ascending expert
order and rounded once.

Expert parallel (:mod:`repro_torch.distributed.ctx`, the sharded serving
steps): the reference places the experts over ``model`` and names the
dispatch "the all-to-all boundary"; here the batch is split over (pod,
data) only, so each token is whole on every rank of the model axis and
the dispatch needs no all-to-all.  Every rank routes the same tokens
identically (the router is whole), runs only its ceil-div block of the
E experts (:func:`experts`), and :func:`combine` meets the others' rows:
where a token's k kept rows fit ``ctx.GATHER_BYTES`` (every top-1 layer
and every decode step) the rows themselves are summed over the ranks,
exactly (each comes from one rank), and combined as on one device;
past it (a top-k > 1 prefill) each rank's f32 partial sum of its own
rows is summed over the ranks, which reorders the f32 sum of a token's
choices.  Under autograd the dispatch input enters the rank's experts
through ``ctx.enter`` (as do the combine weights on the partial-sum
path), so the replicated router and the tokens get whole gradients.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from repro_torch.distributed import ctx
from repro_torch.kernels import cuda
from repro_torch.models import cpu_math, layers
from repro_torch.models.params import ParamDef

F32 = torch.float32


def moe_defs(cfg, n: int) -> dict:
    d, e, ff = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    return {
        "router": ParamDef((n, d, e), (None, "fsdp", None), F32),
        "w1": ParamDef((n, e, d, ff), (None, "ep", "fsdp", None),
                       cfg.dtype),
        "w3": ParamDef((n, e, d, ff), (None, "ep", "fsdp", None),
                       cfg.dtype),
        "w2": ParamDef((n, e, ff, d), (None, "ep", None, "fsdp"),
                       cfg.dtype),
    }


def group_len(cfg) -> int:
    """Tokens a dispatch group: the one-hots grow as group_len^2 * k."""
    return 512 if cfg.top_k > 2 else 1024


def capacity(cfg, tg: int) -> int:
    return max(1, int(tg * cfg.top_k / cfg.n_experts * cfg.capacity_factor))


class Routing(NamedTuple):
    """One dispatch problem a group: G groups of T tokens, k choices, E
    experts, C places an expert."""
    probs: torch.Tensor     # (G, T, E) f32 router softmax
    idx: torch.Tensor       # (G, T, k) int64 chosen experts, best first
    mask: torch.Tensor      # (G, T, k, E) f32 one-hot choices (valid only)
    keep: torch.Tensor      # (G, T, k, E) f32 the choices within capacity
    pos: torch.Tensor       # (G, T, k) f32 queue place of a kept choice
                            # (0 where dropped)
    gate: torch.Tensor      # (G, T, k) f32 normalized gate, 0 where dropped


def route(cfg, router: torch.Tensor, xg: torch.Tensor,
          valid: torch.Tensor | None = None) -> Routing:
    """xg (G, T, d) -> the routing of every token.  ``valid`` (G, T) bool
    takes padding out: it occupies no place and gets no weight."""
    g, tg, _ = xg.shape
    e, k, c = cfg.n_experts, cfg.top_k, capacity(cfg, tg)
    if cuda.on_card(xg) and tg == 1:
        # a decode step: one row a slot, and cuBLAS picks its product by
        # the row count, so a slot's bits would hang on the batch (F4)
        logits = layers.row_sum(xg.to(F32)[..., None, :]
                                * router.t().contiguous())[..., 0]
    else:
        logits = layers.matmul(xg, router, f32=True)
    u = cpu_math.exp(logits - logits.amax(-1, keepdim=True))
    probs = u / layers.row_sum(u)
    # jax.lax.top_k breaks ties toward the lower index: a stable sort
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[..., :k], idx[..., :k]
    gates = gates / layers.row_sum(gates)
    mask = torch.nn.functional.one_hot(idx, e).to(F32)
    if valid is not None:
        mask = mask * valid.reshape(g, tg, 1, 1).to(F32)
    # each (token, choice)'s place in its expert's queue; choice-major:
    # every token's first choice, then every token's second, ...
    prio = mask.transpose(1, 2).reshape(g, k * tg, e)
    pos = torch.cumsum(prio, dim=1) - prio
    pos = pos.reshape(g, k, tg, e).transpose(1, 2)
    keep = (pos < c).to(F32) * mask
    return Routing(probs, idx, mask, keep, (pos * keep).sum(-1),
                   gates * keep.sum(-1))


def combine_weights(cfg, r: Routing) -> torch.Tensor:
    """-> (G, T, E, C) f32: each kept choice's gate at its (expert, place);
    one term at most a cell, so the reference's three-way product is
    exact in any order."""
    c = capacity(cfg, r.idx.shape[1])
    pos_oh = torch.nn.functional.one_hot(r.pos.long(), c).to(F32)
    return torch.einsum("gtk,gtke,gtkc->gtec", r.gate, r.keep, pos_oh)


@contextlib.contextmanager
def _f32_reductions():
    """cuBLAS may sum a bf16 product's split-K partials in bf16 (PyTorch's
    default); the reference's expert products sum in f32 and round once.
    The setting is PyTorch's, read at each launch, so it is held off for
    the products alone and restored after."""
    matmul = torch.backends.cuda.matmul
    was = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        matmul.allow_bf16_reduced_precision_reduction = was


def _local(cfg) -> tuple[int, int]:
    """-> (first expert, count) of this rank's block of the experts."""
    _, e0, e1 = ctx.extent(cfg.n_experts)
    return e0, e1 - e0


def experts(cfg, p: dict, xg: torch.Tensor, r: Routing) -> torch.Tensor:
    """The capacity buffers through every expert (this rank's block of
    them under expert parallelism): xg (G, T, d) -> ye (E, G * C, d) in
    xg's dtype, three batched products, each summed in f32."""
    g, _, d = xg.shape
    combine = combine_weights(cfg, r)
    c = combine.shape[-1]
    e0, ne = _local(cfg)
    if ctx.tp_size() > 1:
        combine = combine[:, :, e0:e0 + ne]
        p = {k: p[k][:ne] for k in ("w1", "w3", "w2")}
    dispatch = (combine > 0).to(xg.dtype)                     # (G, T, E, C)
    # one token a (expert, group, place): the dispatch product is exact
    xe = torch.einsum("gtec,gtd->egcd", dispatch, ctx.enter(xg)).reshape(
        ne, g * c, d)
    h = layers.silu_mul(_bmm(xe, p["w1"]), _bmm(xe, p["w3"]))
    return _bmm(h, p["w2"])


def _bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (E, M, K) @ b (E, K, N) summed in f32 and rounded once to a's
    dtype: on the card PyTorch's bmm, on the CPU the reference's CPU dot
    order (:func:`cpu_math.bmm`, fault F7)."""
    if cuda.on_card(a):
        with _f32_reductions():
            return torch.bmm(a, b)
    return cpu_math.bmm(a, b).to(a.dtype)


def combine(cfg, r: Routing, ye: torch.Tensor, dtype) -> torch.Tensor:
    """-> (G, T, d) f32: the reference's contraction of ``ye`` over (e, c)
    with the combine weights rounded to ``dtype``, summed in f32.  Its
    only nonzero terms are a token's kept choices; they are gathered and
    summed in ascending expert order."""
    g, tg, k = r.idx.shape
    d = ye.shape[-1]
    c = ye.shape[1] // g
    e0, e = _local(cfg)
    order = torch.argsort(r.idx, dim=-1)
    ex = r.idx.gather(-1, order)
    w = r.gate.gather(-1, order).to(dtype).to(F32)
    if ctx.tp_size() > 1:
        mine = (ex >= e0) & (ex < e0 + e)
        ex = (ex - e0).clamp(0, max(e - 1, 0))
    row = (ex * g + torch.arange(g, device=ye.device)[:, None, None]) * c \
        + r.pos.gather(-1, order).long()
    rows = ye.reshape(e * g * c, d).index_select(0, row.reshape(-1)) \
        .reshape(g, tg, k, d) if e else ye.new_zeros((g, tg, k, d))
    if ctx.tp_size() > 1:
        rows = torch.where(mine[..., None], rows, 0)
        # the ranks' rows where they fit (exact), else their partial sums
        exact = k == 1 or \
            rows.numel() * rows.element_size() <= ctx.GATHER_BYTES
        if exact:
            rows = ctx.sum_exact(rows)
    rows = rows.to(F32)
    if ctx.tp_size() > 1 and not exact:
        # the weights meet this rank's rows alone
        w = ctx.enter(w)
    y = w[..., 0, None] * rows[:, :, 0]
    for j in range(1, k):
        y = y + w[..., j, None] * rows[:, :, j]
    if ctx.tp_size() > 1 and not exact:
        y = ctx.reduce_sum(y)
    return y


def moe_ffn(cfg, p: dict, x: torch.Tensor,
            valid: torch.Tensor | None = None, batch_sum=None):
    """x (B, S, d) -> (y (B, S, d) in x's dtype, aux loss f32 scalar).

    ``valid`` (B, S) bool excludes padding (a chunked prefill's ragged
    tail) from routing, capacity and the aux loss.  Raises where B * S is
    not a whole number of groups, as the reference asserts.  With
    ``batch_sum`` (``x`` is one rank's block of the batch) the load
    balance's two means are the whole batch's: their sums and counts are
    summed over the ranks before the product."""
    b, s, d = x.shape
    tg = min(group_len(cfg), s)
    if (b * s) % tg:
        raise ValueError(f"moe_ffn: {b} x {s} tokens are not a whole number "
                         f"of {tg}-token dispatch groups")
    g = b * s // tg
    xg = x.reshape(g, tg, d)
    vg = None if valid is None else valid.reshape(g, tg)
    r = route(cfg, p["router"], xg, vg)
    y = combine(cfg, r, experts(cfg, p, xg, r), x.dtype)

    # Switch / GShard load balance: E * sum_e f_e * P_e over valid tokens
    first = r.mask[:, :, 0, :]
    if batch_sum is not None:
        v = torch.ones((g, tg, 1), dtype=F32, device=x.device) \
            if vg is None else vg.reshape(g, tg, 1).to(F32)
        denom = batch_sum(v.sum()).clamp_min(1.0)
        f_e = batch_sum(first.sum((0, 1))) / denom
        p_e = batch_sum((r.probs * v).sum((0, 1))) / denom
    elif valid is None:
        f_e, p_e = first.mean((0, 1)), r.probs.mean((0, 1))
    else:
        v = vg.reshape(g, tg, 1).to(F32)
        denom = v.sum().clamp_min(1.0)
        f_e = first.sum((0, 1)) / denom
        p_e = (r.probs * v).sum((0, 1)) / denom
    aux = cfg.n_experts * (f_e * p_e).sum()
    return y.reshape(b, s, d).to(x.dtype), aux
