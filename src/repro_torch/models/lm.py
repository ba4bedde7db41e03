"""Language-model assembly for training and the serve path: embeddings, the
per-segment blocks, the full-precision head.

Public surface:
  param_defs / param_pspecs / abstract_params / init_params / pack_params
  packed_abstract_params / packed_param_pspecs        (the packed serve form)
  param_count / active_param_count / model_flops
  encode                                               (enc-dec archs)
  forward(cfg, params, tokens, ctx) -> (logits, aux)   (training)
  loss_fn(cfg, params, batch) -> (loss, metrics)
  decode_state_spec / decode_state_pspecs / prefill / decode_step
                                                       (dense layout)
  paged_table_widths / paged_decode_layer_classes / paged_decode_state_spec
  paged_decode_step(cfg, params, token, state, tables, active)
  prefill_chunk_step(cfg, params, tokens, state, slot, n_valid, tables, ...)
  paged_copy_block / prefix_cache_eligible / prefix_table_class
  export_slot / import_slot / export_slot_spec / gather_block  (migration)

The resident state is updated in place: the caches are written by the
scatter, ``pos`` by the step.  Each step returns the state it was given.
``ctx`` is a request's modality context: (B, T_ctx, d) patch embeddings
(vlm) or frame embeddings (enc-dec, encoded by :func:`encode`); None for
text-only archs.
"""

from __future__ import annotations

import re
from typing import Any, NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch.distributed import ctx as dctx
from repro_torch.models import blocks, cpu_math, layers
from repro_torch.models import params as pdefs
from repro_torch.models import registry


def param_defs(cfg) -> dict:
    defs: dict[str, Any] = {"embed": layers.embed_defs(cfg)}
    for i, (kind, n, d) in enumerate(blocks.segment_defs(cfg)):
        defs[f"seg{i}_{kind}"] = d
    if cfg.is_encdec():
        enc_segs = cfg.encoder_segments()
        for i, (kind, n, d) in enumerate(blocks.segment_defs(cfg, enc_segs)):
            defs[f"enc{i}_{kind}"] = d
        defs["enc_norm"] = pdefs.ParamDef((cfg.d_model,), (None,),
                                          torch.float32, init="ones")
    return defs


def abstract_params(cfg) -> dict:
    """The parameter tree as ``meta`` tensors (shapes and dtypes only)."""
    return pdefs.abstract(param_defs(cfg))


def _tensor_parallel(key: str) -> bool:
    """Whether the top-level leaf group ``key`` is a segment of a kind
    that computes on its blocks over the model axis."""
    m = re.fullmatch(r"(?:seg|enc)\d+_(\w+)", key)
    return m is not None and registry.get(m.group(1)).tensor_parallel


def _pspecs(cfg, fn, rules: dict, head_aligned: bool) -> dict:
    return {key: fn(d, rules, head_aligned and _tensor_parallel(key))
            for key, d in param_defs(cfg).items()}


def param_pspecs(cfg, rules: dict, head_aligned: bool = False) -> dict:
    """Every leaf's placement (the reference's).  ``head_aligned``: the
    tensor-parallel serving steps' own, where a ``tensor_parallel``
    kind's dims of heads are split into whole heads
    (``params.pspecs``)."""
    return _pspecs(cfg, pdefs.pspecs, rules, head_aligned)


def init_params(cfg, seed: int = 0, *, device="cuda") -> dict:
    """Random parameters drawn from a ``torch.Generator`` seeded with
    ``seed`` on ``device`` (CUDA unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return pdefs.init(param_defs(cfg), gen, dev)


def pack_params(cfg, params) -> dict:
    """Serve-resident form: every binarizable linear packed to sign planes
    + beta (the float weight leaves the tree).  Identity for
    ``quant="none"``."""
    if cfg.quant != "xnor":
        return params
    return pdefs.pack(param_defs(cfg), params)


def packed_abstract_params(cfg) -> dict:
    """The tree :func:`pack_params` gives, as ``meta`` tensors."""
    if cfg.quant != "xnor":
        return abstract_params(cfg)
    return pdefs.pack_abstract(param_defs(cfg))


def packed_param_pspecs(cfg, rules: dict, head_aligned: bool = False
                        ) -> dict:
    """Placements of :func:`pack_params`' tree (``params.pack_pspecs``;
    ``head_aligned`` as in :func:`param_pspecs`)."""
    if cfg.quant != "xnor":
        return param_pspecs(cfg, rules, head_aligned)
    return _pspecs(cfg, pdefs.pack_pspecs, rules, head_aligned)


def _seg_params(cfg, params, enc: bool = False):
    """[((kind, n), stacked params), ...] in depth order (the encoder's
    with ``enc``)."""
    segs = cfg.encoder_segments() if enc else cfg.segments()
    prefix = "enc" if enc else "seg"
    return [((kind, n), params[f"{prefix}{i}_{kind}"])
            for i, (kind, n) in enumerate(segs)]


def param_count(cfg) -> int:
    return pdefs.count(param_defs(cfg))


def active_param_count(cfg) -> int:
    """Parameters a token touches: all but the embedding table (a gather)
    and the experts a routed layer does not pick."""
    inactive = cfg.vocab * cfg.d_model
    if cfg.n_experts:
        per_expert = 3 * cfg.d_model * cfg.d_ff_expert
        n_routed = sum(1 for k in cfg.layer_kinds()
                       if registry.contract(k).routed_experts)
        inactive += n_routed * (cfg.n_experts - cfg.top_k) * per_expert
    return param_count(cfg) - inactive


def model_flops(cfg, kind: str, tokens: int) -> float:
    """6 N_active D for training (``kind="train"``), 2 N_active D for an
    inference forward."""
    return (6.0 if kind == "train" else 2.0) * active_param_count(cfg) \
        * tokens


def encode(cfg, params, frames: torch.Tensor,
           q_chunk: int = 0) -> torch.Tensor:
    """The enc-dec encoder over frame embeddings (B, T, d) -> the encoded
    frames (B, T, d) in the config's dtype, final-normed."""
    x, _, _ = blocks.segment_fwd(cfg, _seg_params(cfg, params, enc=True),
                                 frames.to(cfg.dtype),
                                 blocks.FwdOpts(q_chunk=q_chunk))
    return layers.rms_norm(x, params["enc_norm"])


def forward(cfg, params, tokens: torch.Tensor,
            ctx: torch.Tensor | None = None, q_chunk: int = 0,
            remat: bool = False, batch_sum=None, gather: bool = True):
    """tokens (B, S) -> (logits (B, S, V), the summed aux loss, f32).
    ``ctx`` (B, T_ctx, d): an enc-dec arch's frames (encoded first) or a
    vlm's patch rows.  ``remat`` checkpoints each decoder layer
    (:func:`blocks.segment_fwd`); ``batch_sum`` as in :func:`loss_fn`;
    ``gather`` False leaves a tensor-parallel rank its vocab block of the
    logits (``layers.logits``)."""
    x = layers.embed(params["embed"], tokens).to(cfg.dtype)
    if cfg.is_encdec():
        if ctx is None:
            raise ValueError(f"arch {cfg.name} needs encoder frames")
        ctx = encode(cfg, params, ctx, q_chunk)
    elif ctx is not None:
        ctx = ctx.to(cfg.dtype)
    x, aux, _ = blocks.segment_fwd(cfg, _seg_params(cfg, params), x,
                                   blocks.FwdOpts(q_chunk=q_chunk,
                                                  batch_sum=batch_sum),
                                   ctx, remat=remat)
    return layers.logits(cfg, params["embed"], x, gather), aux


def _picked_lse(cfg, logits: torch.Tensor, labels: torch.Tensor):
    """-> (the label's logit, logsumexp over the vocab), f32 (B, S), of
    f32 ``logits``: the picked logit a one-hot contraction over the
    vocab, as the reference takes it.  Under tensor parallelism
    ``logits`` is this rank's vocab block (no rank holds a (tokens,
    vocab) tensor): the max over the model axis is exact, the sum of
    exp(logit - max) is folded in rank order and the picked logit summed
    exactly (one rank holds the label)."""
    if dctx.tp_size() == 1:
        onehot = labels[..., None] == torch.arange(logits.shape[-1],
                                                   device=logits.device)
        return (logits * onehot).sum(-1), cpu_math.logsumexp(logits)
    _, start, stop = dctx.extent(cfg.padded_vocab)
    logits = logits[..., :stop - start]
    m = dctx.max_over(logits.amax(-1))
    lse = m + cpu_math.log(dctx.reduce_sum(
        cpu_math.exp(logits - m[..., None]).sum(-1)))
    local = labels.long() - start
    hit = (local >= 0) & (local < stop - start)
    picked = logits.gather(-1, local.clamp(0, stop - start - 1)[..., None])
    picked = torch.where(hit[..., None], picked, 0.0)
    return dctx.sum_exact(picked)[..., 0], lse


def loss_fn(cfg, params, batch: dict, q_chunk: int = 0, remat: bool = True,
            batch_sum=None):
    """Next-token cross-entropy over ``batch`` {tokens (B, S), labels (B,
    S) shifted by the data pipeline, -1 where there is no next token;
    ctx for context archs} -> (loss, {ce, aux, tokens}); loss = ce +
    ``router_aux_weight`` * aux.  The picked logit is a one-hot
    contraction over the vocab, as the reference takes it.

    ``batch_sum`` (the sharded train step's;
    :func:`repro_torch.distributed.sharding.batch_sum`): ``batch`` is one
    rank's block of the batch, and ``batch_sum`` sums a tensor over the
    ranks holding the others, with each rank's gradient left its own
    share.  The CE's denominator is then the global count of valid
    tokens, the routed FFNs' load balance the whole batch's, and the loss
    the global batch's on every rank.  Under tensor parallelism the CE is
    vocab-parallel (:func:`_picked_lse`)."""
    logits, aux = forward(cfg, params, batch["tokens"], batch.get("ctx"),
                          q_chunk=q_chunk, remat=remat, batch_sum=batch_sum,
                          gather=False)
    labels = batch["labels"]
    valid = labels >= 0
    picked, lse = _picked_lse(cfg, logits.float(), labels.clamp_min(0))
    ll = picked - lse
    n_valid, nll = valid.sum(), -(ll * valid).sum()
    if batch_sum is not None:
        n_valid, nll = batch_sum(n_valid), batch_sum(nll)
    ce = nll / n_valid.clamp_min(1)
    loss = ce + cfg.router_aux_weight * aux
    return loss, {"ce": ce, "aux": aux, "tokens": n_valid.to(torch.int32)}


class DecodeState(NamedTuple):
    pos: torch.Tensor          # int32 tokens consumed: scalar (homogeneous
                               # batch) or (B,) per slot
    seg_states: list           # per-segment layer-stacked state trees:
                               # caches / pools and per-slot leaves
    ctx: Any = None            # (B, T_ctx, d) context, dense vlm layout
                               # only (decode reads ctx_kv, not ctx)


def decode_state_spec(cfg, batch: int, s_max: int, *, device,
                      per_slot_pos: bool = False) -> DecodeState:
    """Zeroed dense resident state: (n, batch, KV, s_max, dh) caches per
    segment (a window's capped at the window), per-slot recurrent and
    ``ctx_kv`` leaves, and a scalar ``pos``, or a (batch,) vector with
    ``per_slot_pos`` (continuous batching).  A vlm arch (context, no
    encoder) also keeps the raw context resident, (batch, T_ctx, d)."""
    seg = blocks.segment_states(cfg, cfg.segments(), batch, s_max, device)
    pshape = (batch,) if per_slot_pos else ()
    ctx = None
    if cfg.n_ctx_tokens and not cfg.is_encdec():
        ctx = torch.zeros((batch, cfg.n_ctx_tokens, cfg.d_model),
                          dtype=cfg.dtype, device=device)
    return DecodeState(torch.zeros(pshape, dtype=torch.int32, device=device),
                       seg, ctx)


def prefill(cfg, params, tokens: torch.Tensor, s_max: int,
            ctx: torch.Tensor | None = None, q_chunk: int = 0):
    """tokens (B, S) -> (logits of the last position (B, 1, V), a fresh
    dense DecodeState of capacity ``s_max`` with scalar ``pos`` = S): the
    caches (a window's as its ring), the recurrent state after S and the
    context's ``ctx_kv``.  ``ctx`` (B, T_ctx, d): an enc-dec arch's frames
    are encoded first; the state keeps the context it read.  ``q_chunk``
    runs self-attention's queries in chunks of that many."""
    if cfg.is_encdec():
        if ctx is None:
            raise ValueError(f"arch {cfg.name} needs encoder frames")
        ctx = encode(cfg, params, ctx, q_chunk)
    elif ctx is not None:
        ctx = ctx.to(cfg.dtype)
    x = layers.embed(params["embed"], tokens).to(cfg.dtype)
    opts = blocks.FwdOpts(want_state=True, s_max=s_max, q_chunk=q_chunk)
    x, _, states = blocks.segment_fwd(cfg, _seg_params(cfg, params), x,
                                      opts, ctx)
    logits = layers.logits(cfg, params["embed"], x[:, -1:])
    pos = torch.tensor(tokens.shape[1], dtype=torch.int32,
                       device=tokens.device)
    return logits, DecodeState(pos, states, ctx)


def decode_step(cfg, params, token: torch.Tensor, state: DecodeState,
                active: torch.Tensor | None = None):
    """token (B, 1) -> logits (B, 1, V) against the dense state.  ``active``
    (B,) bool freezes inactive slots' positions and per-slot state: a dead
    slot rewrites its frozen cache line, inert until an admission
    overwrites it."""
    x = layers.embed(params["embed"], token).to(cfg.dtype)
    x = blocks.segment_decode(cfg, _seg_params(cfg, params), x,
                              state.seg_states, state.pos, None,
                              active=active, ctx=state.ctx)
    logits = layers.logits(cfg, params["embed"], x)
    state.pos.add_(1 if active is None else active.to(torch.int32))
    return logits, state


def paged_table_widths(cfg, s_max: int, block_size: int,
                       prefill_chunk: int) -> dict:
    """Block-table width per table class: monotone classes get
    ``ceil(s_max / bs)`` blocks, window rings ``W * bs >= window + C - 1``;
    kinds sharing a class take the max."""
    widths: dict[str, int] = {}
    for kind, _ in cfg.segments():
        c = registry.contract(kind)
        if not c.paged_kv:
            continue
        if c.window:
            cap = min(s_max, cfg.local_window + max(prefill_chunk, 1) - 1)
        else:
            cap = s_max
        w = -(-cap // block_size)
        widths[c.table_class] = max(widths.get(c.table_class, 0), w)
    return widths


def paged_decode_layer_classes(cfg) -> dict:
    """Paged decoder layers per block-table class: the layer-count side of
    the decode step's byte floor (``roofline.analysis.decode_roofline_bytes``
    streams each paged layer's live K/V once), from the same contracts as
    :func:`paged_table_widths`."""
    counts: dict[str, int] = {}
    for kind, n in cfg.segments():
        c = registry.contract(kind)
        if c.paged_kv:
            counts[c.table_class] = counts.get(c.table_class, 0) + n
    return counts


def decode_state_pspecs(cfg, ba, kv_shard: str = "heads",
                        tp_size: int = 16, head_aligned: bool = False
                        ) -> DecodeState:
    """Placements of :func:`decode_state_spec`'s leaves (``ba``: the batch
    mesh axes), the reference's, as the port's tuple placements;
    ``head_aligned``: those of the port's tensor-parallel serving steps
    (``blocks.segment_state_pspecs``), where ``kv_shard`` has no
    effect."""
    seg = blocks.segment_state_pspecs(cfg, cfg.segments(), ba, kv_shard,
                                      tp_size, head_aligned)
    ctx = None
    if cfg.n_ctx_tokens and not cfg.is_encdec():
        ctx = (ba, None, None)
    return DecodeState((), seg, ctx)


def paged_decode_state_spec(cfg, batch: int, *, n_blocks: int,
                            block_size: int, device) -> DecodeState:
    """Zeroed resident state: shared pools, per-slot recurrent and
    ``ctx_kv`` leaves and per-slot positions.  The raw context is never
    resident: each prefill chunk receives it and projects ``ctx_kv``."""
    seg = blocks.segment_paged_states(cfg, cfg.segments(), batch, n_blocks,
                                      block_size, device)
    return DecodeState(torch.zeros((batch,), dtype=torch.int32,
                                   device=device), seg)


def paged_decode_step(cfg, params, token: torch.Tensor, state: DecodeState,
                      tables: dict, active: torch.Tensor | None = None):
    """token (B, 1) -> logits (B, 1, V) for every slot.  ``active`` (B,)
    bool freezes inactive slots' positions and per-slot state and
    trash-routes their writes."""
    x = layers.embed(params["embed"], token).to(cfg.dtype)
    x = blocks.segment_decode(cfg, _seg_params(cfg, params), x,
                              state.seg_states, state.pos, tables,
                              active=active, ctx=state.ctx)
    logits = layers.logits(cfg, params["embed"], x)
    state.pos.add_(1 if active is None else active.to(torch.int32))
    return logits, state


def prefill_chunk_step(cfg, params, tokens: torch.Tensor, state: DecodeState,
                       slot: int, n_valid: int, tables: dict,
                       fresh: bool = False, start: int = 0,
                       ctx: torch.Tensor | None = None):
    """One chunked-prefill piece for resident slot ``slot``.

    tokens (1, C) hold positions ``pos0 .. pos0 + C - 1`` with
    ``pos0 = start`` on the request's first chunk (``fresh``; ``start`` is
    the prefix-cache skip point) and ``state.pos[slot]`` after; the first
    ``n_valid`` tokens are real.  ``fresh`` also resets the slot's
    per-slot state.  ``tables`` rows are (1, W).  ``ctx`` (1, T_ctx, d) is
    the request's context: raw patch embeddings (vlm) or the frames
    :func:`encode` made once at admission (enc-dec); every chunk projects
    the cross layers' ``ctx_kv`` from it into the slot's state.
    Returns (logits of the last valid position (1, 1, V), state)."""
    c = tokens.shape[1]
    dev = tokens.device
    pos0 = (torch.full((1,), start, dtype=torch.int32, device=dev) if fresh
            else state.pos[slot:slot + 1].clone())
    valid = (torch.arange(c, device=dev) < n_valid)[None]       # (1, C)
    x = layers.embed(params["embed"], tokens).to(cfg.dtype)
    if ctx is not None:
        ctx = ctx.to(cfg.dtype)
    x = blocks.segment_chunk(cfg, _seg_params(cfg, params), x,
                             state.seg_states, slot, pos0, valid, n_valid,
                             tables, fresh=fresh, ctx=ctx)
    logits = layers.logits(cfg, params["embed"], x[:, n_valid - 1:n_valid])
    state.pos[slot:slot + 1] = pos0 + n_valid
    return logits, state


def paged_copy_block(cfg, state: DecodeState, src: int, dst: int):
    """Copy-on-write block duplication ``dst := src`` in every pool."""
    blocks.segment_copy_block(cfg, state.seg_states, src, dst)
    return state


def prefix_cache_eligible(cfg) -> bool:
    """Prefix sharing is sound only when every decoder kind declares
    ``prefix_shareable`` (fail-closed): recurrent kinds carry per-slot
    state a skipped prefix would leave cold, and window rings recycle
    their blocks in place, so a hybrid such as recurrentgemma is not."""
    kinds = {k for k, _ in cfg.segments()}
    return bool(kinds) and all(registry.contract(k).prefix_shareable
                               for k in kinds)


def prefix_table_class(cfg) -> str | None:
    """The one table class shared prefixes register under, or None."""
    classes = {registry.contract(k).table_class
               for k, _ in cfg.segments()
               if registry.contract(k).paged_kv
               and registry.contract(k).prefix_shareable}
    return classes.pop() if len(classes) == 1 else None


# ---------------------------------------------------------------------------
# session migration: slot extraction / injection
# ---------------------------------------------------------------------------


def export_slot(cfg, state: DecodeState, slot: int, ids: dict) -> dict:
    """One slot's complete state as a self-contained tree ``{"pos": (1,)
    int32, "segs": per-segment (shared, per_slot) pairs}``: paged blocks in
    table-row order (``ids`` maps table class -> the slot's (W,) row) and
    per-slot leaves (the RG-LRU's f32 ``h``, the conv buffer, a context's
    ``ctx_kv``) at batch width 1.  A pure read; paged layout only."""
    segs = blocks.segment_export_slot(cfg, state.seg_states, slot, ids)
    return {"pos": state.pos[slot:slot + 1].clone(), "segs": segs}


def import_slot(cfg, state: DecodeState, slot: int, ids: dict,
                payload) -> DecodeState:
    """Inverse of :func:`export_slot`, in place: seat ``payload`` in
    ``slot`` with ``ids`` the destination rows (same widths, fresh ids)."""
    state.pos[slot:slot + 1] = payload["pos"].to(state.pos.device,
                                                 torch.int32)
    blocks.segment_import_slot(cfg, state.seg_states, slot, ids,
                               payload["segs"])
    return state


def export_slot_spec(cfg, state: DecodeState, widths: dict) -> dict:
    """The shape and dtype tree of :func:`export_slot`'s payload for this
    geometry, as ``meta`` tensors: the ``like`` tree a migration
    checkpoint restores against (shapes never come from the file)."""
    ids = {c: torch.zeros((w,), dtype=torch.int64, device="meta")
           for c, w in widths.items()}
    meta = DecodeState(state.pos.to("meta"),
                       [blocks.state_map(lambda l: l.to("meta"), st)
                        for st in state.seg_states])
    return export_slot(cfg, meta, 0, ids)


def gather_block(cfg, state: DecodeState, bid: int) -> tuple:
    """Physical block ``bid`` across every shared pool (the integrity
    scrubber's unit of verification for idle cached blocks)."""
    return blocks.segment_gather_block(cfg, state.seg_states, bid)
