"""Decoder blocks and the per-segment machinery of the serve path.

A model's depth plan is a list of (kind, count) segments
(``ArchConfig.segments()``); a segment's parameters are stacked on a
leading layer axis, and the segment runs as a Python loop over it.

Ported kinds:
  attn   GQA self-attention + SwiGLU FFN (dense transformers)
  local  sliding-window GQA + FFN (RecurrentGemma's attention layers)
  rglru  Griffin's recurrent block (conv1d + RG-LRU) + FFN
  moe    GQA self-attention + top-k mixture-of-experts FFN
  cross  cross-attention to the request's context + FFN (Llama-3.2-Vision)
  enc    bidirectional self-attention + FFN (Whisper's encoder)
  dec    self-attention + cross-attention to the encoded frames + FFN
         (Whisper's decoder)
  mlstm  xLSTM's mLSTM block (own up / down projections, no FFN)
  slstm  xLSTM's sLSTM block (a GLU projection as its FFN)

``bindense`` (the paper's XNOR-CNN) registers from :mod:`models.bcnn`.

Every kind implements:
  defs(cfg, n)                                stacked ParamDefs
  fwd(cfg, p, x, opts, ctx)                   full sequence -> (x, state)
  decode(cfg, p, x, state, pos, table, valid, ctx)
                                              one token per slot; dense
                                              cache when ``table`` is None
  chunk(cfg, p, x, state, pos0, valid, n_valid, table, ctx)
                                              one chunked-prefill piece
  state_spec(cfg, n, batch, s_max, device)    dense decode state
  state_pspec(cfg, ba, kv_shard, tp_size)     its placements, one layer
and ``tensor_parallel``: whether the kind computes on its blocks over
the model axis under :mod:`repro_torch.distributed.ctx` (``attn``,
``local``, ``moe``, ``rglru``, ``mlstm``, ``slstm`` and ``bindense``;
the context kinds' layers are gathered whole and compute as on one
device), with its ``tp_state_pspec``,
and, from :class:`PagedLayout`, the paged state its contract implies
(``paged_state_spec``, ``paged_split`` / ``paged_merge``) and the session
migration surface (``export_slot`` / ``import_slot``).  A state is a tree
of tuples and NamedTuples over tensors, layer-stacked on axis 0 (per-slot
leaves carry the batch on axis 1); it is updated in place.  ``ctx`` is
the request's modality context, (B, T_ctx, d) in the config's dtype: raw
patch embeddings for ``cross``, encoded frames for ``dec``; None for the
kinds that do not read it.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.utils.checkpoint

from repro_torch.distributed import ctx as dctx
from repro_torch.distributed import sharding
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers, moe, registry, ssm
from repro_torch.models.attention import KVCache, PagedKVCache
from repro_torch.models.params import ParamDef
from repro_torch.models.registry import BlockContract, register


class FwdOpts(NamedTuple):
    want_state: bool = False  # prefill: return the decode state
    s_max: int = 0            # cache capacity when want_state
    q_chunk: int = 0          # self-attention's queries in chunks of this
    aux: list | None = None   # where a routed FFN appends its aux loss
    batch_sum: Callable | None = None   # sums over the ranks holding the
                              # batch's other blocks (the sharded step)


def _norm_def(cfg, n):
    return ParamDef((n, cfg.d_model), (None, None), torch.float32,
                    init="ones")


def _sub(p: dict, prefix: str) -> dict:
    cut = len(prefix)
    return {k[cut:]: v for k, v in p.items() if k.startswith(prefix)}


def _whole(*blocks: tuple) -> list:
    """(this rank's ceil-div block of a last dim, the dim's whole
    length) pairs -> the whole tensors, every rank's blocks in rank order
    through one ``ctx.gather_last``; the tensors themselves outside
    tensor parallelism.  A tensor that then enters a rank's share goes
    through ``ctx.enter``, so its gradient reaches the gather whole."""
    if dctx.tp_size() == 1:
        return [t for t, _ in blocks]
    k = dctx.tp_size()
    widths = [t.shape[-1] for t, _ in blocks]
    got = dctx.gather_last(torch.cat([t for t, _ in blocks], dim=-1))
    got = got.reshape(*got.shape[:-1], k, sum(widths))
    out, s = [], 0
    for (_, n), w in zip(blocks, widths):
        out.append(got[..., s:s + w].reshape(*got.shape[:-2], k * w)
                   [..., :n].contiguous())
        s += w
    return out


def _row_out(cfg, w, y: torch.Tensor, k: int) -> torch.Tensor:
    """``y`` (this rank's block of a dim of ``k``) @ the row-parallel
    ``w``: ``layers.row_linear`` on its valid part; ``layers.linear``
    outside tensor parallelism."""
    if dctx.tp_size() == 1:
        return layers.linear(y, w, cfg.quant)
    _, start, stop = dctx.extent(k)
    return layers.row_linear(y[..., :stop - start], w, cfg.quant, k)


def layer_params(p, i: int) -> dict:
    """Layer ``i`` of a segment's stacked parameters (views, no copies),
    or of a sharded step's ``ctx.Segment`` (its blocks gathered)."""
    if isinstance(p, dctx.Segment):
        return p.layer(i)
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


# -- state trees: tuples and NamedTuples over tensors, None for no state ------

def state_map(fn, tree, *rest):
    """Same-structure tree of ``fn(leaf, *leaves of rest)``; None stays."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    kids = [state_map(fn, t, *(r[i] for r in rest))
            for i, t in enumerate(tree)]
    return type(tree)(*kids) if hasattr(tree, "_fields") else tuple(kids)


def state_leaves(tree) -> list:
    """The tree's tensors in order (none for None)."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for t in tree for leaf in state_leaves(t)]


def _stack(trees: list):
    """Per-layer trees -> one tree of layer-stacked leaves."""
    if trees[0] is None:
        return None
    flat = [state_leaves(t) for t in trees]
    it = iter([torch.stack(ls) for ls in zip(*flat)])
    return state_map(lambda _: next(it), trees[0])


def _layer(tree, i: int):
    """Layer ``i`` of a layer-stacked tree (views)."""
    return state_map(lambda l: l[i], tree)


def _copy_state(dst, src) -> None:
    """Write a state tree's new values into the resident one, in place."""
    for leaf, t in zip(state_leaves(dst), state_leaves(src)):
        leaf.copy_(t)


def _conv_buf(u: torch.Tensor, w1: int, dtype) -> torch.Tensor:
    """The conv carry after a full prompt: its last ``w1`` inputs, the
    zeros before the sequence filling in for a prompt shorter than that."""
    buf = u[:, -w1:]
    if buf.shape[1] < w1:
        buf = torch.nn.functional.pad(buf, (0, 0, w1 - buf.shape[1], 0))
    return buf.to(dtype).contiguous()


class PagedLayout:
    """Serving state derived from the kind's contract, as the reference's
    ``PagedLayout`` derives it:

      ``paged_kv`` only         the state IS the shared pool: one
                                layer-stacked :class:`PagedKVCache` (no
                                batch axis) addressed through block tables
      ``per_slot_state`` only   paged layout == dense layout: the per-slot
                                leaves ride the batch axis (recurrent
                                state is O(1) a slot; nothing to page)
      both                      a ``(pool, per_slot)`` pair
      neither                   stateless; None flows through everything

    Kinds with ``per_slot_state`` may override :meth:`slot_spec` (default:
    the dense :meth:`state_spec`, right whenever the dense state is all
    per-slot)."""

    tensor_parallel = False

    @classmethod
    def tp_state_pspec(cls, cfg, ba):
        """A tensor-parallel kind's dense-state placements in the sharded
        steps: the reference's (``state_pspec``) unless the kind says
        otherwise."""
        return cls.state_pspec(cfg, ba)

    @classmethod
    def slot_spec(cls, cfg, n, batch, device):
        return cls.state_spec(cfg, n, batch, 0, device)

    @classmethod
    def paged_state_spec(cls, cfg, n, batch, n_blocks, block_size, device):
        c = cls.contract
        pool = (PagedKVCache.zeros(cfg, n_blocks, block_size, _kv_dtype(cfg),
                                   device, n) if c.paged_kv else None)
        slot = cls.slot_spec(cfg, n, batch, device) if c.per_slot_state \
            else None
        return cls.paged_merge(pool, slot)

    @classmethod
    def paged_split(cls, state):
        """-> (shared pool leaves, per-slot leaves)."""
        c = cls.contract
        if c.paged_kv and c.per_slot_state:
            return state[0], state[1]
        if c.paged_kv:
            return state, None
        return None, state

    @classmethod
    def paged_merge(cls, shared, per_slot):
        c = cls.contract
        if c.paged_kv and c.per_slot_state:
            return (shared, per_slot)
        if c.paged_kv:
            return shared
        return per_slot

    # -- slot extraction / injection (session migration) ---------------------

    @classmethod
    def export_slot(cls, state, slot: int, ids: torch.Tensor | None):
        """One slot's complete state out of the layer-stacked paged layout
        -> the reference's ``(shared, per_slot)`` pair: pool blocks
        gathered in table-row order through ``ids`` (the slot's full (W,)
        row; unused entries name the trash block 0, whose garbage travels
        along and is never read; row order alone fixes a window ring's
        position -> block mapping), and the slot's per-slot leaves at batch
        width 1 (copies).  A pure read; None for a half the kind lacks."""
        shared, per_slot = cls.paged_split(state)
        sh = None
        if shared is not None:
            idx = ids.to(shared[0].device, torch.int64)
            sh = state_map(lambda l: l.index_select(1, idx), shared)
        ps = state_map(lambda l: l[:, slot:slot + 1].clone(), per_slot)
        return (sh, ps)

    @classmethod
    def import_slot(cls, state, slot: int, ids: torch.Tensor | None,
                    payload) -> None:
        """Inverse of :meth:`export_slot`, in place: the payload's blocks
        go to the *destination* row ``ids`` (same width, fresh ids; unused
        entries 0, so the carried garbage lands in the trash block), its
        per-slot leaves to ``slot``."""
        sh_p, ps_p = payload
        shared, per_slot = cls.paged_split(state)
        if shared is not None:
            idx = ids.to(shared[0].device, torch.int64)
            for l, q in zip(state_leaves(shared), state_leaves(sh_p)):
                l[:, idx] = q.to(l.device, l.dtype)
        for l, q in zip(state_leaves(per_slot), state_leaves(ps_p)):
            l[:, slot:slot + 1] = q.to(l.device, l.dtype)


class _FfnBlock(PagedLayout):
    """A mixer's output ``a`` joins the residual, then the FFN, which a
    kind overrides through :meth:`_ffn_defs` and :meth:`_ffn` (``MoeBlock``
    routes it)."""

    @classmethod
    def _ffn_defs(cls, cfg, n):
        return {f"ffn_{k}": v for k, v in layers.ffn_defs(cfg, n).items()}

    @classmethod
    def _ffn(cls, cfg, p, h, valid=None, opts=None):
        """The FFN of the normed residual ``h`` (dense SwiGLU); ``valid``
        marks a chunk's real tokens and ``opts.aux`` (a list; ``opts`` may
        be None) takes the auxiliary loss, which only a routed FFN reads
        or has."""
        return layers.ffn(cfg, _sub(p, "ffn_"), h)

    @staticmethod
    def _add_norm(x, a, scale):
        """-> (x + a, RMSNorm of the sum): the norm reads the residual sum
        in f32, unrounded — XLA folds the bf16 rounding of x + a into the
        norm's cast to f32 (it allows excess precision) — while the
        residual stream itself stays rounded."""
        return x + a, layers.rms_norm(x.float() + a, scale, dtype=x.dtype)

    @classmethod
    def _residual_ffn(cls, cfg, p, x, a, valid=None, opts=None):
        """The mixer's output ``a`` joins the residual; ln2 of the sum
        (:meth:`_add_norm`) feeds the FFN."""
        x, h = cls._add_norm(x, a, p["ln2"])
        return x + cls._ffn(cfg, p, h, valid, opts)


@register
class AttnBlock(_FfnBlock):
    contract = BlockContract("attn", paged_kv=True, table_class="full",
                             prefix_shareable=True)
    causal = True
    window = 0
    tensor_parallel = True

    @classmethod
    def defs(cls, cfg, n):
        defs = {"ln1": _norm_def(cfg, n), "ln2": _norm_def(cfg, n)}
        defs |= {f"attn_{k}": v for k, v in attn_mod.attn_defs(cfg, n).items()}
        return defs | cls._ffn_defs(cfg, n)

    @classmethod
    def _win(cls, cfg) -> int:
        return cfg.local_window if cls.window else 0

    @classmethod
    def fwd(cls, cfg, p, x, opts: FwdOpts, ctx=None):
        """Full-sequence prefill: x (B, S, d) -> (x, KVCache or None); a
        window's cache holds min(s_max, window) positions as a ring."""
        h = layers.rms_norm(x, p["ln1"])
        ap = _sub(p, "attn_")
        win = cls._win(cfg)
        state = None
        if opts.want_state:
            positions = torch.arange(h.shape[1], device=h.device)
            k, v = attn_mod._project_kv(cfg, ap, h, positions)
            cap = min(opts.s_max, win) if win else opts.s_max
            state = _kv_from_seq(cfg, k, v, cap, rolling=bool(win))
        a = attn_mod.attention(cfg, ap, h, causal=cls.causal, window=win,
                               q_chunk=opts.q_chunk)
        return cls._residual_ffn(cfg, p, x, a, opts=opts), state

    @classmethod
    def decode(cls, cfg, p, x, state, pos, table, valid=None, ctx=None):
        """One token per slot; ``table`` None reads the dense cache."""
        h = layers.rms_norm(x, p["ln1"])
        win = cls._win(cfg)
        if table is None:
            a = attn_mod.decode_attention(cfg, _sub(p, "attn_"), h, state,
                                          pos, window=win)
        else:
            a = attn_mod.paged_attention(cfg, _sub(p, "attn_"), h, state,
                                         table, pos, window=win, valid=valid)
        return cls._residual_ffn(cfg, p, x, a)

    @classmethod
    def chunk(cls, cfg, p, x, state, pos0, valid, n_valid, table, ctx=None):
        """One chunked-prefill piece: x (1, C, d) at positions
        pos0 .. pos0 + C - 1; ``valid`` (1, C) marks the first
        ``n_valid`` tokens, the real ones."""
        h = layers.rms_norm(x, p["ln1"])
        a = attn_mod.paged_attention(cfg, _sub(p, "attn_"), h, state, table,
                                     pos0, window=cls._win(cfg), valid=valid)
        return cls._residual_ffn(cfg, p, x, a, valid)

    @classmethod
    def state_spec(cls, cfg, n, batch, s_max, device):
        win = cls._win(cfg)
        cap = min(s_max, win) if win else s_max
        return KVCache.zeros(cfg, batch, cap, _kv_dtype(cfg), device, n)

    @classmethod
    def state_pspec(cls, cfg, ba, kv_shard: str = "heads",
                    tp_size: int = 16):
        """One layer's dense-state placements (``ba``: the batch mesh
        axes): the cache (B, KV, S, dh) split over the model axis by its
        KV heads (``"heads"``) or its positions (``"seq"``)."""
        if kv_shard == "seq":
            spec = (ba, None, "model", None)
        else:
            spec = (ba, "model", None, None)
        return KVCache(spec, spec)

    @classmethod
    def tp_state_pspec(cls, cfg, ba):
        """The cache's placement in the tensor-parallel serving steps: its
        KV heads split as ``wk``'s columns (the KV heads a rank's query
        heads read)."""
        spec = (ba, sharding.Heads("model", cfg.n_heads, 1, cfg.q_per_kv),
                None, None)
        return KVCache(spec, spec)


@register
class LocalBlock(AttnBlock):
    # a window ring recycles physical blocks in place: never shareable
    contract = BlockContract("local", paged_kv=True, table_class="win",
                             window=True)
    window = 1


@register
class EncBlock(AttnBlock):
    """Whisper's encoder layer: bidirectional self-attention + FFN.  It
    runs inside ``lm.encode`` only, never in the decode path."""
    contract = BlockContract("enc", paged_kv=True, table_class="full",
                             decodes=False)
    causal = False
    tensor_parallel = False


@register
class MoeBlock(AttnBlock):
    """Attention, then a top-k mixture of experts in place of the dense
    FFN; its decode state is the attention's paged KV."""
    contract = BlockContract("moe", paged_kv=True, table_class="full",
                             prefix_shareable=True, routed_experts=True)

    @classmethod
    def _ffn_defs(cls, cfg, n):
        return {f"moe_{k}": v for k, v in moe.moe_defs(cfg, n).items()}

    @classmethod
    def _ffn(cls, cfg, p, h, valid=None, opts=None):
        y, loss = moe.moe_ffn(cfg, _sub(p, "moe_"), h, valid=valid,
                              batch_sum=opts and opts.batch_sum)
        if opts is not None and opts.aux is not None:
            opts.aux.append(loss)
        return y


@register
class RglruBlock(_FfnBlock):
    """Griffin's recurrent block: a gated branch gelu(h W_gate) times the
    RG-LRU over conv1d(h W_x), projected by W_out; then the FFN.  The
    state is per slot: ``(RGLRUState(h (B, d) f32), conv buffer (B, W-1,
    d) in cfg.dtype)``.

    Under tensor parallelism a rank computes its block of the d channels:
    ``w_gate`` / ``w_x`` columns, the conv, ``lam`` and the RG-LRU on them
    (the state its block, as the reference places it); ``w_r`` / ``w_i``
    read the whole conv output (gathered once a layer call) into their
    column blocks, and ``w_out`` is row parallel."""
    contract = BlockContract("rglru", per_slot_state=True)
    tensor_parallel = True

    @classmethod
    def defs(cls, cfg, n):
        d = cfg.d_model

        def lin(spec=(None, "fsdp", "tp")):
            return ParamDef((n, d, d), spec, cfg.dtype, binarize=True)
        return {
            "ln1": _norm_def(cfg, n), "ln2": _norm_def(cfg, n),
            "w_gate": lin(), "w_x": lin(),
            "conv_k": ParamDef((n, cfg.conv_width, d), (None, None, "tp"),
                               torch.float32, scale=0.5),
            "w_r": lin(), "w_i": lin(),
            "lam": ParamDef((n, d), (None, "tp"), torch.float32,
                            init="ones"),
            "w_out": lin((None, "tp", "fsdp")),
        } | cls._ffn_defs(cfg, n)

    @classmethod
    def _mix(cls, cfg, p, h):
        h = dctx.enter(h)
        return (layers.gelu(layers.linear(h, p["w_gate"], cfg.quant)),
                layers.linear(h, p["w_x"], cfg.quant))

    @classmethod
    def _gates(cls, cfg, p, uc):
        (uc,) = _whole((uc, cfg.d_model))
        uc = dctx.enter(uc)
        return (layers.linear(uc, p["w_r"], cfg.quant),
                layers.linear(uc, p["w_i"], cfg.quant))

    @classmethod
    def fwd(cls, cfg, p, x, opts: FwdOpts, ctx=None):
        h = layers.rms_norm(x, p["ln1"])
        g, u = cls._mix(cfg, p, h)
        uc = ssm.conv1d(u, p["conv_k"])
        r, i = cls._gates(cfg, p, uc.to(u.dtype))
        st0 = ssm.RGLRUState.zeros(x.shape[0], u.shape[-1], x.device)
        y, st = ssm.rglru(uc, r, i, p["lam"], cfg.rglru_c, st0)
        x = cls._residual_ffn(cfg, p, x, _row_out(cfg, p["w_out"], g * y,
                                                  cfg.d_model))
        state = None
        if opts.want_state:
            state = (st, _conv_buf(u, cfg.conv_width - 1, cfg.dtype))
        return x, state

    @classmethod
    def decode(cls, cfg, p, x, state, pos, table, valid=None, ctx=None):
        """One token per slot; the state is written in place (the caller
        freezes inactive slots)."""
        st, buf = state
        h = layers.rms_norm(x, p["ln1"])
        g, u = cls._mix(cfg, p, h)
        uc, buf_new = ssm.conv1d_step(buf, u, p["conv_k"])
        r, i = cls._gates(cfg, p, uc)
        y, st_new = ssm.rglru_step(uc, r, i, p["lam"], cfg.rglru_c, st)
        x = cls._residual_ffn(cfg, p, x, _row_out(cfg, p["w_out"], g * y,
                                                  cfg.d_model))
        st.h.copy_(st_new.h)
        buf.copy_(buf_new)
        return x

    @classmethod
    def chunk(cls, cfg, p, x, state, pos0, valid, n_valid, table, ctx=None):
        st, buf = state
        h = layers.rms_norm(x, p["ln1"])
        g, u = cls._mix(cfg, p, h)
        uc = ssm.conv1d_carry(buf, u, p["conv_k"])
        r, i = cls._gates(cfg, p, uc.to(u.dtype))
        y, st_new = ssm.rglru(uc, r, i, p["lam"], cfg.rglru_c, st,
                              valid=valid)
        x = cls._residual_ffn(cfg, p, x, _row_out(cfg, p["w_out"], g * y,
                                                  cfg.d_model))
        st.h.copy_(st_new.h)
        buf.copy_(ssm.conv1d_carry_out(buf, u, n_valid))
        return x

    @classmethod
    def state_spec(cls, cfg, n, batch, s_max, device):
        d, w1 = cfg.d_model, cfg.conv_width - 1
        return (ssm.RGLRUState(torch.zeros((n, batch, d), dtype=torch.float32,
                                           device=device)),
                torch.zeros((n, batch, w1, d), dtype=cfg.dtype,
                            device=device))

    @classmethod
    def state_pspec(cls, cfg, ba, kv_shard: str = "heads",
                    tp_size: int = 16):
        return (ssm.RGLRUState((ba, "model")), (ba, None, "model"))


@register
class MlstmBlock(PagedLayout):
    """xLSTM's mLSTM block: up-projections u and z, a causal conv and SiLU
    on u, q / k from the conv's output and v from u, the matrix-memory
    cell (input and forget gates from the f32 ``w_if`` product), the
    cell's output normed by ``out_norm`` and gated by silu(z), projected
    down.  No FFN.  The state is per slot: ``(MLSTMState(c (B, NH, dh,
    dh), n (B, NH, dh), m (B, NH)), conv buffer (B, W-1, di) in
    cfg.dtype)``, the memory f32.

    Under tensor parallelism a rank holds its block of ``di`` (``w_up``,
    ``w_gate``, ``conv_k``, the q / k / v columns, ``out_norm``,
    ``w_down``'s rows) and its block of the memory's first dh axis (the
    ``v`` rows, as the reference places ``c``): the conv output and ``u``
    are gathered once a layer call, q, k and v once, and q, k, the
    ``w_if`` gates and the normalizer ``n . q`` are whole on every rank,
    so ``C q`` sums a whole k axis in the single-process order; the
    cell's output is gathered before ``out_norm`` (a whole-row norm).
    ``n`` and ``m`` stay whole."""
    contract = BlockContract("mlstm", per_slot_state=True)
    tensor_parallel = True

    @classmethod
    def _di(cls, cfg) -> int:
        return int(cfg.proj_factor * cfg.d_model)

    @classmethod
    def defs(cls, cfg, n):
        d, di, nh = cfg.d_model, cls._di(cfg), cfg.n_heads

        def lin(k, m, spec=(None, "fsdp", "tp")):
            return ParamDef((n, k, m), spec, cfg.dtype, binarize=True)
        return {
            "ln1": _norm_def(cfg, n),
            "w_up": lin(d, di), "w_gate": lin(d, di),
            "conv_k": ParamDef((n, cfg.conv_width, di), (None, None, "tp"),
                               torch.float32, scale=0.5),
            "wq": lin(di, di), "wk": lin(di, di), "wv": lin(di, di),
            "w_if": ParamDef((n, di, 2 * nh), (None, "fsdp", None),
                             torch.float32),
            "b_if": ParamDef((n, 2 * nh), (None, None), torch.float32,
                             init="zeros"),
            "out_norm": ParamDef((n, di), (None, "tp"), torch.float32,
                                 init="ones"),
            "w_down": lin(di, d, (None, "tp", "fsdp")),
        }

    @classmethod
    def _up(cls, cfg, p, x):
        h = dctx.enter(layers.rms_norm(x, p["ln1"]))
        return (layers.linear(h, p["w_up"], cfg.quant),
                layers.linear(h, p["w_gate"], cfg.quant))

    @classmethod
    def _rows(cls, cfg) -> tuple[int, int, int]:
        """This rank's block of the memory's first dh axis."""
        return dctx.extent(cls._di(cfg) // cfg.n_heads)

    @classmethod
    def _qkvif(cls, cfg, p, u, uc_in):
        """q, k (scaled by dh^-1/2 rounded to cfg.dtype), v (B, S, NH, dh)
        and the raw input and forget gates (B, S, NH), f32, from the conv's
        output ``uc_in`` (before its SiLU).  The ``w_if`` product reads
        the SiLU's last product unrounded, as the jitted reference does
        where an f32 cast follows it."""
        nh, di = cfg.n_heads, cls._di(cfg)
        dh = di // nh
        b, s = u.shape[:2]
        uc_in, u = _whole((uc_in, di), (u, di))
        uc = layers.silu(dctx.enter(uc_in))
        scale = torch.tensor(dh ** -0.5).to(u.dtype)
        q, k, v = _whole((layers.linear(uc, p["wq"], cfg.quant), di),
                         (layers.linear(uc, p["wk"], cfg.quant), di),
                         (layers.linear(dctx.enter(u), p["wv"], cfg.quant),
                          di))
        q = q.reshape(b, s, nh, dh)
        k = k.reshape(b, s, nh, dh) * scale
        v = v.reshape(b, s, nh, dh)
        gif = ssm.rows_matmul(layers.silu(uc_in, f32=True),
                              p["w_if"]) + p["b_if"]
        ig, fg = gif[..., :nh], gif[..., nh:]
        if dctx.tp_size() == 1:
            return q, k, v, ig, fg
        # the cell computes this rank's v rows: what enters it is whole
        rb, r0, r1 = cls._rows(cfg)
        v = torch.nn.functional.pad(dctx.enter(v)[..., r0:r1],
                                    (0, rb - (r1 - r0)))
        return (*(dctx.enter(t) for t in (q, k)), v,
                *(dctx.enter(t) for t in (ig, fg)))

    @classmethod
    def _down(cls, cfg, p, x, hseq, z):
        """The cell's output (B, S, NH, dh) f32, normed, gated by silu(z)
        and projected down, joins the residual."""
        b, s = x.shape[:2]
        di = cls._di(cfg)
        (hseq,) = _whole((hseq, di // cfg.n_heads))
        hseq = dctx.enter(hseq).reshape(b, s, di).to(x.dtype)
        _, c0, c1 = dctx.extent(di)
        hseq = layers.rms_norm(hseq, p["out_norm"], cols=slice(c0, c1)) \
            * layers.silu(z[..., :c1 - c0])
        return x + _row_out(cfg, p["w_down"], hseq, di)

    @classmethod
    def fwd(cls, cfg, p, x, opts: FwdOpts, ctx=None):
        b, s, _ = x.shape
        u, z = cls._up(cfg, p, x)
        uc = ssm.conv1d(u, p["conv_k"]).to(u.dtype)
        q, k, v, ig, fg = cls._qkvif(cfg, p, u, uc)
        nh = cfg.n_heads
        st0 = ssm.MLSTMState.zeros(b, nh, cls._di(cfg) // nh, x.device,
                                   rows=v.shape[-1])
        hseq, st = ssm.mlstm_chunkwise(q, k, v, ig, fg, st0,
                                       min(cfg.mlstm_chunk, s))
        x = cls._down(cfg, p, x, hseq, z)
        state = None
        if opts.want_state:
            state = (st, _conv_buf(u, cfg.conv_width - 1, cfg.dtype))
        return x, state

    @classmethod
    def decode(cls, cfg, p, x, state, pos, table, valid=None, ctx=None):
        """One token per slot; the state is written in place (the caller
        freezes inactive slots)."""
        st, buf = state
        u, z = cls._up(cfg, p, x)
        uc, buf_new = ssm.conv1d_step(buf, u, p["conv_k"])
        # the step's einsum leaves the rows strided (d-major); a reduction
        # over a strided row orders its sum by the batch (hazard H2)
        q, k, v, ig, fg = cls._qkvif(cfg, p, u, uc.contiguous())
        h, st_new = ssm.mlstm_step(st, q[:, 0], k[:, 0], v[:, 0], ig[:, 0],
                                   fg[:, 0])
        x = cls._down(cfg, p, x, h[:, None], z)
        _copy_state(st, st_new)
        buf.copy_(buf_new)
        return x

    @classmethod
    def chunk(cls, cfg, p, x, state, pos0, valid, n_valid, table, ctx=None):
        """One chunked-prefill piece; padding positions get state-neutral
        gates (i = -1e30: nothing inserted; f = +1e30: no decay), so the
        carried state is the unpadded one."""
        st, buf = state
        u, z = cls._up(cfg, p, x)
        uc = ssm.conv1d_carry(buf, u, p["conv_k"]).to(u.dtype)
        q, k, v, ig, fg = cls._qkvif(cfg, p, u, uc)
        keep = valid[..., None]
        ig = torch.where(keep, ig, -1e30)
        fg = torch.where(keep, fg, 1e30)
        hseq, st_new = ssm.mlstm_chunkwise(q, k, v, ig, fg, st,
                                           min(cfg.mlstm_chunk, x.shape[1]))
        x = cls._down(cfg, p, x, hseq, z)
        _copy_state(st, st_new)
        buf.copy_(ssm.conv1d_carry_out(buf, u, n_valid))
        return x

    @classmethod
    def state_spec(cls, cfg, n, batch, s_max, device):
        di, nh = cls._di(cfg), cfg.n_heads
        return (ssm.MLSTMState.zeros(batch, nh, di // nh, device, (n,)),
                torch.zeros((n, batch, cfg.conv_width - 1, di),
                            dtype=cfg.dtype, device=device))

    @classmethod
    def state_pspec(cls, cfg, ba, kv_shard: str = "heads",
                    tp_size: int = 16):
        # NH rarely divides the model axis: the memory's first dh axis
        return (ssm.MLSTMState((ba, None, "model", None), (ba, None, "model"),
                               (ba, None)), (ba, None, "model"))

    @classmethod
    def tp_state_pspec(cls, cfg, ba):
        """The reference's, but ``n`` whole: every rank computes the
        normalizer ``n . q`` in the single-process order."""
        return (ssm.MLSTMState((ba, None, "model", None), (ba, None, None),
                               (ba, None)), (ba, None, "model"))


@register
class SlstmBlock(_FfnBlock):
    """xLSTM's sLSTM block: the four gates' input preactivations from
    ``w_gates``, the scalar-memory cell with its block-diagonal recurrent
    ``r_kernel`` (run one token at a time), then a GLU projection
    ``a * gelu(g)`` of width ``int(4 d / 3 / 64) * 64`` as the block's
    FFN.  The state is per slot: ``SLSTMState(c, n, m, h)``, each (B, d)
    f32.

    Under tensor parallelism a rank computes its column block of
    ``w_gates``, gathered whole once a layer call: the cell's recurrent
    product mixes a head's channels every token, so the cell runs whole
    on every rank (a sequential recurrence: no collective a token) and so
    does its state.  The GLU's ``w_up`` is placed by pieces
    (``sharding.Parts``): a rank holds ``a`` and ``g`` of its channels,
    computes ``a * gelu(g)`` on them, and ``w_down`` is row parallel."""
    contract = BlockContract("slstm", per_slot_state=True)
    tensor_parallel = True

    @classmethod
    def _dff(cls, cfg) -> int:
        """The GLU's up width (a 4/3 factor, both halves)."""
        return int(4 * cfg.d_model / 3 / 64) * 64 * 2

    @classmethod
    def defs(cls, cfg, n):
        d, nh = cfg.d_model, cfg.n_heads
        dh = d // nh
        dff = cls._dff(cfg)
        return {
            "ln1": _norm_def(cfg, n),
            "w_gates": ParamDef((n, d, 4 * d), (None, "fsdp", "tp"), cfg.dtype,
                                binarize=True),
            # tiny, and nh does not divide a wide tp axis: whole
            "r_kernel": ParamDef((n, 4, nh, dh, dh), (None,) * 5,
                                 torch.float32, scale=0.05),
            "ln2": _norm_def(cfg, n),
            "w_up": ParamDef((n, d, dff), (None, "fsdp", "tp"), cfg.dtype,
                             binarize=True, parts=2),
            "w_down": ParamDef((n, dff // 2, d), (None, "tp", "fsdp"),
                               cfg.dtype,
                               binarize=True),
        }

    @classmethod
    def _ffn(cls, cfg, p, h, valid=None, opts=None):
        a, g = layers.linear(dctx.enter(h), p["w_up"], cfg.quant).chunk(
            2, dim=-1)
        return _row_out(cfg, p["w_down"], a * layers.gelu(g),
                        cls._dff(cfg) // 2)

    @classmethod
    def _gates(cls, cfg, p, x):
        h = dctx.enter(layers.rms_norm(x, p["ln1"]))
        (gates,) = _whole((layers.linear(h, p["w_gates"], cfg.quant),
                           4 * cfg.d_model))
        return gates

    @classmethod
    def fwd(cls, cfg, p, x, opts: FwdOpts, ctx=None):
        st0 = ssm.SLSTMState.zeros(x.shape[0], cfg.d_model, x.device)
        y, st = ssm.slstm_sequence(cls._gates(cfg, p, x), p["r_kernel"],
                                   st0, cfg.n_heads)
        x = cls._residual_ffn(cfg, p, x, y.to(x.dtype))
        return x, (st if opts.want_state else None)

    @classmethod
    def decode(cls, cfg, p, x, state, pos, table, valid=None, ctx=None):
        st_new, y = ssm.slstm_step(state, cls._gates(cfg, p, x)[:, 0],
                                   p["r_kernel"], cfg.n_heads)
        _copy_state(state, st_new)
        return cls._residual_ffn(cfg, p, x, y[:, None].to(x.dtype))

    @classmethod
    def chunk(cls, cfg, p, x, state, pos0, valid, n_valid, table, ctx=None):
        y, st_new = ssm.slstm_sequence(cls._gates(cfg, p, x), p["r_kernel"],
                                       state, cfg.n_heads, valid=valid)
        _copy_state(state, st_new)
        return cls._residual_ffn(cfg, p, x, y.to(x.dtype))

    @classmethod
    def state_spec(cls, cfg, n, batch, s_max, device):
        return ssm.SLSTMState.zeros(batch, cfg.d_model, device, (n,))

    @classmethod
    def state_pspec(cls, cfg, ba, kv_shard: str = "heads",
                    tp_size: int = 16):
        return ssm.SLSTMState(*((ba, "model"),) * 4)

    @classmethod
    def tp_state_pspec(cls, cfg, ba):
        """Whole over ``model``: the cell runs whole on every rank."""
        return ssm.SLSTMState(*((ba, None),) * 4)


def _ctx_kv_spec(cfg, n, batch, device) -> tuple:
    """Zeroed per-slot ``ctx_kv``: (k, v) each (n, batch, T_ctx, KV, dh)
    in the config's dtype."""
    shp = (n, batch, cfg.n_ctx_tokens, cfg.n_kv_heads, cfg.d_head)
    return (torch.zeros(shp, dtype=cfg.dtype, device=device),
            torch.zeros(shp, dtype=cfg.dtype, device=device))


def _keep_ctx_kv(state, ctx_kv) -> None:
    """Write a chunk's ``ctx_kv`` into the slot's per-slot state."""
    for leaf, t in zip(state, ctx_kv):
        leaf.copy_(t)


@register
class CrossBlock(_FfnBlock):
    """Cross-attention to the request's context + FFN (Llama-3.2-Vision's
    image layers).  The state is per slot: the context's keys and values
    ``ctx_kv``, (k, v) each (B, T_ctx, KV, dh), projected from the raw
    context on every prefill chunk (as the reference does) and read, never
    written, by decode.  ``ctx_kv`` is a pure function of the context, so a
    prefix shared between requests of one context cannot go stale."""
    contract = BlockContract("cross", per_slot_state=True,
                             prefix_shareable=True, decode_writes_slot=False)

    @classmethod
    def defs(cls, cfg, n):
        defs = {"ln1": _norm_def(cfg, n), "ln2": _norm_def(cfg, n)}
        defs |= {f"attn_{k}": v
                 for k, v in attn_mod.attn_defs(cfg, n, cross=True).items()}
        return defs | cls._ffn_defs(cfg, n)

    @classmethod
    def fwd(cls, cfg, p, x, opts: FwdOpts, ctx=None):
        ap = _sub(p, "attn_")
        ctx_kv = attn_mod.make_ctx_kv(cfg, ap, ctx)
        h = layers.rms_norm(x, p["ln1"])
        a = attn_mod.cross_attention(cfg, ap, h, ctx_kv)
        state = (tuple(t.contiguous() for t in ctx_kv) if opts.want_state
                 else None)
        return cls._residual_ffn(cfg, p, x, a), state

    @classmethod
    def decode(cls, cfg, p, x, state, pos, table, valid=None, ctx=None):
        h = layers.rms_norm(x, p["ln1"])
        a = attn_mod.decode_cross_attention(cfg, _sub(p, "attn_"), h, state)
        return cls._residual_ffn(cfg, p, x, a)

    @classmethod
    def chunk(cls, cfg, p, x, state, pos0, valid, n_valid, table, ctx=None):
        ap = _sub(p, "attn_")
        ctx_kv = attn_mod.make_ctx_kv(cfg, ap, ctx)
        _keep_ctx_kv(state, ctx_kv)
        h = layers.rms_norm(x, p["ln1"])
        a = attn_mod.cross_attention(cfg, ap, h, ctx_kv)
        return cls._residual_ffn(cfg, p, x, a, valid)

    @classmethod
    def state_spec(cls, cfg, n, batch, s_max, device):
        return _ctx_kv_spec(cfg, n, batch, device)

    @classmethod
    def state_pspec(cls, cfg, ba, kv_shard: str = "heads",
                    tp_size: int = 16):
        # ctx_kv (B, T_ctx, KV, dh): the context's tokens over the model
        # axis where they divide it, else whole
        if cfg.n_ctx_tokens % tp_size == 0:
            return ((ba, "model", None, None),) * 2
        return ((ba, None, None, None),) * 2


@register
class DecBlock(_FfnBlock):
    """Whisper's decoder layer: causal self-attention, cross-attention to
    the encoded frames (norm ``lnx``), FFN.  Its state is a ``(pool,
    per_slot)`` pair: the self-attention's paged pool (or, dense, its
    KVCache in ``kv_cache_dtype``) and the per-slot ``ctx_kv`` of the
    encoded frames, which decode reads and never writes."""
    contract = BlockContract("dec", paged_kv=True, per_slot_state=True,
                             table_class="full", prefix_shareable=True,
                             decode_writes_slot=False)

    @classmethod
    def defs(cls, cfg, n):
        defs = {"ln1": _norm_def(cfg, n), "ln2": _norm_def(cfg, n)}
        defs |= {f"attn_{k}": v for k, v in attn_mod.attn_defs(cfg, n).items()}
        defs["lnx"] = _norm_def(cfg, n)
        defs |= {f"xattn_{k}": v
                 for k, v in attn_mod.attn_defs(cfg, n, cross=True).items()}
        return defs | cls._ffn_defs(cfg, n)

    @classmethod
    def _cross_ffn(cls, cfg, p, x, a, ctx_kv, cross, valid=None):
        """The self-attention's output ``a`` joins the residual, lnx of the
        sum reads the encoded frames' ``ctx_kv`` through ``cross`` (decode
        passes :func:`attention.decode_cross_attention`, as the reference
        does), then the FFN."""
        x, h = cls._add_norm(x, a, p["lnx"])
        a = cross(cfg, _sub(p, "xattn_"), h, ctx_kv)
        return cls._residual_ffn(cfg, p, x, a, valid)

    @classmethod
    def fwd(cls, cfg, p, x, opts: FwdOpts, ctx=None):
        h = layers.rms_norm(x, p["ln1"])
        ap = _sub(p, "attn_")
        self_state = None
        if opts.want_state:
            positions = torch.arange(h.shape[1], device=h.device)
            k, v = attn_mod._project_kv(cfg, ap, h, positions)
            self_state = _kv_from_seq(cfg, k, v, opts.s_max)
        a = attn_mod.attention(cfg, ap, h, causal=True, q_chunk=opts.q_chunk)
        ctx_kv = attn_mod.make_ctx_kv(cfg, _sub(p, "xattn_"), ctx)
        x = cls._cross_ffn(cfg, p, x, a, ctx_kv, attn_mod.cross_attention)
        state = None
        if opts.want_state:
            state = (self_state, tuple(t.contiguous() for t in ctx_kv))
        return x, state

    @classmethod
    def decode(cls, cfg, p, x, state, pos, table, valid=None, ctx=None):
        self_cache, ctx_kv = state
        h = layers.rms_norm(x, p["ln1"])
        ap = _sub(p, "attn_")
        if table is None:
            a = attn_mod.decode_attention(cfg, ap, h, self_cache, pos)
        else:
            a = attn_mod.paged_attention(cfg, ap, h, self_cache, table, pos,
                                         valid=valid)
        return cls._cross_ffn(cfg, p, x, a, ctx_kv,
                              attn_mod.decode_cross_attention)

    @classmethod
    def chunk(cls, cfg, p, x, state, pos0, valid, n_valid, table, ctx=None):
        """``ctx`` is the encoded frames (1, T, d), encoded once at
        admission, not once a chunk."""
        self_cache, ctx_state = state
        h = layers.rms_norm(x, p["ln1"])
        a = attn_mod.paged_attention(cfg, _sub(p, "attn_"), h, self_cache,
                                     table, pos0, valid=valid)
        ctx_kv = attn_mod.make_ctx_kv(cfg, _sub(p, "xattn_"), ctx)
        _keep_ctx_kv(ctx_state, ctx_kv)
        return cls._cross_ffn(cfg, p, x, a, ctx_kv,
                              attn_mod.cross_attention, valid)

    @classmethod
    def slot_spec(cls, cfg, n, batch, device):
        return _ctx_kv_spec(cfg, n, batch, device)

    @classmethod
    def state_spec(cls, cfg, n, batch, s_max, device):
        # the self-cache honours kv_cache_dtype as AttnBlock's does
        return (KVCache.zeros(cfg, batch, s_max, _kv_dtype(cfg), device, n),
                cls.slot_spec(cfg, n, batch, device))

    @classmethod
    def state_pspec(cls, cfg, ba, kv_shard: str = "heads",
                    tp_size: int = 16):
        return (AttnBlock.state_pspec(cfg, ba, kv_shard, tp_size),
                CrossBlock.state_pspec(cfg, ba, kv_shard, tp_size))


# ---------------------------------------------------------------------------
# segment machinery
# ---------------------------------------------------------------------------

def segment_defs(cfg, segments=None) -> list:
    return [(kind, n, registry.get(kind).defs(cfg, n))
            for kind, n in (segments or cfg.segments())]


def segment_fwd(cfg, seg_params: list, x, opts: FwdOpts = FwdOpts(),
                ctx=None, remat: bool = False):
    """Every segment over a full sequence -> (x, the layers' summed
    auxiliary loss (f32 scalar: the routed FFNs' load balance, 0 without
    one), per-segment layer-stacked states, or Nones without
    ``opts.want_state``).  ``remat`` checkpoints each layer: under
    autograd its activations are recomputed in the backward pass instead
    of kept, which changes no value; a sharded step's layer is gathered
    inside the checkpoint, so the recompute gathers it again and no
    gathered leaf is kept between the passes."""
    aux, states = None, []
    for (kind, n), p in seg_params:
        block = registry.get(kind)
        sts = []
        with dctx.layers_of(block.tensor_parallel):
            for i in range(n):
                x, a, st = _layer_fwd(cfg, block, p, i, x, opts, ctx, remat)
                if a is not None:
                    aux = a if aux is None else aux + a
                sts.append(st)
        states.append(_stack(sts))
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux, states


def _layer_fwd(cfg, block, p, i: int, x, opts: FwdOpts, ctx, remat: bool):
    """Layer ``i`` of a segment's parameters ``p``: its ``fwd`` -> (x, its
    aux loss or None, state)."""
    snap = dctx.snapshot()

    def run(x):
        # the recompute runs on autograd's thread: the context goes along
        with dctx.restored(snap):
            sink = []
            y, st = block.fwd(cfg, layer_params(p, i), x,
                              opts._replace(aux=sink), ctx)
            return y, (sink[0] if sink else None), st
    if not (remat and torch.is_grad_enabled()):
        return run(x)
    if dctx.rules() is None:
        return torch.utils.checkpoint.checkpoint(run, x, use_reentrant=False)
    # the whole recompute on every rank: stopping at the last saved
    # tensor could stop ranks at different collectives
    with torch.utils.checkpoint.set_checkpoint_early_stop(False):
        return torch.utils.checkpoint.checkpoint(run, x, use_reentrant=False)


def _block_table(block, tables):
    """The block's (B, W) table under paged serving, else None — resolved
    through its declared table class."""
    if tables is None or not block.contract.paged_kv:
        return None
    return tables[block.contract.table_class]


def _freeze_inactive(per_slot, old, active: torch.Tensor) -> None:
    """Put inactive slots' per-slot rows back to ``old``, in place: a
    mid-prefill slot rides in the decode batch and its recurrent carry must
    not advance on the token it is fed.  Shared pool leaves need nothing
    (their writes are trash-routed through ``valid``)."""
    for leaf, o in zip(state_leaves(per_slot), state_leaves(old)):
        keep = active.reshape((1, -1) + (1,) * (leaf.ndim - 2))
        leaf.copy_(torch.where(keep, leaf, o))


def segment_decode(cfg, seg_params: list, x, states: list, pos,
                   tables: dict | None = None, active=None, ctx=None):
    """One token for every slot through every segment.  ``tables`` None
    reads the dense caches; otherwise the attn-family blocks go through
    their block tables.  ``active`` (B,) bool trash-routes inactive slots'
    paged writes (a dense cache's dead rows are inert by overwrite) and
    keeps their per-slot state as it was (a kind whose decode only reads
    it needs no copy)."""
    valid = None if active is None else active[:, None]
    for ((kind, n), p), st in zip(seg_params, states):
        block = registry.get(kind)
        table = _block_table(block, tables)
        _, per_slot = block.paged_split(st)
        old = (None if per_slot is None or active is None
               or not block.contract.decode_writes_slot
               else state_map(torch.clone, per_slot))
        with dctx.layers_of(block.tensor_parallel):
            for i in range(n):
                x = block.decode(cfg, layer_params(p, i), x, _layer(st, i),
                                 pos, table, valid=valid, ctx=ctx)
        if old is not None:
            _freeze_inactive(per_slot, old, active)
    return x


def segment_chunk(cfg, seg_params: list, x, states: list, slot: int, pos0,
                  valid, n_valid: int, tables: dict, fresh: bool = False,
                  ctx=None):
    """One chunked-prefill piece (B=1, S=C) through every segment.

    Per-slot leaves are viewed at ``slot`` (written in place), reset to
    their initial values when ``fresh`` (the request's first chunk
    overwrites what the slot's previous tenant left); shared pools pass
    whole (the block table confines writes to this slot's blocks).
    ``tables`` rows are this slot's (1, W) rows; ``ctx`` (1, T_ctx, d) is
    the request's context."""
    for ((kind, n), p), st in zip(seg_params, states):
        block = registry.get(kind)
        table = _block_table(block, tables)
        shared, per_slot = block.paged_split(st)
        ps = state_map(lambda l: l[:, slot:slot + 1], per_slot)
        if ps is not None and fresh:
            init = block.slot_spec(cfg, n, 1, x.device)
            state_map(lambda l, i: l.copy_(i), ps, init)
        for i in range(n):
            st_i = block.paged_merge(_layer(shared, i), _layer(ps, i))
            x = block.chunk(cfg, layer_params(p, i), x, st_i, pos0, valid,
                            n_valid, table, ctx)
    return x


def segment_copy_block(cfg, states: list, src: int, dst: int) -> None:
    """Copy physical block ``src`` -> ``dst`` in every shared pool (the
    device half of copy-on-write prefix sharing).  Block ids are unique
    across table classes, so copying in every pool is safe; per-slot
    leaves are never block-granular and pass untouched."""
    for (kind, _), st in zip(cfg.segments(), states):
        shared, _ = registry.get(kind).paged_split(st)
        if shared is not None:
            shared.copy_block(src, dst)


def _row(block, ids: dict):
    c = block.contract
    return ids[c.table_class] if c.paged_kv else None


def segment_export_slot(cfg, states: list, slot: int, ids: dict) -> tuple:
    """One slot's state out of every segment: ``ids`` maps table class ->
    the slot's full (W,) row, resolved through each kind's contract.
    Returns a tuple of per-segment ``(shared, per_slot)`` payloads."""
    out = []
    for (kind, _), st in zip(cfg.segments(), states):
        block = registry.get(kind)
        out.append(block.export_slot(st, slot, _row(block, ids)))
    return tuple(out)


def segment_import_slot(cfg, states: list, slot: int, ids: dict,
                        payloads) -> None:
    """Inverse of :func:`segment_export_slot`, in place, into ``slot`` and
    the destination rows ``ids``."""
    for (kind, _), st, pl in zip(cfg.segments(), states, payloads):
        block = registry.get(kind)
        block.import_slot(st, slot, _row(block, ids), pl)


def segment_gather_block(cfg, states: list, bid: int) -> tuple:
    """Physical block ``bid`` of every shared pool (None for segments with
    no pool): the integrity scrubber's view of an idle cached block;
    per-slot state is not part of a block's identity."""
    out = []
    for (kind, _), st in zip(cfg.segments(), states):
        shared, _ = registry.get(kind).paged_split(st)
        out.append(state_map(lambda l: l[:, bid].clone(), shared))
    return tuple(out)


def segment_states(cfg, segments, batch: int, s_max: int, device) -> list:
    """Dense decode states per segment, layer-stacked: ``(n, batch, KV,
    s_max, dh)`` caches (a window's capped at the window) and per-slot
    ``(n, batch, ...)`` leaves."""
    return [registry.get(kind).state_spec(cfg, n, batch, s_max, device)
            for kind, n in segments]


def segment_state_pspecs(cfg, segments, ba, kv_shard: str = "heads",
                         tp_size: int = 16, head_aligned: bool = False
                         ) -> list:
    """Placements of :func:`segment_states`' leaves, the layer axis whole:
    each kind's ``state_pspec`` laid over its state's structure.
    ``head_aligned``: the tensor-parallel serving steps' own (a
    ``tensor_parallel`` kind's ``tp_state_pspec``; every other kind's
    state whole in its model-axis dims)."""
    out = []
    for kind, n in segments:
        block = registry.get(kind)
        like = block.state_spec(cfg, 1, 1, 1, "meta")
        if head_aligned and block.tensor_parallel:
            spec = block.tp_state_pspec(cfg, ba)
        else:
            spec = block.state_pspec(cfg, ba, kv_shard, tp_size)
        whole = head_aligned and not block.tensor_parallel
        out.append(state_map(
            lambda _, s: (None, *(sharding.without(a, "model") if whole
                                  else a for a in s)), like, spec))
    return out


def segment_paged_states(cfg, segments, batch: int, n_blocks: int,
                         block_size: int, device) -> list:
    """Paged states per segment: layer-stacked shared pools
    ``(n, n_blocks, KV, block_size, dh)`` and per-slot ``(n, batch, ...)``
    leaves, as each kind's contract says."""
    return [registry.get(kind).paged_state_spec(cfg, n, batch, n_blocks,
                                                block_size, device)
            for kind, n in segments]
