"""The ``cross``, ``enc`` and ``dec`` kinds (Llama-3.2-Vision's image
layers, Whisper's encoder and decoder) in the port against the JAX
package: ``cross_attention`` and ``make_ctx_kv``, each block's full
prefill, dense decode and paged chunk, ``lm.encode``, and the model's
prefill, chunked prefill and decode with a context.

Inputs and weights are made from a seed (numpy / ``jax.random``) and
converted.  f32 is held at 1e-4 (the paged tests' tolerance: XLA's
``exp`` and ``rsqrt`` differ from torch's in the last bit); bf16 is held
bit for bit against the reference run jitted, as its engine runs it (XLA
folds the bf16 rounding of a residual sum into the next RMSNorm's cast to
f32, before ``lnx`` as before ``ln2``; the port's ``_add_norm`` reads the
same unrounded sum), and bf16 logits within ``BF16_LOGIT_BOUND``.  The
engines' tokens are in ``test_torch_vlm_serve*.py`` and
``test_torch_encdec_serve*.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import attention as jattn
from repro.models import blocks as jblocks
from repro.models import lm as jlm
import repro_torch.configs as configs
from repro_torch import convert
from repro_torch.models import attention as attn_mod
from repro_torch.models import blocks, lm
from repro_torch.serve import Request, ServeEngine

from test_torch_layers import BF16_LOGIT_BOUND

VLM = "llama-3.2-vision-11b"
ENCDEC = "whisper-tiny"
# (kind, arch, segment): the cross block is segment 1 of the vision arch
# (4 attn, then 1 cross at smoke size)
BLOCKS = [("cross", VLM, "seg1_cross"), ("enc", ENCDEC, "enc0_enc"),
          ("dec", ENCDEC, "seg0_dec")]


def _setup(name, dtype=torch.float32, seed=0):
    jcfg = jconfigs.get(name).smoke(dtype=jnp.dtype(str(dtype)[6:]))
    cfg = configs.get(name).smoke(dtype=dtype)
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, jp, cfg, convert.from_jax(cfg, jax.tree.map(np.asarray, jp))


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _both(a, dtype):
    """A float32 numpy array as the reference's and the port's input in
    ``dtype``, the same values in both."""
    j = jnp.asarray(a.astype(np.float32)).astype(jnp.dtype(str(dtype)[6:]))
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(dtype)


def _hold(got, want, dtype, what):
    if dtype == torch.float32:
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4,
                                   atol=1e-4, err_msg=what)
    else:
        np.testing.assert_array_equal(_np(got), _np(want), err_msg=what)


def _hold_trees(got, want, dtype, what):
    g, w = blocks.state_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w), what
    for i, (a, b) in enumerate(zip(g, w)):
        assert tuple(a.shape) == tuple(b.shape), (what, i)
        _hold(a, b, dtype, f"{what} leaf {i}")


def test_smoke_shapes_are_the_references():
    """The vision arch: 4 attn layers then 1 cross at smoke size, 16
    context tokens; Whisper: 2 dec layers over a 2-layer encoder, MHA;
    full size: 8 cross of 40 layers over 1,600 tokens, 4 + 4 layers over
    1,500 frames."""
    v, jv = configs.get(VLM).smoke(), jconfigs.get(VLM).smoke()
    assert v.segments() == jv.segments() == [("attn", 4), ("cross", 1)]
    assert v.n_ctx_tokens == jv.n_ctx_tokens == 16 and not v.is_encdec()
    w, jw = configs.get(ENCDEC).smoke(), jconfigs.get(ENCDEC).smoke()
    assert w.segments() == jw.segments() == [("dec", 2)]
    assert w.encoder_segments() == jw.encoder_segments() == [("enc", 2)]
    assert w.is_encdec() and w.q_per_kv == 1 and w.n_ctx_tokens == 16
    full = configs.get(VLM)
    assert sum(n for k, n in full.segments() if k == "cross") == 8
    assert (full.n_layers, full.n_ctx_tokens, full.q_per_kv) == (40, 1600, 4)
    full = configs.get(ENCDEC)
    assert full.encoder_segments() == [("enc", 4)]
    assert (full.n_ctx_tokens, full.d_head, full.q_per_kv) == (1500, 64, 1)
    assert configs.get(VLM).encoder_segments() == []


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", [VLM, VLM + "+xnor"])
def test_cross_attention_and_ctx_kv(arch, dtype):
    """``make_ctx_kv`` (no RoPE, no bias) and ``cross_attention`` against
    the reference's on one cross layer: 3 query tokens over 16 context
    tokens, a batch of 2."""
    jcfg, jp, cfg, tp = _setup(arch, dtype, seed=3)
    jpl = {k[5:]: v[0] for k, v in jp["seg1_cross"].items()
           if k.startswith("attn_")}
    tpl = {k[5:]: v[0] for k, v in tp["seg1_cross"].items()
           if k.startswith("attn_")}
    assert "bq" not in tpl and sorted(tpl) == sorted(jpl)
    rng = np.random.default_rng(5)
    jctx, tctx = _both(rng.standard_normal((2, 16, 64)) * 0.1, dtype)
    jx, tx = _both(rng.standard_normal((2, 3, 64)), dtype)
    jkv = jax.jit(lambda p, c: jattn.make_ctx_kv(jcfg, p, c))(jpl, jctx)
    tkv = attn_mod.make_ctx_kv(cfg, tpl, tctx)
    for g, w in zip(tkv, jkv):
        assert tuple(g.shape) == (2, 16, cfg.n_kv_heads, cfg.d_head)
        _hold(g, w, dtype, "ctx_kv")
    jy = jax.jit(lambda p, x, kv: jattn.cross_attention(jcfg, p, x, kv))(
        jpl, jx, jkv)
    _hold(attn_mod.cross_attention(cfg, tpl, tx, tkv), jy, dtype,
          "cross_attention")
    _hold(attn_mod.decode_cross_attention(cfg, tpl, tx[:, :1], tkv),
          jy[:, :1], dtype, "decode_cross_attention")


def _block_ctx(kind, cfg, rng, dtype):
    """The context a block reads: none for the encoder, raw (B, 16, d)
    patch embeddings for cross, encoded-frame stand-ins for dec."""
    if kind == "enc":
        return None, None
    return _both(rng.standard_normal((2, cfg.n_ctx_tokens, cfg.d_model))
                 * (0.1 if kind == "cross" else 1.0), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,arch,seg", BLOCKS)
def test_block_fwd_and_dense_decode(kind, arch, seg, dtype):
    """Each block's prefill over 9 tokens of a batch of 2 (and the state
    it returns: ctx_kv, the dec block's self-cache beside it), then three
    dense decode steps from that state (the encoder does not decode)."""
    jcfg, jp, cfg, tp = _setup(arch + "+xnor", dtype, seed=1)
    jpl = {k: v[0] for k, v in jp[seg].items()}
    tpl = {k: v[0] for k, v in tp[seg].items()}
    jb, tb = jblocks.KINDS[kind], blocks.registry.get(kind)
    rng = np.random.default_rng(2)
    jctx, tctx = _block_ctx(kind, cfg, rng, dtype)
    jx, tx = _both(rng.standard_normal((2, 9, cfg.d_model)), dtype)
    opts = jblocks.FwdOpts(want_state=True, s_max=16)
    jy, _, js = jax.jit(lambda p, x, c: jb.fwd(jcfg, p, x, c, opts))(
        jpl, jx, jctx)
    ty, ts = tb.fwd(cfg, tpl, tx, blocks.FwdOpts(want_state=True, s_max=16),
                    tctx)
    _hold(ty, jy, dtype, f"{kind} fwd")
    if kind == "enc":
        return
    _hold_trees(ts, js, dtype, f"{kind} prefill state")
    jdec = jax.jit(lambda p, x, s, pos: jb.decode(jcfg, p, x, s, pos, None))
    for step in range(3):
        jx, tx = _both(rng.standard_normal((2, 1, cfg.d_model)), dtype)
        jy, js = jdec(jpl, jx, js, jnp.int32(9 + step))
        ty = tb.decode(cfg, tpl, tx, ts,
                       torch.tensor(9 + step, dtype=torch.int32), None)
        _hold(ty, jy, dtype, f"{kind} decode {step}")
    _hold_trees(ts, js, dtype, f"{kind} state after decode")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,arch,seg", [b for b in BLOCKS
                                            if b[0] != "enc"])
def test_block_chunk_and_paged_decode(kind, arch, seg, dtype):
    """One slot's chunked prefill through the block (two chunks of 8,
    the second ragged) with the per-slot ctx_kv (and the dec block's
    paged self-cache), then two paged decode steps beside a dead slot:
    outputs and states against the reference block."""
    jcfg, jp, cfg, tp = _setup(arch + "+xnor", dtype, seed=4)
    jpl = {k: v[0] for k, v in jp[seg].items()}
    tpl = {k: v[0] for k, v in tp[seg].items()}
    jb, tb = jblocks.KINDS[kind], blocks.registry.get(kind)
    rng = np.random.default_rng(6)
    jctx, tctx = _block_ctx(kind, cfg, rng, dtype)
    jctx, tctx = jctx[:1], tctx[:1]
    w = 3                                   # 24 positions of 8
    jst = jb.paged_state_spec(jcfg, 2, 24, 1 + 2 * w, 8, False)
    tst = tb.paged_state_spec(cfg, 1, 2, 1 + 2 * w, 8, "cpu")
    tst = blocks._layer(tst, 0)
    table = np.arange(1, 1 + 2 * w, dtype=np.int32).reshape(2, w)
    jtab = jnp.asarray(table) if tb.contract.paged_kv else None
    ttab = torch.from_numpy(table) if tb.contract.paged_kv else None
    jchunk = jax.jit(lambda p, x, s, pos0, valid, n, c, t: jb.chunk(
        jcfg, p, x, s, pos0, valid, n, c, t), static_argnums=5)
    _, jps = jb.paged_split(jst)
    jshared, _ = jb.paged_split(jst)
    tshared, tps = tb.paged_split(tst)
    for j, n_valid in enumerate((8, 5)):
        jx, tx = _both(rng.standard_normal((1, 8, cfg.d_model)), dtype)
        valid = np.arange(8) < n_valid
        jslot = jax.tree.map(lambda l: l[:1], jps)
        jy, jnew = jchunk(jpl, jx, jb.paged_merge(jshared, jslot),
                          jnp.int32(8 * j), jnp.asarray(valid[None]),
                          n_valid, jctx, None if jtab is None else jtab[:1])
        jshared, jslot = jb.paged_split(jnew)
        jps = jax.tree.map(lambda full, one: full.at[:1].set(one), jps,
                           jslot)
        tslot = blocks.state_map(lambda l: l[:1], tps)
        ty = tb.chunk(cfg, tpl, tx, tb.paged_merge(tshared, tslot),
                      torch.tensor([8 * j]), torch.from_numpy(valid[None]),
                      n_valid, None if ttab is None else ttab[:1], tctx)
        _hold(ty, jy, dtype, f"{kind} chunk {j}")
    _hold_trees(tps, jps, dtype, f"{kind} ctx_kv")
    dtab = table.copy()
    dtab[1] = 0
    active = np.array([True, False])
    jdec = jax.jit(lambda p, x, s, pos, t, v: jb.decode(
        jcfg, p, x, s, pos, None, table=t, valid=v))
    jst = jb.paged_merge(jshared, jps)
    tst = tb.paged_merge(tshared, tps)
    for step in range(2):
        jx, tx = _both(rng.standard_normal((2, 1, cfg.d_model)), dtype)
        pos = np.array([13 + step, 0], np.int32)
        jy, jst = jdec(jpl, jx, jst, jnp.asarray(pos),
                       None if jtab is None else jnp.asarray(dtab),
                       jnp.asarray(active[:, None]))
        ty = tb.decode(cfg, tpl, tx, tst, torch.from_numpy(pos),
                       None if ttab is None else torch.from_numpy(dtab),
                       valid=torch.from_numpy(active[:, None]))
        _hold(ty[:1], jy[:1], dtype, f"{kind} paged decode {step}")
    if tb.contract.paged_kv:                # the self-cache's live blocks
        _hold(tst[0].k[1:1 + w], jst[0].k[1:1 + w], dtype, "pool k")
        _hold(tst[0].v[1:1 + w], jst[0].v[1:1 + w], dtype, "pool v")


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("kind,arch,seg", [b for b in BLOCKS
                                            if b[0] != "enc"])
def test_block_decode_reads_the_context_one_slot_at_a_time(kind, arch, seg,
                                                          paged,
                                                          monkeypatch):
    """A decode step, dense and paged, reaches the context through
    ``decode_cross_attention`` (each slot alone, so a slot's bits do not
    depend on the batch: hazard H2), as the reference's decode does, and
    never through the batched ``cross_attention``, which prefill and
    chunks use."""
    _, _, cfg, tp = _setup(arch + "+xnor")
    tpl = {k: v[0] for k, v in tp[seg].items()}
    tb = blocks.registry.get(kind)
    calls = []
    for name in ("cross_attention", "decode_cross_attention"):
        def counted(*a, _f=getattr(attn_mod, name), _n=name, **kw):
            calls.append(_n)
            return _f(*a, **kw)
        monkeypatch.setattr(attn_mod, name, counted)
    w, table = 3, None
    if paged:
        st = tb.paged_state_spec(cfg, 1, 2, 1 + 2 * w, 8, "cpu")
        if tb.contract.paged_kv:
            table = torch.arange(1, 1 + 2 * w, dtype=torch.int32
                                 ).reshape(2, w)
    else:
        st = tb.state_spec(cfg, 1, 2, 16, "cpu")
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (2, 1, cfg.d_model)).astype(np.float32))
    y = tb.decode(cfg, tpl, x, blocks._layer(st, 0),
                  torch.tensor([3, 5]), table)
    assert y.shape == x.shape and bool(torch.isfinite(y).all())
    assert calls == ["decode_cross_attention"], calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", [ENCDEC, ENCDEC + "+xnor"])
def test_encode(arch, dtype):
    """``lm.encode`` over (2, 16, d) frames: the encoder segments
    (bidirectional) and ``enc_norm``, the tree's encoder leaves converted
    bit for bit.  bf16 is bitwise where the linears are binarized; with
    full-precision weights a bf16 product differs from XLA's in the last
    bit on a few outputs (accumulation order, ROADMAP queue 3, F1), and the
    second layer's attention spreads one such bit over the rows (seed 2:
    21 % of the outputs, by at most 3 ulps), so those are held within
    2^-5 (|y| + 1), y being RMS-normed."""
    jcfg, jp, cfg, tp = _setup(arch, dtype, seed=2)
    assert sorted(tp) == sorted(jp) == ["embed", "enc0_enc", "enc_norm",
                                        "seg0_dec"]
    assert tp["enc_norm"].dtype == torch.float32
    for k, v in tp["enc0_enc"].items():
        np.testing.assert_array_equal(_np(v), _np(jp["enc0_enc"][k]))
    frames = np.random.default_rng(3).standard_normal((2, 16, 64))
    jf = jnp.asarray(frames.astype(np.float32))
    want = jax.jit(lambda p, f: jlm.encode(jcfg, p, f))(jp, jf)
    got = lm.encode(cfg, tp, torch.from_numpy(frames.astype(np.float32)))
    assert got.dtype == dtype and tuple(got.shape) == (2, 16, 64)
    if cfg.quant == "xnor" or dtype == torch.float32:
        _hold(got, want, dtype, "encode")
    else:
        a, b = _np(got), _np(want)
        assert (np.abs(a - b) <= 2.0 ** -5 * (np.abs(b) + 1)).all()


def _logits_close(got, want, dtype, what):
    if dtype == torch.float32:
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4,
                                   atol=1e-4, err_msg=what)
    else:
        d = np.abs(_np(got) - _np(want)).max()
        assert d <= BF16_LOGIT_BOUND, (what, d)


def _ctx(cfg, b, seed):
    return (np.random.default_rng(seed).standard_normal(
        (b, cfg.n_ctx_tokens, cfg.d_model)) * 0.1).astype(np.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", [VLM + "+xnor", ENCDEC + "+xnor"])
def test_prefill_with_ctx_and_dense_decode(arch, dtype):
    """``lm.prefill`` of a batch of 2 with its contexts (the enc-dec
    arch's frames encoded inside), the dense state (the vision arch keeps
    its context resident, the enc-dec arch does not), then three dense
    decode steps."""
    jcfg, jp, cfg, tp = _setup(arch, dtype, seed=5)
    prompt = np.random.default_rng(1).integers(0, cfg.vocab, (2, 7)) \
        .astype(np.int32)
    ctx = _ctx(cfg, 2, 8)
    jl, js = jax.jit(lambda p, t, c: jlm.prefill(jcfg, p, t, c, s_max=16))(
        jp, jnp.asarray(prompt), jnp.asarray(ctx))
    tl, ts = lm.prefill(cfg, tp, torch.from_numpy(prompt), 16,
                        ctx=torch.from_numpy(ctx))
    _logits_close(tl, jl, dtype, "prefill logits")
    _hold(ts.ctx, js.ctx, dtype, "state ctx")
    spec = lm.decode_state_spec(cfg, 2, 16, device="cpu")
    jspec = jlm.decode_state_spec(jcfg, 2, 16, abstract=True)
    assert (spec.ctx is None) == (jspec.ctx is None) == cfg.is_encdec()
    for g, w in zip(ts.seg_states, js.seg_states):
        _hold_trees(g, w, dtype, "prefill state")
    jstep = jax.jit(lambda p, t, s: jlm.decode_step(jcfg, p, t, s))
    tok = np.argmax(_np(jl)[:, -1, :cfg.vocab], -1).astype(np.int32)[:, None]
    for step in range(3):
        jl, js = jstep(jp, jnp.asarray(tok), js)
        tl, ts = lm.decode_step(cfg, tp, torch.from_numpy(tok), ts)
        _logits_close(tl, jl, dtype, f"decode {step}")
        tok = np.argmax(_np(jl)[:, -1, :cfg.vocab], -1).astype(
            np.int32)[:, None]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", [VLM, ENCDEC, VLM + "+xnor",
                                  ENCDEC + "+xnor"])
def test_chunked_prefill_with_ctx_and_paged_decode(arch, dtype):
    """The serve path's model steps: one slot's prompt in chunks of 8 (the
    last ragged) with its context (the enc-dec arch's frames encoded
    once, as the engine does at admission), then paged decode steps
    beside a dead slot: logits against the reference's, the slot's
    ctx_kv leaves bit for bit in bf16."""
    jcfg, jp, cfg, tp = _setup(arch, dtype, seed=6)
    bs, c, slots = cfg.block_size, cfg.prefill_chunk, 2
    w = lm.paged_table_widths(cfg, 32, bs, c)["full"]
    n_blocks = 1 + slots * w
    jstate = jlm.paged_decode_state_spec(jcfg, slots, 32, n_blocks=n_blocks,
                                         block_size=bs, abstract=False)
    tstate = lm.paged_decode_state_spec(cfg, slots, n_blocks=n_blocks,
                                        block_size=bs, device="cpu")
    assert tstate.ctx is None and jstate.ctx is None
    table = np.arange(1, n_blocks, dtype=np.int32).reshape(slots, w)
    ctx = _ctx(cfg, 1, 9)
    jctx, tctx = jnp.asarray(ctx), torch.from_numpy(ctx)
    if cfg.is_encdec():
        jctx = jax.jit(lambda p, f: jlm.encode(jcfg, p, f))(jp, jctx)
        tctx = lm.encode(cfg, tp, tctx)
    jchunk = jax.jit(lambda p, t, s, n, rows, cx, fresh: jlm.
                     prefill_chunk_step(jcfg, p, t, s, jnp.int32(0), n, rows,
                                        cx, fresh=fresh, start=jnp.int32(0)))
    prompt = np.random.default_rng(2).integers(0, cfg.vocab, 13) \
        .astype(np.int32)
    for j, n_valid in enumerate((c, 13 - c)):
        toks = np.zeros((1, c), np.int32)
        toks[0, :n_valid] = prompt[j * c:j * c + n_valid]
        jl, jstate = jchunk(jp, jnp.asarray(toks), jstate, jnp.int32(n_valid),
                            {"full": jnp.asarray(table[:1])}, jctx,
                            jnp.asarray(j == 0))
        tl, tstate = lm.prefill_chunk_step(
            cfg, tp, torch.from_numpy(toks), tstate, 0, n_valid,
            {"full": torch.from_numpy(table[:1].copy())}, fresh=j == 0,
            ctx=tctx)
        _logits_close(tl, jl, dtype, f"chunk {j}")
    kinds = [blocks.registry.get(k) for k, _ in cfg.segments()]
    for k, g, wnt in zip(kinds, tstate.seg_states, jstate.seg_states):
        if k.contract.per_slot_state:
            _hold_trees(k.paged_split(g)[1], k.paged_split(wnt)[1], dtype,
                        "ctx_kv")
    dtable = table.copy()
    dtable[1] = 0
    active = np.array([True, False])
    jdec = jax.jit(lambda p, t, s, tb, a: jlm.paged_decode_step(
        jcfg, p, t, s, tb, active=a))
    tok = np.array([[int(np.argmax(_np(jl)[0, -1, :cfg.vocab]))], [0]],
                   np.int32)
    for step in range(3):
        jl, jstate = jdec(jp, jnp.asarray(tok), jstate,
                          {"full": jnp.asarray(dtable)}, jnp.asarray(active))
        tl, tstate = lm.paged_decode_step(
            cfg, tp, torch.from_numpy(tok), tstate,
            {"full": torch.from_numpy(dtable)},
            active=torch.from_numpy(active))
        _logits_close(tl[:1], jl[:1], dtype, f"decode {step}")
        tok[0, 0] = int(np.argmax(_np(jl)[0, -1, :cfg.vocab]))
    assert np.array_equal(tstate.pos.numpy(), np.asarray(jstate.pos))


@pytest.mark.parametrize("arch", [VLM, ENCDEC])
def test_ctx_requests(arch):
    """``submit`` takes a request with a context; an arch that needs one
    raises at admission when a request has none, as the reference
    does."""
    cfg = configs.get(arch).smoke(dtype=torch.float32)
    params = lm.init_params(cfg, 0, device="cpu")
    for paged in (True, False):
        eng = ServeEngine(cfg, params, slots=1, s_max=16, paged=paged,
                          device="cpu")
        eng.submit(Request(0, np.arange(4, dtype=np.int32), 2,
                           ctx=_ctx(cfg, 1, 0)[0]))
        eng.submit(Request(1, np.arange(4, dtype=np.int32), 2))
        with pytest.raises(ValueError, match="needs per-request ctx"):
            eng.run()
        assert eng.sessions[0].done and len(eng.sessions[0].tokens) == 2
