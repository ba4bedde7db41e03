"""RecurrentGemma (``rglru`` + ``local``) in the port against the JAX
package: the two blocks alone, the model's chunked prefill and decode, and
the per-slot state the serve path keeps (frozen while a slot prefills,
reset for a slot's next tenant, the window ring, the dense layout).

Inputs and weights are made from a seed (numpy / ``jax.random``) and
converted.  f32 is held at the paged tests' 1e-4; bf16 logits within
``BF16_LOGIT_BOUND`` (one bf16 ulp of a smoke logit) against the
reference run jitted, as its engine runs it: XLA drops the bf16 rounding
of the conv's last add where the RG-LRU casts it to f32, and the port
feeds the RG-LRU that unrounded sum (``ssm.conv1d`` returns it); without
it the float arch's bf16 logits drift by 1-2.5 ulps (seeds 0-5) and its
greedy tokens part on 2 of 8 traces (fault F3).  Each block is held
bitwise in bf16.  The engines' tokens are in
``test_torch_hybrid_serve.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import blocks as jblocks
from repro.models import lm as jlm
from repro.models import ssm as jssm
from test_torch_reference import reference_engine as JServeEngine
from repro.serve import synthetic_trace as jsynthetic_trace
import repro_torch.configs as configs
from repro_torch import convert
from repro_torch.models import blocks, lm, ssm
from repro_torch.serve import Request, ServeEngine, synthetic_trace
from repro_torch.train import serve_step

from test_torch_layers import BF16_LOGIT_BOUND

ARCH = "recurrentgemma-2b+xnor"


def _setup(name, dtype=torch.float32, seed=0):
    jcfg = jconfigs.get(name).smoke(dtype=jnp.dtype(str(dtype)[6:]))
    cfg = configs.get(name).smoke(dtype=dtype)
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, jp, cfg, convert.from_jax(cfg, jax.tree.map(np.asarray, jp))


@pytest.fixture(scope="module")
def f32():
    return _setup(ARCH)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _assert_trees_close(got, want, tol=1e-4):
    g, w = blocks.state_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol)


def test_smoke_shapes_are_the_references():
    """3 layers (rglru, rglru, local), one KV head, G 4, window 32."""
    cfg, jcfg = configs.get(ARCH).smoke(), jconfigs.get(ARCH).smoke()
    assert cfg.segments() == jcfg.segments() == [("rglru", 2), ("local", 1)]
    assert (cfg.n_kv_heads, cfg.q_per_kv, cfg.local_window) == (1, 4, 32)
    full = configs.get("recurrentgemma-2b")
    assert [k for k, _ in full.segments()].count("local") == 8
    assert sum(n for k, n in full.segments() if k == "rglru") == 18


@pytest.mark.parametrize("kind,seg", [("rglru", "0_rglru"),
                                      ("local", "1_local")])
def test_block_fwd_and_dense_decode(f32, kind, seg):
    """Each block's prefill over 9 tokens (the state it returns, a local
    ring capped at min(s_max, window)) and three dense decode steps from
    that state, against the reference block on the same layer."""
    jcfg, jp, cfg, tp = f32
    jpl = {k: v[0] for k, v in jp[f"seg{seg}"].items()}
    tpl = {k: v[0] for k, v in tp[f"seg{seg}"].items()}
    jb, tb = jblocks.KINDS[kind], blocks.registry.get(kind)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    opts = jblocks.FwdOpts(want_state=True, s_max=40)
    jx, js = jax.jit(lambda p, x: jb.fwd(jcfg, p, x, None, opts))(
        jpl, jnp.asarray(x))[::2]
    jdecode = jax.jit(lambda p, x, s, pos: jb.decode(jcfg, p, x, s, pos,
                                                     None))
    tx, ts = tb.fwd(cfg, tpl, torch.from_numpy(x),
                    blocks.FwdOpts(want_state=True, s_max=40))
    np.testing.assert_allclose(_np(tx), _np(jx), rtol=1e-4, atol=1e-4)
    _assert_trees_close(ts, js)
    if kind == "local":
        assert ts.k.shape[2] == min(40, cfg.local_window)
    for step in range(3):
        xt = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        pos = jnp.int32(9 + step)
        jx, js = jdecode(jpl, jnp.asarray(xt), js, pos)
        tx = tb.decode(cfg, tpl, torch.from_numpy(xt), ts,
                       torch.tensor(9 + step, dtype=torch.int32), None)
        np.testing.assert_allclose(_np(tx), _np(jx), rtol=1e-4, atol=1e-4)
        _assert_trees_close(ts, js)


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("kind,seg", [("rglru", "seg0_rglru"),
                                      ("local", "seg1_local")])
def test_block_bitwise_bf16(kind, seg, seed):
    """bf16, full-precision weights (every product reaches the output):
    each block's prefill over 9 tokens and three dense decode steps equal
    the jitted reference block's outputs bit for bit."""
    jcfg, jp, cfg, tp = _setup("recurrentgemma-2b", torch.bfloat16, seed)
    jpl = {k: v[0] for k, v in jp[seg].items()}
    tpl = {k: v[0] for k, v in tp[seg].items()}
    jb, tb = jblocks.KINDS[kind], blocks.registry.get(kind)
    opts = jblocks.FwdOpts(want_state=True, s_max=40)
    jfwd = jax.jit(lambda p, x: jb.fwd(jcfg, p, x, None, opts))
    jdec = jax.jit(lambda p, x, s, pos: jb.decode(jcfg, p, x, s, pos, None))
    rng = np.random.default_rng(seed)

    def both(shape):
        j = jnp.asarray(rng.standard_normal(shape).astype(np.float32)
                        ).astype(jnp.bfloat16)
        return j, torch.from_numpy(np.array(j.astype(jnp.float32))).bfloat16()
    jx, tx = both((2, 9, cfg.d_model))
    jy, _, js = jfwd(jpl, jx)
    ty, ts = tb.fwd(cfg, tpl, tx, blocks.FwdOpts(want_state=True, s_max=40))
    np.testing.assert_array_equal(_np(ty), _np(jy))
    for step in range(3):
        jx, tx = both((2, 1, cfg.d_model))
        jy, js = jdec(jpl, jx, js, jnp.int32(9 + step))
        ty = tb.decode(cfg, tpl, tx, ts,
                       torch.tensor(9 + step, dtype=torch.int32), None)
        np.testing.assert_array_equal(_np(ty), _np(jy))


def _chunk_and_decode(name, dtype, packed, seed=1):
    """One slot's prefill in chunks of 8 (the third ragged) over a prompt
    longer than the window (the ring wraps), then decode steps beside a
    dead slot (inactive: its recurrent carry must not move), through both
    packages.  Yields (port, reference) logits per step; checks the dead
    slot's per-slot leaves stay bitwise where they were and, in f32, the
    live slot's state against the reference's."""
    jcfg, jp, cfg, tp = _setup(name, dtype, seed)
    if packed:
        jp, tp = jlm.pack_params(jcfg, jp), lm.pack_params(cfg, tp)
    jchunk = jax.jit(functools.partial(jlm.prefill_chunk_step, jcfg))
    jdecode = jax.jit(functools.partial(jlm.paged_decode_step, jcfg))
    slots, s_max, bs, c = 2, 64, jcfg.block_size, jcfg.prefill_chunk
    widths = jlm.paged_table_widths(jcfg, s_max, bs, c)
    assert widths == lm.paged_table_widths(cfg, s_max, bs, c) == {"win": 5}
    n_blocks = 1 + slots * widths["win"]
    jstate = jlm.paged_decode_state_spec(jcfg, slots, s_max,
                                         n_blocks=n_blocks, block_size=bs,
                                         abstract=False)
    tstate = lm.paged_decode_state_spec(cfg, slots, n_blocks=n_blocks,
                                        block_size=bs, device="cpu")
    rng = np.random.default_rng(0)
    table = (rng.permutation(np.arange(1, n_blocks)).astype(np.int32)
             .reshape(slots, widths["win"]))
    prompt = rng.integers(0, jcfg.vocab, size=(45,)).astype(np.int32)
    # slot 1 holds a live carry first, so freezing it is visible
    for slot in (1, 0):
        n_chunks = -(-len(prompt) // c)
        for j in range(n_chunks):
            n_valid = min(c, len(prompt) - j * c)
            toks = np.zeros((1, c), np.int32)
            toks[0, :n_valid] = prompt[j * c:j * c + n_valid]
            rows = table[slot:slot + 1]
            jl, jstate = jchunk(
                jp, jnp.asarray(toks), jstate, jnp.int32(slot),
                jnp.int32(n_valid), {"win": jnp.asarray(rows)},
                fresh=jnp.asarray(j == 0), start=jnp.int32(0))
            tl, tstate = lm.prefill_chunk_step(
                cfg, tp, torch.from_numpy(toks), tstate, slot, n_valid,
                {"win": torch.from_numpy(rows.copy())}, fresh=j == 0)
            if slot == 0:
                yield tl.float().numpy(), np.asarray(jl.astype(jnp.float32))
    assert np.array_equal(tstate.pos.numpy(), np.asarray(jstate.pos))
    kinds = [blocks.registry.get(k) for k, _ in cfg.segments()]
    dead = [l[:, 1].clone() for k, st in zip(kinds, tstate.seg_states)
            for l in blocks.state_leaves(k.paged_split(st)[1])]
    dtable = table.copy()
    dtable[1] = 0
    token = np.array([[5], [9]], np.int32)
    active = np.array([True, False])
    for _ in range(3):
        jl, jstate = jdecode(jp, jnp.asarray(token), jstate,
                             {"win": jnp.asarray(dtable)},
                             active=jnp.asarray(active))
        tl, tstate = lm.paged_decode_step(
            cfg, tp, torch.from_numpy(token), tstate,
            {"win": torch.from_numpy(dtable)},
            active=torch.from_numpy(active))
        jl = np.asarray(jl.astype(jnp.float32))
        yield tl[0].float().numpy(), jl[0]
        token[0, 0] = int(np.argmax(jl[0, -1, :jcfg.vocab]))
    after = [l[:, 1] for k, st in zip(kinds, tstate.seg_states)
             for l in blocks.state_leaves(k.paged_split(st)[1])]
    assert dead and all(torch.equal(a, b) for a, b in zip(after, dead))
    assert np.array_equal(tstate.pos.numpy(), np.asarray(jstate.pos))
    if dtype == torch.float32:
        h_t = tstate.seg_states[0][0].h.numpy()
        h_j = np.asarray(jstate.seg_states[0][0].h)
        np.testing.assert_allclose(h_t, h_j, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name,packed", [(ARCH, True),
                                         ("recurrentgemma-2b", False)])
def test_chunk_and_decode_logits(name, packed):
    for got, want in _chunk_and_decode(name, torch.float32, packed):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name,packed", [(ARCH, True),
                                         ("recurrentgemma-2b", False)])
def test_chunk_and_decode_logits_bf16(name, packed):
    for got, want in _chunk_and_decode(name, torch.bfloat16, packed):
        np.testing.assert_allclose(got, want, rtol=0, atol=BF16_LOGIT_BOUND)


def test_rglru_state_rides_the_batch_axis(f32):
    """Paged layout: the local kind's state is the shared pool, the rglru
    kind's is per slot (batch on axis 1), and it is the dense layout's."""
    _, _, cfg, _ = f32
    paged = lm.paged_decode_state_spec(cfg, 3, n_blocks=7, block_size=8,
                                       device="cpu")
    dense = lm.decode_state_spec(cfg, 3, 48, device="cpu")
    (h, buf), pool = paged.seg_states
    assert h.h.shape == (2, 3, cfg.d_model) and h.h.dtype == torch.float32
    assert buf.shape == (2, 3, cfg.conv_width - 1, cfg.d_model)
    assert pool.k.shape == (1, 7, 1, 8, cfg.d_head)
    assert dense.seg_states[0][0].h.shape == h.h.shape
    assert dense.seg_states[1].k.shape == (1, 3, 1, cfg.local_window,
                                           cfg.d_head)
    assert not lm.prefix_cache_eligible(cfg)
    assert lm.prefix_table_class(cfg) is None


def test_full_size_ring_width_is_the_references():
    """recurrentgemma-2b at window 2048, chunk 32, block 16: 130 columns
    for any s_max past the window."""
    for s_max in (2176, 4096):
        got = lm.paged_table_widths(configs.get("recurrentgemma-2b"), s_max,
                                    16, 32)
        want = jlm.paged_table_widths(jconfigs.get("recurrentgemma-2b"),
                                      s_max, 16, 32)
        assert got == want == {"win": 130}


def _serve(cfg, params, trace, **kw):
    eng = ServeEngine(cfg, params, device="cpu", **kw)
    for r in trace:
        eng.submit(r)
    rep = eng.run()
    return {rid: rep.tokens(rid).tolist() for rid in rep.sessions}, eng


def test_second_tenant_matches_a_fresh_engine(f32):
    """One slot serves request A, then request B: B's first chunk resets
    the slot's carry and conv buffer (``fresh``), so B's tokens are those
    of an engine that never served A."""
    _, _, cfg, tp = f32
    a, b = synthetic_trace(2, cfg.vocab, seed=9, prompt_lens=(11, 14),
                           new_tokens=(6, 7))
    both, eng = _serve(cfg, tp, [a, b], slots=1, s_max=32)
    alone, _ = _serve(cfg, tp, [b], slots=1, s_max=32)
    assert both[b.rid] == alone[b.rid]
    assert eng.stats.prefills == 2


def test_mid_prefill_carry_does_not_advance(f32):
    """A slot still in chunked prefill rides in the decode batch as an
    inactive row: after a decode step its per-slot leaves are what its
    last chunk left, bit for bit."""
    _, _, cfg, tp = f32
    eng = ServeEngine(cfg, tp, slots=2, s_max=48, device="cpu")
    rng = np.random.default_rng(4)
    short, long_ = (Request(rid, rng.integers(0, cfg.vocab, n).astype(
        np.int32), 8) for rid, n in ((0, 5), (1, 30)))
    eng.submit(short)
    eng.step()                     # the short request is decoding now
    eng.submit(long_)
    eng._admit()
    eng._prefill_step()            # the long one's first chunk
    slot = next(iter(eng._prefilling))
    st = eng._state.seg_states[0]
    before = [l[:, slot].clone() for l in blocks.state_leaves(st)]
    moving = st[0].h[:, 1 - slot].clone()
    eng._decode_once()
    assert slot in eng._prefilling
    after = [l[:, slot] for l in blocks.state_leaves(st)]
    assert all(torch.equal(x, y) for x, y in zip(before, after))
    assert not torch.equal(st[0].h[:, 1 - slot], moving)   # decoding slot


def test_ring_wraps_at_the_window(f32):
    """Window 32, blocks of 8, chunks of 8: the ring has 5 columns (40
    positions), and a request of 45 prompt + 20 new tokens wraps it more
    than once.  Paged, dense (a 32-position rolling cache) and the
    reference engine give the same tokens."""
    jcfg, jp, cfg, tp = f32
    trace = synthetic_trace(2, cfg.vocab, seed=6, prompt_lens=(45, 40),
                            new_tokens=(20, 24))
    paged, eng = _serve(cfg, tp, trace, slots=2, s_max=72)
    assert eng._widths == {"win": 5}
    dense, _ = _serve(cfg, tp, trace, slots=2, s_max=72, paged=False)
    jeng = JServeEngine(jcfg, jp, slots=2, s_max=72, paged=True)
    for r in jsynthetic_trace(2, jcfg.vocab, seed=6, prompt_lens=(45, 40),
                              new_tokens=(20, 24)):
        jeng.submit(r)
    rep = jeng.run()
    want = {rid: rep.tokens(rid).tolist() for rid in rep.sessions}
    assert paged == dense == want


def test_dense_and_static_agree_with_paged(f32):
    """f32, greedy: the slot-dense engine, ``generate_static`` and the
    paged engine give the same tokens, and the reference's dense engine
    gives them too."""
    jcfg, jp, cfg, tp = f32
    kw = dict(prompt_lens=(4, 9, 13), new_tokens=(5, 7))
    trace = synthetic_trace(5, cfg.vocab, seed=2, **kw)
    paged, _ = _serve(cfg, tp, trace, slots=2, s_max=24, pack=True)
    dense, eng = _serve(cfg, tp, trace, slots=2, s_max=24, pack=True,
                        paged=False)
    static = {r.rid: serve_step.generate_static(
        cfg, eng.params, torch.from_numpy(r.prompt[None]), r.max_new_tokens,
        device="cpu")[0].tolist() for r in trace}
    jeng = JServeEngine(jcfg, jp, slots=2, s_max=24, pack=True, paged=False)
    for r in jsynthetic_trace(5, jcfg.vocab, seed=2, **kw):
        jeng.submit(r)
    rep = jeng.run()
    want = {rid: rep.tokens(rid).tolist() for rid in rep.sessions}
    assert paged == dense == static == want


def test_prefill_state_is_the_references(f32):
    """``lm.prefill``'s dense state: the local ring (rolled so slot ==
    position % window) and the RG-LRU carry and conv buffer after 37
    tokens, past the window."""
    jcfg, jp, cfg, tp = f32
    prompt = np.random.default_rng(2).integers(0, cfg.vocab, (2, 37))
    jl, js = jlm.prefill(jcfg, jp, jnp.asarray(prompt, jnp.int32), None,
                         s_max=48)
    tl, ts = lm.prefill(cfg, tp, torch.from_numpy(prompt.astype(np.int32)),
                        s_max=48)
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=1e-4, atol=1e-4)
    for got, want in zip(ts.seg_states, js.seg_states):
        _assert_trees_close(got, want)
    assert ts.seg_states[1].k.shape[3] == cfg.local_window


def test_rglru_state_tree_helpers():
    """``state_map`` / ``state_leaves`` keep NamedTuples and tuples."""
    st = (ssm.RGLRUState(torch.zeros(2, 3)), torch.ones(2, 1, 3))
    m = blocks.state_map(lambda l: l + 1, st)
    assert isinstance(m[0], ssm.RGLRUState) and isinstance(m, tuple)
    assert [tuple(l.shape) for l in blocks.state_leaves(m)] == [(2, 3),
                                                                (2, 1, 3)]
    assert blocks.state_map(lambda l: l, None) is None
    assert jssm.RGLRUState._fields == ssm.RGLRUState._fields


def test_prompt_shorter_than_the_conv_taps(f32):
    """A 2-token prompt: the dense layout's prefill pads the conv buffer
    with the zeros before the sequence, so dense, paged and static agree
    (the reference keeps only the 2 inputs, a buffer too short to seat)."""
    _, _, cfg, tp = f32
    trace = [Request(0, np.array([7, 3], np.int32), 6),
             Request(1, np.array([11], np.int32), 5)]
    paged, _ = _serve(cfg, tp, trace, slots=2, s_max=16)
    dense, eng = _serve(cfg, tp, trace, slots=2, s_max=16, paged=False)
    static = {r.rid: serve_step.generate_static(
        cfg, eng.params, torch.from_numpy(r.prompt[None]), r.max_new_tokens,
        device="cpu")[0].tolist() for r in trace}
    assert paged == dense == static
