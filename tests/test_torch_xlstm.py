"""xLSTM (``mlstm`` + ``slstm``) in the port against the JAX package: the
cells (``mlstm_step`` / ``mlstm_sequential`` / ``mlstm_chunkwise``,
``slstm_step`` / ``slstm_sequence``), the two blocks alone, and the per-slot
state the serve path keeps for them (reset for a slot's next tenant,
frozen while a slot prefills, moved by a migration, dense = paged =
static).

Inputs come from numpy with a seed; weights from ``jax.random`` and
``convert.from_jax``.  The cells are held at f32 tolerances stated per
test (the port sums in its own order, and torch's and XLA's ``exp`` /
``log1p`` / ``tanh`` differ in the last bit).  The sLSTM block is held
bitwise in bf16 against the jitted reference block, the mLSTM block to
one bf16 ulp on at most 5 % of its elements (see ``MLSTM_BF16_SHARE``),
both in f32 at 1e-5.  The
engines' tokens are in ``test_torch_xlstm_{serve,dense}*.py``.
"""

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

ARCH = "xlstm-350m+xnor"
# cell tolerances: h and the state after up to 40 steps of f32 recurrence
CELL_TOL = dict(rtol=2e-5, atol=2e-6)


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


def _close(got, want, **tol):
    g, w = blocks.state_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(_np(a), _np(b), **(tol or CELL_TOL))


def _qkvif(rng, b, s, nh, dh):
    """The reference test's inputs: q, v ~ N(0, 1), k / sqrt(dh), input
    gates N(0, 4), forget gates N(2, 4)."""
    q = rng.standard_normal((b, s, nh, dh)).astype(np.float32)
    k = (rng.standard_normal((b, s, nh, dh)) / np.sqrt(dh)).astype(np.float32)
    v = rng.standard_normal((b, s, nh, dh)).astype(np.float32)
    i = (rng.standard_normal((b, s, nh)) * 2).astype(np.float32)
    f = (rng.standard_normal((b, s, nh)) * 2 + 2).astype(np.float32)
    return q, k, v, i, f


def _mstate(rng, b, nh, dh):
    """A carried state: what 6 steps of random input leave."""
    q, k, v, i, f = _qkvif(rng, b, 6, nh, dh)
    st0 = jssm.MLSTMState.zeros(b, nh, dh)
    _, st = jssm.mlstm_sequential(*map(jnp.asarray, (q, k, v, i, f)), st0)
    return st, ssm.MLSTMState(*(torch.from_numpy(np.array(a, copy=True))
                                for a in st))


def test_smoke_shapes_are_the_references():
    """8 layers (7 mlstm, 1 slstm) at smoke size, chunk 8; the full arch
    has 21 mlstm and 3 slstm layers, di 2048, dh 512, and the sLSTM's GLU
    width 2,688."""
    cfg, jcfg = configs.get(ARCH).smoke(), jconfigs.get(ARCH).smoke()
    assert cfg.segments() == jcfg.segments() == [("mlstm", 7), ("slstm", 1)]
    assert cfg.mlstm_chunk == 8
    full = configs.get("xlstm-350m")
    assert sum(n for k, n in full.segments() if k == "mlstm") == 21
    assert sum(n for k, n in full.segments() if k == "slstm") == 3
    defs = lm.param_defs(full)
    assert defs["seg0_mlstm"]["wq"].shape == (7, 2048, 2048)
    assert defs["seg1_slstm"]["w_up"].shape == (1, 1024, 2688)
    assert defs["seg1_slstm"]["w_down"].shape == (1, 1344, 1024)
    assert defs["seg1_slstm"]["r_kernel"].shape == (1, 4, 4, 256, 256)


@pytest.mark.parametrize("seed", [0, 1])
def test_mlstm_step_and_sequential(seed):
    """Three steps from a carried state, and the sequential oracle over
    11 tokens from the zero state."""
    rng = np.random.default_rng(seed)
    b, nh, dh = 2, 3, 8
    jst, tst = _mstate(rng, b, nh, dh)
    q, k, v, i, f = _qkvif(rng, b, 3, nh, dh)
    for t in range(3):
        args = [a[:, t] for a in (q, k, v, i, f)]
        jh, jst = jssm.mlstm_step(jst, *map(jnp.asarray, args))
        th, tst = ssm.mlstm_step(tst, *map(torch.from_numpy, args))
        np.testing.assert_allclose(_np(th), _np(jh), **CELL_TOL)
        _close(tst, jst)
    q, k, v, i, f = _qkvif(rng, b, 11, nh, dh)
    jh, jst = jssm.mlstm_sequential(*map(jnp.asarray, (q, k, v, i, f)),
                                    jssm.MLSTMState.zeros(b, nh, dh))
    th, tst = ssm.mlstm_sequential(*map(torch.from_numpy, (q, k, v, i, f)),
                                   ssm.MLSTMState.zeros(b, nh, dh, "cpu"))
    np.testing.assert_allclose(_np(th), _np(jh), **CELL_TOL)
    _close(tst, jst)


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("s,chunk", [(32, 8), (32, 7), (19, 8), (5, 8),
                                     (16, 16)])
def test_mlstm_chunkwise_matches_reference(s, chunk, carried):
    """The chunkwise form against the reference's over whole and ragged
    tails (19 and 32 tokens in chunks of 7 or 8: the tail padded with the
    finite gates), from the zero state and from a carried one; and
    against the port's own sequential oracle at the reference test's
    tolerance (2e-4 / 2e-5)."""
    rng = np.random.default_rng(s * 100 + chunk)
    b, nh, dh = 2, 3, 8
    if carried:
        jst0, tst0 = _mstate(rng, b, nh, dh)
    else:
        jst0 = jssm.MLSTMState.zeros(b, nh, dh)
        tst0 = ssm.MLSTMState.zeros(b, nh, dh, "cpu")
    inp = _qkvif(rng, b, s, nh, dh)
    jh, jst = jssm.mlstm_chunkwise(*map(jnp.asarray, inp), jst0, chunk)
    th, tst = ssm.mlstm_chunkwise(*map(torch.from_numpy, inp), tst0, chunk)
    np.testing.assert_allclose(_np(th), _np(jh), **CELL_TOL)
    _close(tst, jst)
    sh, sst = ssm.mlstm_sequential(*map(torch.from_numpy, inp), tst0)
    np.testing.assert_allclose(_np(th), _np(sh), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(_np(tst.c), _np(sst.c), rtol=2e-4, atol=2e-5)


def test_mlstm_chunkwise_continues_a_carried_state():
    """Two calls of 16 tokens, the second from the first's state, give
    the reference's 32-token sequence."""
    rng = np.random.default_rng(3)
    b, nh, dh = 2, 2, 8
    q, k, v, i, f = map(torch.from_numpy, _qkvif(rng, b, 32, nh, dh))
    st0 = ssm.MLSTMState.zeros(b, nh, dh, "cpu")
    h1, st1 = ssm.mlstm_chunkwise(q[:, :16], k[:, :16], v[:, :16],
                                  i[:, :16], f[:, :16], st0, 8)
    h2, _ = ssm.mlstm_chunkwise(q[:, 16:], k[:, 16:], v[:, 16:],
                                i[:, 16:], f[:, 16:], st1, 8)
    jh, _ = jssm.mlstm_sequential(*(jnp.asarray(a.numpy())
                                    for a in (q, k, v, i, f)),
                                  jssm.MLSTMState.zeros(b, nh, dh))
    np.testing.assert_allclose(_np(torch.cat([h1, h2], 1)), _np(jh),
                               rtol=2e-4, atol=2e-5)


def _slstm_inputs(rng, b, s, d, nh):
    xg = rng.standard_normal((b, s, 4 * d)).astype(np.float32)
    rk = (rng.standard_normal((4, nh, d // nh, d // nh)) * 0.1).astype(
        np.float32)
    return xg, rk


@pytest.mark.parametrize("masked", [False, True])
def test_slstm_sequence_matches_reference(masked):
    """64 steps, d 16, 4 heads; with ``valid`` the padding steps (a
    ragged chunk's tail and a gap) pass the state through unchanged."""
    rng = np.random.default_rng(5)
    b, s, d, nh = 2, 64, 16, 4
    xg, rk = _slstm_inputs(rng, b, s, d, nh)
    valid = None
    if masked:
        valid = np.ones((b, s), bool)
        valid[0, 50:] = False
        valid[1, 10:14] = False
    jh, jst = jssm.slstm_sequence(jnp.asarray(xg), jnp.asarray(rk),
                                  jssm.SLSTMState.zeros(b, d), nh,
                                  None if valid is None
                                  else jnp.asarray(valid))
    th, tst = ssm.slstm_sequence(torch.from_numpy(xg), torch.from_numpy(rk),
                                 ssm.SLSTMState.zeros(b, d, "cpu"), nh,
                                 None if valid is None
                                 else torch.from_numpy(valid))
    np.testing.assert_allclose(_np(th), _np(jh), **CELL_TOL)
    _close(tst, jst)
    if masked:
        _, at50 = ssm.slstm_sequence(torch.from_numpy(xg[:1, :50]),
                                     torch.from_numpy(rk),
                                     ssm.SLSTMState.zeros(1, d, "cpu"), nh)
        for a, w in zip(tst, at50):
            assert torch.equal(a[:1], w)
    assert np.abs(_np(th)).max() <= 1.0 + 1e-5


def test_slstm_step_matches_reference():
    rng = np.random.default_rng(6)
    b, d, nh = 3, 16, 4
    xg, rk = _slstm_inputs(rng, b, 4, d, nh)
    jst, tst = jssm.SLSTMState.zeros(b, d), ssm.SLSTMState.zeros(b, d, "cpu")
    for t in range(4):
        jst, jh = jssm.slstm_step(jst, jnp.asarray(xg[:, t]),
                                  jnp.asarray(rk), nh)
        tst, th = ssm.slstm_step(tst, torch.from_numpy(xg[:, t]),
                                 torch.from_numpy(rk), nh)
        np.testing.assert_allclose(_np(th), _np(jh), **CELL_TOL)
        _close(tst, jst)


def _block(jp, tp, kind):
    seg = "seg0_mlstm" if kind == "mlstm" else "seg1_slstm"
    return ({k: v[0] for k, v in jp[seg].items()},
            {k: v[0] for k, v in tp[seg].items()},
            jblocks.KINDS[kind], blocks.registry.get(kind))


def _run_block(name, dtype, seed, kind):
    """A block's prefill over 11 tokens (with its state), three dense
    decode steps from that state, and one ragged chunked-prefill piece
    (8 positions, 5 real) from the state decode left, through both
    packages, the reference jitted.  Yields (what, port, reference)."""
    jcfg, jp, cfg, tp = _setup(name, dtype, seed)
    jpl, tpl, jb, tb = _block(jp, tp, kind)
    opts = jblocks.FwdOpts(want_state=True, s_max=40)
    jfwd = jax.jit(lambda p, x: jb.fwd(jcfg, p, x, None, opts))
    jdec = jax.jit(lambda p, x, s, pos: jb.decode(jcfg, p, x, s, pos, None))
    jchunk = jax.jit(lambda p, x, s, valid, n: jb.chunk(
        jcfg, p, x, s, jnp.int32(0), valid, n, None, None))
    rng = np.random.default_rng(seed)

    def both(shape):
        j = jnp.asarray(rng.standard_normal(shape).astype(np.float32)
                        ).astype(jcfg.dtype)
        return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(dtype)
    jx, tx = both((2, 11, cfg.d_model))
    jy, _, js = jfwd(jpl, jx)
    ty, ts = tb.fwd(cfg, tpl, tx, blocks.FwdOpts(want_state=True, s_max=40))
    yield "fwd", ty, jy
    yield "fwd state", ts, js
    for step in range(3):
        jx, tx = both((2, 1, cfg.d_model))
        jy, js = jdec(jpl, jx, js, jnp.int32(11 + step))
        ty = tb.decode(cfg, tpl, tx, ts,
                       torch.tensor(11 + step, dtype=torch.int32), None)
        yield f"decode {step}", ty, jy
        yield f"decode {step} state", ts, js
    one = lambda l: l[:1]                                   # noqa: E731
    js1 = jax.tree.map(one, js)
    ts1 = blocks.state_map(lambda l: l[:1].clone(), ts)
    jx, tx = both((1, 8, cfg.d_model))
    valid = np.arange(8)[None] < 5
    jy, js1 = jchunk(jpl, jx, js1, jnp.asarray(valid), jnp.int32(5))
    ty = tb.chunk(cfg, tpl, tx, ts1, torch.zeros(1, dtype=torch.int32),
                  torch.from_numpy(valid), 5, None)
    yield "chunk", ty[:, :5], jy[:, :5]
    yield "chunk state", ts1, js1


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_fwd_decode_chunk_f32(f32, kind):
    """Binarized, packed weights as served: f32 outputs and states at
    1e-5 (the cells' f32 order)."""
    for what, got, want in _run_block(ARCH, torch.float32, 0, kind):
        if what.endswith("state"):
            _close(got, want, rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5,
                                       atol=1e-5, err_msg=what)


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("name", [ARCH, "xlstm-350m"])
def test_slstm_block_bitwise_bf16(name, seed):
    """bf16, binarized and full precision: every output of the sLSTM
    block's prefill, decode and a ragged chunk equals the jitted reference
    block's bit for bit (the f32 states within the cells' tolerance).
    Its FFN's ln2 reads the unrounded f32 residual sum, as XLA does."""
    for what, got, want in _run_block(name, torch.bfloat16, seed, "slstm"):
        if what.endswith("state"):
            _close(got, want, rtol=1e-4, atol=1e-4)
        else:
            np.testing.assert_array_equal(_np(got), _np(want), err_msg=what)


# The mLSTM cell's f32 output differs from XLA's in the last bits (fault
# F5).  Its normalizer max(|n q|, exp(-m)) cancels and magnifies them, so
# they decide bf16 roundings of the cell's output.  The CPU path sums its
# products in the orders XLA's CPU dot emitters use at these shapes
# (``ssm._contract``), which took the greedy tokens to 8 of 8 traces in
# every variant; what is left is XLA's f32 ``exp`` and the order of its
# batched row dot (``n q`` at two rows and more), not matched.  Over
# seeds 0-5 that flips at most 25 of 1,408 prefill elements (1.8 %) and 3
# of 128 in a decode step (2.3 %), each by one bf16 ulp of the output.
MLSTM_BF16_SHARE = 0.05


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("name", [ARCH, "xlstm-350m"])
def test_mlstm_block_bf16_within_one_ulp(name, seed):
    """bf16, binarized and full precision: the mLSTM block's prefill,
    decode and ragged-chunk outputs against the jitted reference block's:
    each element equal or one bf16 ulp of its magnitude (at least 1) off,
    on at most ``MLSTM_BF16_SHARE`` of the elements.  The ``w_if`` product
    reads the SiLU's last product unrounded, as XLA computes it where the
    f32 cast follows (``layers.silu(f32=True)``); without that the gates
    differ on every row."""
    for what, got, want in _run_block(name, torch.bfloat16, seed, "mlstm"):
        if what.endswith("state"):      # a flipped input moves it a bf16 ulp
            _close(got, want, rtol=2.0 ** -7, atol=1e-4)
            continue
        g, w = _np(got), _np(want)
        d = np.abs(g - w)
        assert (d <= 2.0 ** -7 * np.maximum(np.abs(w), 1.0)).all(), what
        assert (d > 0).mean() <= MLSTM_BF16_SHARE, (what, (d > 0).sum())


def test_state_is_per_slot_with_no_pool(f32):
    """Neither kind pages anything: the table widths are empty, the paged
    layout is the dense one (batch on axis 1), and prefix caching is off
    (the kinds are not ``prefix_shareable``)."""
    jcfg, _, cfg, tp = f32
    assert lm.paged_table_widths(cfg, 64, 8, 8) == {} == \
        jlm.paged_table_widths(jcfg, 64, 8, 8)
    assert not lm.prefix_cache_eligible(cfg)
    assert not jlm.prefix_cache_eligible(jcfg)
    paged = lm.paged_decode_state_spec(cfg, 3, n_blocks=1, block_size=8,
                                       device="cpu")
    dense = lm.decode_state_spec(cfg, 3, 48, device="cpu")
    (mst, buf), sst = paged.seg_states
    assert mst.c.shape == (7, 3, 4, 32, 32) and mst.c.dtype == torch.float32
    assert torch.all(mst.m == -1e30) and torch.all(sst.m == -1e30)
    assert buf.shape == (7, 3, cfg.conv_width - 1, 128)
    assert sst.h.shape == (1, 3, cfg.d_model)
    for a, b in zip(blocks.state_leaves(paged.seg_states),
                    blocks.state_leaves(dense.seg_states)):
        assert a.shape == b.shape and torch.equal(a, b)
    eng = ServeEngine(cfg, tp, slots=2, s_max=32, device="cpu")
    assert eng.blocks is None and not eng.prefix_caching


def _serve(cfg, params, trace, **kw):
    eng = ServeEngine(cfg, params, device="cpu", **kw)
    for r in trace:
        eng.submit(r)
    rep = eng.run()
    return {rid: rep.tokens(rid).tolist() for rid in rep.sessions}, eng


def test_dense_static_and_paged_agree_with_reference(f32):
    """f32, greedy: the paged engine, the slot-dense one and
    ``generate_static`` give the same tokens, and the reference's dense
    engine gives them too."""
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


def test_prompt_shorter_than_the_conv_taps(f32):
    """A 2-token and a 1-token prompt: the dense layout's prefill pads the
    conv buffer with the zeros before the sequence, so dense, paged and
    static agree (the reference keeps only the inputs there are, a buffer
    too short to seat)."""
    _, _, cfg, tp = f32
    trace = [Request(0, np.array([7, 3], np.int32), 6),
             Request(1, np.array([11], np.int32), 5)]
    paged, _ = _serve(cfg, tp, trace, slots=2, s_max=16)
    dense, eng = _serve(cfg, tp, trace, slots=2, s_max=16, paged=False)
    static = {r.rid: serve_step.generate_static(
        cfg, eng.params, torch.from_numpy(r.prompt[None]), r.max_new_tokens,
        device="cpu")[0].tolist() for r in trace}
    assert paged == dense == static


def test_second_tenant_matches_a_fresh_engine(f32):
    """One slot serves A, then B: B's first chunk resets the memory, the
    sLSTM cell and the conv buffer, so B's tokens are a fresh engine's."""
    _, _, cfg, tp = f32
    a, b = synthetic_trace(2, cfg.vocab, seed=9, prompt_lens=(11, 14),
                           new_tokens=(6, 7))
    both, eng = _serve(cfg, tp, [a, b], slots=1, s_max=32)
    alone, _ = _serve(cfg, tp, [b], slots=1, s_max=32)
    assert both[b.rid] == alone[b.rid]
    assert eng.stats.prefills == 2


def test_mid_prefill_state_does_not_advance(f32):
    """A slot in chunked prefill rides in the decode batch as an inactive
    row: after a decode step every per-slot leaf of both kinds (memory,
    normalizer, stabilizer, conv buffer, sLSTM cell) is what its last
    chunk left, bit for bit, while the decoding slot's moved."""
    _, _, cfg, tp = f32
    eng = ServeEngine(cfg, tp, slots=2, s_max=48, device="cpu")
    rng = np.random.default_rng(4)
    short, long_ = (Request(rid, rng.integers(0, cfg.vocab, n).astype(
        np.int32), 8) for rid, n in ((0, 5), (1, 30)))
    eng.submit(short)
    eng.step()
    eng.submit(long_)
    eng._admit()
    eng._prefill_step()
    slot = next(iter(eng._prefilling))
    leaves = blocks.state_leaves(eng._state.seg_states)
    before = [l[:, slot].clone() for l in leaves]
    moving = [l[:, 1 - slot].clone() for l in leaves]
    eng._decode_once()
    assert slot in eng._prefilling
    assert all(torch.equal(l[:, slot], b) for l, b in zip(leaves, before))
    assert all(not torch.equal(l[:, 1 - slot], m)
               for l, m in zip(leaves, moving))


def test_migration_carries_the_per_slot_state(f32, tmp_path):
    """T = 0.8: a session exported mid-decode from a 2-slot engine (no
    block ids: nothing is paged), seated in a 1-slot engine, finishes
    with the never-migrated tokens; its payload holds every per-slot leaf
    at batch width 1, the f32 memory among them, and the reference
    engine restores it and finishes the same."""
    from repro.checkpoint import ckpt as jckpt
    from repro_torch.checkpoint import ckpt
    jcfg, jp, cfg, tp = f32
    geom = dict(s_max=40, seed=0, temperature=0.8, pack=False)
    trace = synthetic_trace(3, cfg.vocab, seed=3, prompt_lens=(6, 11, 17),
                            new_tokens=(5, 9))
    want, _ = _serve(cfg, tp, trace, slots=2, **geom)
    a = ServeEngine(cfg, tp, slots=2, device="cpu", **geom)
    for r in trace:
        a.submit(r)
    for _ in range(12):
        a.step()
        live = [s for slot, s in a.pool.active.items()
                if s.tokens and not s.done and slot not in a._prefilling]
        if live:
            break
    sess = live[0]
    rid, req = sess.request.rid, sess.request
    wire = a.export_session(rid)
    segs = wire["state"]["segs"]
    assert [blocks.state_leaves(sh) for sh, _ in segs] == [[], []]
    (mst, buf), sst = segs[0][1], segs[1][1]
    assert mst.c.shape == (7, 1, 4, 32, 32) and mst.c.dtype == torch.float32
    assert buf.shape == (7, 1, cfg.conv_width - 1, 128)
    assert [tuple(l.shape) for l in sst] == [(1, 1, cfg.d_model)] * 4
    d = str(tmp_path / "wire")
    ckpt.save(d, 1, wire, root_key="xlstm-mig", device="cpu")
    b = ServeEngine(cfg, tp, slots=1, device="cpu", **geom)
    restored, _ = ckpt.restore(d, 1, b.export_spec(req), root_key="xlstm-mig",
                               device="cpu")
    b.import_session(req, restored)
    a.release_migrated(rid)
    got = {rid: b.run().tokens(rid).tolist()}
    rest = a.run()
    got |= {r.rid: rest.tokens(r.rid).tolist() for r in trace if r.rid != rid}
    assert got == want
    dst = JServeEngine(jcfg, jp, slots=1, **geom)
    jrestored, _ = jckpt.restore(d, 1, dst.export_spec(req),
                                 root_key="xlstm-mig")
    dst.import_session(req, jrestored)
    assert dst.run().tokens(rid).tolist() == want[rid]
