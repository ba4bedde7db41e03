"""The port's circuit model and banked engine against the JAX reference.

``repro_torch.core.logic`` / ``cim`` (float32 currents; Boolean outputs
equal, currents within rtol 1e-6 — the two frameworks sum a column's
currents in different orders) and ``repro_torch.core.engine.CimEngine`` on
CPU tensors against ``repro.core.engine.CimEngine(impl="ref")``: every
engine-path result bitwise, ``simulate`` Booleans equal, and the cycle
accounting (``EngineStats``) equal call for call.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import cim as jcim
from repro.core import engine as jengine
from repro.core import logic as jlogic
from repro_torch.core import bitpack, cim, engine, logic

GEOM = dict(banks=4, rows=16, cols=256)


def _u(t):
    return bitpack.to_numpy_u32(t)


def _words(n, seed):
    return np.random.default_rng(seed).integers(0, 2 ** 32, size=n,
                                                dtype=np.uint32)


def _pair(geom=GEOM):
    return (engine.CimEngine(engine.BankGeometry(**geom), device="cpu"),
            jengine.CimEngine(jengine.BankGeometry(**geom), impl="ref"))


def _same_stats(a, b):
    assert (a.cycles, a.bit_ops, a.calls) == (b.cycles, b.bit_ops, b.calls)
    assert a.by_op == b.by_op
    assert a.ops_per_cycle == b.ops_per_cycle


# ---------------------------------------------------------------------------
# logic and the analog array model
# ---------------------------------------------------------------------------

def test_op_table_and_truth_tables_match():
    assert logic.op_table() == jlogic.op_table()
    for name, spec in logic.op_table().items():
        assert logic.truth_table(spec) == jlogic.truth_table(
            jlogic.op_table()[name]), name
    assert (logic.I_00, logic.I_01, logic.I_11) == (
        jlogic.I_00, jlogic.I_01, jlogic.I_11)


OPS = ["xor", "xnor", "and", "or", "nand", "nor"]


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("banked", [False, True])
def test_cim_compute_and_read_match(op, banked):
    rng = np.random.default_rng([OPS.index(op), int(banked)])
    shape = (3, 8, 40) if banked else (8, 40)
    bits = rng.integers(0, 2, shape)
    st, jst = cim.make_array(torch.from_numpy(bits)), jcim.make_array(
        jnp.asarray(bits))
    assert st.r.dtype == torch.float32
    np.testing.assert_array_equal(st.r.numpy(), np.asarray(jst.r))
    if banked:
        ra = rng.integers(0, 8, (3, 5))
        rb = (ra + 1 + rng.integers(0, 7, (3, 5))) % 8
    else:
        ra, rb = 2, 5
    got = cim.compute(st, ra, rb, op)
    want = np.asarray(jcim.compute(jst, jnp.asarray(ra), jnp.asarray(rb), op))
    assert got.dtype == torch.bool and np.array_equal(got.numpy(), want)
    rows = np.arange(8)
    assert np.array_equal(cim.read(st, rows).numpy(),
                          np.asarray(jcim.read(jst, jnp.asarray(rows))))
    wl = cim._wl_one_hot(8, ra, rb)
    jwl = jcim._wl_one_hot(8, jnp.asarray(ra), jnp.asarray(rb))
    assert np.array_equal(wl.numpy(), np.asarray(jwl))
    r = st.r[..., None, :, :] if banked else st.r
    jr = jst.r[..., None, :, :] if banked else jst.r
    i = cim.sl_currents(st._replace(r=r), wl)
    ji = jcim.sl_currents(jst._replace(r=jr), jwl)
    np.testing.assert_allclose(i.numpy(), np.asarray(ji), rtol=1e-6, atol=0)
    # offsets shift the references as the Monte-Carlo layer does
    off = float(jcim.vt_offset_to_iref_shift(0.025, logic.REF_HI))
    assert off == float(cim.vt_offset_to_iref_shift(0.025, logic.REF_HI))
    got = cim.compute(st, ra, rb, op, offset1=-off, offset2=off)
    want = jcim.compute(jst, jnp.asarray(ra), jnp.asarray(rb), op,
                        offset1=-off, offset2=off)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_cim_write_is_functional_and_matches():
    bits = np.random.default_rng(1).integers(0, 2, (4, 6, 9))
    st, jst = cim.make_array(torch.from_numpy(bits)), jcim.make_array(
        jnp.asarray(bits))
    per_bank = np.array([1, 0, 0, 1])
    st2 = cim.write(st, 2, 3, torch.from_numpy(per_bank))
    jst2 = jcim.write(jst, 2, 3, jnp.asarray(per_bank))
    np.testing.assert_array_equal(st2.r.numpy(), np.asarray(jst2.r))
    np.testing.assert_array_equal(st.r.numpy(), np.asarray(jst.r))
    a, b = cim.node_voltages(torch.tensor(7.87e-6), torch.tensor(4e-6))
    ja, jb = jcim.node_voltages(jnp.float32(7.87e-6), jnp.float32(4e-6))
    np.testing.assert_allclose([a.item(), b.item()], [float(ja), float(jb)],
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# CimEngine, engine path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 129, 3000])
def test_engine_xor_xnor_digest_cipher(n):
    eng, jeng = _pair()
    a, b = _words(n, 1), _words(n, 2)
    ta, tb = bitpack.from_numpy_u32(a), bitpack.from_numpy_u32(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    assert np.array_equal(_u(eng.xor(ta, tb)), np.asarray(jeng.xor(ja, jb)))
    assert np.array_equal(_u(eng.xnor(ta, tb)), np.asarray(jeng.xnor(ja, jb)))
    for width in (64, 128):
        assert np.array_equal(_u(eng.digest(ta, width)),
                              np.asarray(jeng.digest(ja, width)))
    key = (123456789, 987654321)
    assert np.array_equal(
        _u(eng.stream_cipher(ta, key, counter=2 ** 32 - 7)),
        np.asarray(jeng.stream_cipher(ja, jnp.asarray(key, jnp.uint32),
                                      counter=2 ** 32 - 7)))
    # a float leaf digests through its byte view
    f = np.random.default_rng(3).standard_normal(n).astype(np.float32)
    assert np.array_equal(_u(eng.digest(torch.from_numpy(f))),
                          np.asarray(jeng.digest(jnp.asarray(f))))
    _same_stats(eng.stats, jeng.stats)


@pytest.mark.parametrize("chunk", [128, 256, 384, None])
def test_engine_streams_and_chunk_export(chunk):
    geom = dict(banks=2, rows=4, cols=512)   # pass_words = 128
    eng, jeng = _pair(geom)
    n = 128 * 9 + 5
    a, b = _words(n, 4), _words(n, 5)
    ta, tb = bitpack.from_numpy_u32(a), bitpack.from_numpy_u32(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    assert np.array_equal(_u(eng.xor_stream(ta, tb, chunk)),
                          np.asarray(jeng.xor_stream(ja, jb, chunk)))
    assert np.array_equal(_u(eng.xnor_stream(ta, tb, chunk)),
                          np.asarray(jeng.xnor_stream(ja, jb, chunk)))
    one_shot = _u(eng.digest(ta))
    streamed = _u(eng.digest_stream(ta, chunk_words=chunk))
    assert np.array_equal(streamed, one_shot)
    assert np.array_equal(streamed, np.asarray(jeng.digest_stream(
        ja, chunk_words=chunk)))
    jeng.digest(ja)
    rows = _u(eng.digest_chunks(ta, chunk))
    jrows = np.asarray(jeng.digest_chunks(ja, chunk))
    assert np.array_equal(rows, jrows)
    assert np.array_equal(np.bitwise_xor.reduce(rows, axis=0), one_shot)
    _same_stats(eng.stats, jeng.stats)


def test_engine_verify_copy():
    eng, jeng = _pair()
    rng = np.random.default_rng(6)
    src = rng.standard_normal((33, 7)).astype(np.float32)
    dst = src.copy()
    t, td = torch.from_numpy(src), torch.from_numpy(dst)
    assert bool(eng.verify_copy(t, td)) and bool(jeng.verify_copy(
        jnp.asarray(src), jnp.asarray(dst)))
    dst.view(np.uint32)[5, 3] ^= 1 << 30
    td = torch.from_numpy(dst)
    assert not bool(eng.verify_copy(t, td))
    assert not bool(jeng.verify_copy(jnp.asarray(src), jnp.asarray(dst)))
    # 64-bit host buffers compare byte-true, a flip in the high word too
    h = rng.integers(0, 2 ** 62, 10)
    h2 = h.copy()
    h2[4] ^= 1 << 40
    assert bool(eng.verify_copy(h, h.copy())) and not bool(
        eng.verify_copy(h, h2))
    assert bool(jeng.verify_copy(h, h.copy()))
    assert not bool(jeng.verify_copy(h, h2))
    with pytest.raises(ValueError):
        eng.verify_copy(t, td[:-1])
    _same_stats(eng.stats, jeng.stats)


# ---------------------------------------------------------------------------
# CimEngine, circuit path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,op", [(1, "xor"), (7, "xnor"), (31, "xor"),
                                  (16, "and")])
def test_engine_simulate_matches_reference(n, op):
    eng, jeng = _pair(dict(banks=4, rows=16, cols=24))
    rng = np.random.default_rng(n)
    a, b = rng.integers(0, 2, (n, 24)), rng.integers(0, 2, (n, 24))
    got = eng.simulate(a, b, op)
    want = np.asarray(jeng.simulate(jnp.asarray(a), jnp.asarray(b), op))
    assert got.shape == (n, 24) and np.array_equal(got.numpy(), want)
    truth = {"xor": a ^ b, "xnor": 1 - (a ^ b), "and": a & b}[op]
    assert np.array_equal(got.numpy(), truth.astype(bool))
    _same_stats(eng.stats, jeng.stats)
    with pytest.raises(ValueError):
        eng.simulate(np.zeros((40, 24)), np.zeros((40, 24)))


def test_geometry_matches():
    for g in (engine.BankGeometry(), engine.BankGeometry(3, 8, 100, 2)):
        jg = jengine.BankGeometry(*g)
        assert (g.words_per_row, g.bits_per_cycle, g.pass_words) == (
            jg.words_per_row, jg.bits_per_cycle, jg.pass_words)
    eng, jeng = _pair()
    for nbits in (0, 1, 16383, 16384, 10 ** 9):
        assert eng.cycles_for(nbits) == jeng.cycles_for(nbits)
    snap = eng.stats.snapshot()
    eng.stats.account(3, 10, "x")
    assert snap.by_op == {} and eng.stats.by_op == {"x": [3, 10, 1]}


def test_engine_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        engine.CimEngine()
