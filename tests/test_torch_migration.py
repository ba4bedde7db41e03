"""Live session migration in the port, mirroring ``tests/test_migration.py``
for the ported ``attn`` kind and for RecurrentGemma's ``rglru`` + ``local``
(per-slot leaves beside window-ring blocks), plus both cross-package
directions.

The contract: a session exported mid-flight — through an encrypted
checkpoint on disk, restored on another engine against a spec that engine
derives from the request alone — finishes with tokens identical to a run
that never moved.  Sampling runs at temperature 0.8, so identity rests on
the (request, step) seed contract and the threefry twin.  The wire's leaf
names and dtypes are the reference's, so a wire written by either package
restores into the other and finishes with the reference's never-migrated
tokens.  The wire carries KV blocks (f32 or bf16) and int32/int64/f64
host leaves, never packed sign planes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.checkpoint import ckpt as jckpt
from repro.models import lm as jlm
from test_torch_reference import reference_engine as JServeEngine
from repro.serve import synthetic_trace as jsynthetic_trace
import repro_torch.configs as configs
from repro_torch import convert
from repro_torch.checkpoint import ckpt
from repro_torch.core.incremental import DigestCache
from repro_torch.serve import Request, ServeEngine, synthetic_trace

KEY = "mig-test"


def _setup(arch: str, dtype=torch.float32, seed=0):
    jcfg = jconfigs.get(arch).smoke(dtype=jnp.dtype(str(dtype)[6:]))
    cfg = configs.get(arch).smoke(dtype=dtype)
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, jp, cfg, convert.from_jax(cfg, jax.tree.map(np.asarray, jp))


ENGINE = dict(slots=2, s_max=48, seed=0, pack=False, temperature=0.8)


def _mk(cfg, params, **kw):
    return ServeEngine(cfg, params, device="cpu", **(ENGINE | kw))


def _jmk(jcfg, jparams, **kw):
    return JServeEngine(jcfg, jparams, paged=True, **(ENGINE | kw))


def _trace(cfg, n, *, plens=(6, 11, 17), ntoks=(5, 9), seed=3, fn=None):
    return (fn or synthetic_trace)(n, cfg.vocab, seed=seed, prompt_lens=plens,
                                   new_tokens=ntoks)


def _baseline(eng, trace):
    for r in trace:
        eng.submit(r)
    rep = eng.run()
    return {r.rid: list(rep.tokens(r.rid)) for r in trace}


def _ship(src, dst, rid, req, d, *, step=1, cache=None):
    """export -> encrypted (delta) checkpoint -> restore against the
    destination's spec -> import -> release: the router's hop."""
    wire = src.export_session(rid)
    if step == 1:
        ckpt.save(d, step, wire, root_key=KEY, device="cpu")
        if cache is not None:
            cache.digests(wire)
            cache.mark_saved()
    else:
        ckpt.save_delta(d, step, wire, root_key=KEY, cache=cache)
    restored, _ = ckpt.restore(d, step, dst.export_spec(req), root_key=KEY,
                               device="cpu")
    dst.import_session(req, restored)
    src.release_migrated(rid)


def _mid_decode_session(eng, max_steps=12):
    """Step until some admitted session has tokens but is neither finished
    nor prefilling: the mid-decode capture point."""
    for _ in range(max_steps):
        eng.step()
        for slot, sess in eng.pool.active.items():
            if sess.tokens and not sess.done and slot not in eng._prefilling:
                return sess
    raise AssertionError("trace never produced a mid-decode session")


def _finish(trace, engines, where):
    reps = {k: e.run() for k, e in engines.items()}
    return {r.rid: list(reps[where(r.rid)].tokens(r.rid)) for r in trace}


@pytest.fixture(scope="module")
def qwen3():
    return _setup("qwen3-4b")


def test_migration_identity_mid_decode(qwen3, tmp_path):
    jcfg, jp, cfg, tp = qwen3
    trace = _trace(cfg, 4)
    want = _baseline(_mk(cfg, tp), trace)
    assert want == _baseline(_jmk(jcfg, jp),
                             _trace(jcfg, 4, fn=jsynthetic_trace))
    a = _mk(cfg, tp)
    for r in trace:
        a.submit(r)
    sess = _mid_decode_session(a)
    rid = sess.request.rid
    b = _mk(cfg, tp)
    _ship(a, b, rid, sess.request, str(tmp_path / "wire"))
    assert rid not in a.sessions
    assert b.sessions[rid].tokens == sess.tokens
    got = _finish(trace, {"a": a, "b": b}, lambda r: "b" if r == rid else "a")
    assert got == want
    assert (a.stats.migrations_out, b.stats.migrations_in) == (1, 1)


def test_migration_identity_mid_chunked_prefill(qwen3, tmp_path):
    jcfg, jp, cfg, tp = qwen3
    trace = _trace(cfg, 3, plens=(20, 23), ntoks=(6, 8))
    want = _baseline(_mk(cfg, tp), trace)
    a = _mk(cfg, tp)
    for r in trace:
        a.submit(r)
    a.step()
    assert a._prefilling, "prompt did not span multiple prefill chunks"
    slot = next(iter(a._prefilling))
    sess = a.pool.active[slot]
    rid = sess.request.rid
    b = _mk(cfg, tp)
    _ship(a, b, rid, sess.request, str(tmp_path / "wire"))
    assert b._prefilling, "import dropped the chunked-prefill progress"
    assert next(iter(b._prefilling.values())).next_chunk == 1
    got = _finish(trace, {"a": a, "b": b}, lambda r: "b" if r == rid else "a")
    assert got == want


def test_migration_identity_packed_residency(tmp_path):
    """+xnor with pack=True: the migrated KV was written by the packed
    linears; identity holds on packed residency too."""
    _, _, cfg, tp = _setup("qwen2-7b+xnor")
    trace = _trace(cfg, 4)
    want = _baseline(_mk(cfg, tp, pack=True), trace)
    a = _mk(cfg, tp, pack=True)
    for r in trace:
        a.submit(r)
    sess = _mid_decode_session(a)
    rid = sess.request.rid
    b = _mk(cfg, tp, pack=True)
    _ship(a, b, rid, sess.request, str(tmp_path / "wire"))
    got = _finish(trace, {"a": a, "b": b}, lambda r: "b" if r == rid else "a")
    assert got == want


def test_double_migration_delta_chain(qwen3, tmp_path):
    """A -> B -> A: hop 2 is a ``save_delta`` against the DigestCache hop
    1 primed; it stores strictly less, and the session finishes
    identically."""
    _, _, cfg, tp = qwen3
    trace = _trace(cfg, 3, plens=(6, 10), ntoks=(14, 18))
    want = _baseline(_mk(cfg, tp), trace)
    a = _mk(cfg, tp)
    for r in trace:
        a.submit(r)
    sess = _mid_decode_session(a)
    rid = sess.request.rid
    b = _mk(cfg, tp)
    d = str(tmp_path / "wire")
    cache = DigestCache(device="cpu")
    _ship(a, b, rid, sess.request, d, step=1, cache=cache)
    for _ in range(2):
        b.step()
    assert not b.sessions[rid].done, "budget too small to bounce back"
    _ship(b, a, rid, sess.request, d, step=2, cache=cache)
    npz = {p.name: p.stat().st_size for p in (tmp_path / "wire").iterdir()
           if p.suffix == ".npz"}
    assert npz["ckpt_00000002.npz"] < npz["ckpt_00000001.npz"], npz
    got = _finish(trace, {"a": a, "b": b}, lambda r: "a")
    assert got == want


def test_migration_wire_is_encrypted(qwen3, tmp_path):
    """Restoring with a wrong key fails; the prompt is nowhere on disk in
    the clear.  The wire's leaves carry the reference's names and dtypes."""
    _, _, cfg, tp = qwen3
    a = _mk(cfg, tp)
    for r in _trace(cfg, 2):
        a.submit(r)
    sess = _mid_decode_session(a)
    wire = a.export_session(sess.request.rid)
    assert (wire["meta"].dtype, wire["meta"].shape) == (np.int64, (8,))
    assert (wire["times"].dtype, wire["times"].shape) == (np.float64, (5,))
    assert wire["tokens"].dtype == wire["prompt"].dtype == np.int32
    assert wire["state"]["pos"].dtype == torch.int32
    d = str(tmp_path / "wire")
    man = ckpt.save(d, 1, wire, root_key="right-key", device="cpu")
    assert sorted(man["leaves"]) == [
        "meta", "prompt", "state/pos", "state/segs/0/0/.k",
        "state/segs/0/0/.v", "times", "tokens"]
    b = _mk(cfg, tp)
    with pytest.raises(Exception):
        ckpt.restore(d, 1, b.export_spec(sess.request), root_key="wrong-key",
                     device="cpu")
    blob = b"".join(p.read_bytes() for p in (tmp_path / "wire").iterdir())
    assert sess.request.prompt.astype(np.int32).tobytes() not in blob


def test_release_migrated_returns_capacity(qwen3, tmp_path):
    _, _, cfg, tp = qwen3
    a = _mk(cfg, tp, slots=2)
    for r in _trace(cfg, 2):
        a.submit(r)
    sess = _mid_decode_session(a)
    rid = sess.request.rid
    in_use_before = a.blocks.in_use
    b = _mk(cfg, tp)
    _ship(a, b, rid, sess.request, str(tmp_path / "wire"))
    assert a.blocks.in_use < in_use_before
    assert a.pool.free_slots, "migration did not free the source slot"
    late = Request(rid=99, prompt=np.arange(5) % cfg.vocab, max_new_tokens=4)
    a.submit(late)
    rep_a, rep_b = a.run(), b.run()
    assert rep_a.sessions[99].done and rep_b.sessions[rid].done


def test_cross_slot_migration_identity(qwen3, tmp_path):
    """Export from a 4-slot engine, import into a 2-slot one (slots and
    n_blocks may differ): the never-migrated tokens."""
    _, _, cfg, tp = qwen3
    trace = _trace(cfg, 5)
    want = _baseline(_mk(cfg, tp, slots=4), trace)
    a = _mk(cfg, tp, slots=4)
    for r in trace:
        a.submit(r)
    sess = _mid_decode_session(a)
    rid = sess.request.rid
    b = _mk(cfg, tp, slots=2)
    _ship(a, b, rid, sess.request, str(tmp_path / "wire"))
    got = _finish(trace, {"a": a, "b": b}, lambda r: "b" if r == rid else "a")
    assert got == want


@pytest.fixture(scope="module")
def xnor_bf16():
    return _setup("qwen2-7b+xnor", torch.bfloat16, seed=2)


def test_reference_wire_restores_into_the_port(xnor_bf16, tmp_path):
    """bf16, packed: the reference exports a mid-decode session and saves
    it encrypted; the port restores it against its own spec, imports it
    and finishes it with the reference's never-migrated tokens."""
    jcfg, jp, cfg, tp = xnor_bf16
    jtrace = _trace(jcfg, 4, fn=jsynthetic_trace)
    want = _baseline(_jmk(jcfg, jp, pack=True), jtrace)
    src = _jmk(jcfg, jp, pack=True)
    for r in jtrace:
        src.submit(r)
    for _ in range(12):
        src.step()
        live = [s for slot, s in src.pool.active.items()
                if s.tokens and not s.done and slot not in src._prefilling]
        if live:
            break
    jsess = live[0]
    rid = jsess.request.rid
    d = str(tmp_path / "wire")
    jckpt.save(d, 1, src.export_session(rid), root_key=KEY)
    req = Request(rid, jsess.request.prompt, jsess.request.max_new_tokens)
    dst = _mk(cfg, tp, pack=True)
    restored, _ = ckpt.restore(d, 1, dst.export_spec(req), root_key=KEY,
                               device="cpu")
    dst.import_session(req, restored)
    assert dst.sessions[rid].tokens == jsess.tokens
    assert dst.run().tokens(rid).tolist() == want[rid]


def test_port_wire_restores_into_the_reference(xnor_bf16, tmp_path):
    """The other way: the port exports and saves, the reference restores
    it against its own spec, imports it and finishes it with its own
    never-migrated tokens."""
    jcfg, jp, cfg, tp = xnor_bf16
    trace = _trace(cfg, 4)
    want = _baseline(_jmk(jcfg, jp, pack=True),
                     _trace(jcfg, 4, fn=jsynthetic_trace))
    src = _mk(cfg, tp, pack=True)
    for r in trace:
        src.submit(r)
    sess = _mid_decode_session(src)
    rid = sess.request.rid
    d = str(tmp_path / "wire")
    ckpt.save(d, 1, src.export_session(rid), root_key=KEY, device="cpu")
    dst = _jmk(jcfg, jp, pack=True)
    restored, _ = jckpt.restore(d, 1, dst.export_spec(sess.request),
                                root_key=KEY)
    dst.import_session(sess.request, restored)
    assert dst.sessions[rid].tokens == sess.tokens
    assert dst.run().tokens(rid).tolist() == want[rid]


# ---------------------------------------------------------------------------
# RecurrentGemma: per-slot state (the RG-LRU's f32 h, the conv buffer)
# travels beside the local layers' window-ring blocks
# ---------------------------------------------------------------------------

RG = "recurrentgemma-2b+xnor"


@pytest.fixture(scope="module")
def rgemma():
    return _setup(RG)


def test_recurrent_wire_carries_per_slot_leaves(rgemma, tmp_path):
    """The wire's state holds, per rglru segment, the slot's f32 ``h`` and
    its conv buffer at batch width 1, and per local segment the ring
    blocks through the ``win`` row; the reference's leaf names."""
    _, _, cfg, tp = rgemma
    a = _mk(cfg, tp)
    for r in _trace(cfg, 2):
        a.submit(r)
    sess = _mid_decode_session(a)
    wire = a.export_session(sess.request.rid)
    (h, buf), pool = wire["state"]["segs"][0][1], wire["state"]["segs"][1][0]
    assert wire["state"]["segs"][0][0] is None
    assert wire["state"]["segs"][1][1] is None
    assert h.h.shape == (2, 1, cfg.d_model) and h.h.dtype == torch.float32
    assert buf.shape == (2, 1, cfg.conv_width - 1, cfg.d_model)
    assert pool.k.shape[1] == a._widths["win"]
    man = ckpt.save(str(tmp_path / "wire"), 1, wire, root_key=KEY,
                    device="cpu")
    assert sorted(k for k in man["leaves"] if k.startswith("state/segs")) \
        == ["state/segs/0/1/0/.h", "state/segs/0/1/1", "state/segs/1/0/.k",
            "state/segs/1/0/.v"]


def test_recurrent_migration_identity_mid_decode(rgemma, tmp_path):
    jcfg, jp, cfg, tp = rgemma
    trace = _trace(cfg, 4)
    want = _baseline(_mk(cfg, tp), trace)
    assert want == _baseline(_jmk(jcfg, jp),
                             _trace(jcfg, 4, fn=jsynthetic_trace))
    a = _mk(cfg, tp)
    for r in trace:
        a.submit(r)
    sess = _mid_decode_session(a)
    rid = sess.request.rid
    b = _mk(cfg, tp)
    _ship(a, b, rid, sess.request, str(tmp_path / "wire"))
    got = _finish(trace, {"a": a, "b": b}, lambda r: "b" if r == rid else "a")
    assert got == want


def test_recurrent_migration_identity_mid_chunked_prefill(rgemma, tmp_path):
    """Shipped after its first chunk: the carry and conv buffer the chunk
    left go along, and the next chunk continues from them (not fresh)."""
    _, _, cfg, tp = rgemma
    trace = _trace(cfg, 3, plens=(20, 23), ntoks=(6, 8))
    want = _baseline(_mk(cfg, tp), trace)
    a = _mk(cfg, tp)
    for r in trace:
        a.submit(r)
    a.step()
    slot = next(iter(a._prefilling))
    sess = a.pool.active[slot]
    rid = sess.request.rid
    b = _mk(cfg, tp)
    _ship(a, b, rid, sess.request, str(tmp_path / "wire"))
    assert next(iter(b._prefilling.values())).next_chunk == 1
    got = _finish(trace, {"a": a, "b": b}, lambda r: "b" if r == rid else "a")
    assert got == want


def test_recurrent_cross_slot_migration_identity(rgemma, tmp_path):
    """A 4-slot source, a 2-slot destination: the slot's leaves land in
    another slot index of a narrower batch, token for token."""
    _, _, cfg, tp = rgemma
    trace = _trace(cfg, 5)
    want = _baseline(_mk(cfg, tp, slots=4), trace)
    a = _mk(cfg, tp, slots=4)
    for r in trace:
        a.submit(r)
    sess = _mid_decode_session(a)
    rid = sess.request.rid
    b = _mk(cfg, tp, slots=2)
    _ship(a, b, rid, sess.request, str(tmp_path / "wire"))
    got = _finish(trace, {"a": a, "b": b}, lambda r: "b" if r == rid else "a")
    assert got == want


@pytest.fixture(scope="module")
def rgemma_bf16():
    return _setup(RG, torch.bfloat16, seed=2)


def test_recurrent_reference_wire_restores_into_the_port(rgemma_bf16,
                                                        tmp_path):
    """bf16, packed: a mid-decode recurrentgemma session exported by the
    reference restores into the port and finishes with the reference's
    never-migrated tokens."""
    jcfg, jp, cfg, tp = rgemma_bf16
    jtrace = _trace(jcfg, 4, fn=jsynthetic_trace)
    want = _baseline(_jmk(jcfg, jp, pack=True), jtrace)
    src = _jmk(jcfg, jp, pack=True)
    for r in jtrace:
        src.submit(r)
    for _ in range(12):
        src.step()
        live = [s for slot, s in src.pool.active.items()
                if s.tokens and not s.done and slot not in src._prefilling]
        if live:
            break
    jsess = live[0]
    rid = jsess.request.rid
    d = str(tmp_path / "wire")
    jckpt.save(d, 1, src.export_session(rid), root_key=KEY)
    req = Request(rid, jsess.request.prompt, jsess.request.max_new_tokens)
    dst = _mk(cfg, tp, pack=True)
    restored, _ = ckpt.restore(d, 1, dst.export_spec(req), root_key=KEY,
                               device="cpu")
    dst.import_session(req, restored)
    assert dst.sessions[rid].tokens == jsess.tokens
    assert dst.run().tokens(rid).tolist() == want[rid]


def test_recurrent_port_wire_restores_into_the_reference(rgemma_bf16,
                                                        tmp_path):
    jcfg, jp, cfg, tp = rgemma_bf16
    trace = _trace(cfg, 4)
    want = _baseline(_jmk(jcfg, jp, pack=True),
                     _trace(jcfg, 4, fn=jsynthetic_trace))
    src = _mk(cfg, tp, pack=True)
    for r in trace:
        src.submit(r)
    sess = _mid_decode_session(src)
    rid = sess.request.rid
    d = str(tmp_path / "wire")
    ckpt.save(d, 1, src.export_session(rid), root_key=KEY, device="cpu")
    dst = _jmk(jcfg, jp, pack=True)
    restored, _ = jckpt.restore(d, 1, dst.export_spec(sess.request),
                                root_key=KEY)
    dst.import_session(sess.request, restored)
    assert dst.sessions[rid].tokens == sess.tokens
    assert dst.run().tokens(rid).tolist() == want[rid]
