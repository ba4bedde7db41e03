"""The checkpoint layer of the port against the JAX reference, on the CPU.

The same numpy tree (f32, bf16, int8, f64 and 0-d leaves in dicts, lists
and a tuple) is saved by ``repro.checkpoint.ckpt`` and, carried into
tensors by ``repro_torch.convert.from_numpy``, by the port.  The manifest
bytes must be equal, and so must the npz member names, their order and
each member's bytes (a zip entry also carries its time of writing, so the
containers themselves differ).  Checkpoints written by either package
restore bitwise in the other: plain, encrypted and a full + delta chain.
The port's engine path (a CPU ``CimEngine``) writes the same bytes as its
host path.  The manifest codec is held against ``msgpack`` itself, which
this test may import and the port may not.
"""

import os
import zipfile

import hypothesis.strategies as st
import jax
import ml_dtypes
import msgpack
import numpy as np
import pytest
import torch
from hypothesis import given, settings

import repro.configs as jconfigs
from repro.checkpoint import ckpt as jckpt
from repro.models import lm as jlm
from repro_torch import convert
from repro_torch.checkpoint import _msgpack, ckpt
from repro_torch.core import engine, incremental, verify
from repro_torch.models import lm

KEY = "hunter2"


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "embed": rng.standard_normal((40, 33)).astype(np.float32),
        "blocks": [
            {"w": rng.standard_normal((17, 9)).astype(ml_dtypes.bfloat16),
             "q": rng.integers(-128, 128, 301).astype(np.int8)},
            {"w": rng.standard_normal((8, 64)).astype(ml_dtypes.bfloat16),
             "q": rng.integers(-128, 128, 64).astype(np.int8)},
        ],
        "stats": (rng.standard_normal(7), np.float64(2.5)),
        "none": None,
    }


def _moved(tree):
    """The tree with one leaf changed."""
    out = dict(tree)
    out["embed"] = tree["embed"] + np.float32(1.0)
    return out


def _like(tree):
    return jax.tree.map(lambda a: jax.ShapeDtypeStruct(np.shape(a),
                                                       np.asarray(a).dtype),
                        tree)


def _bytes(x) -> bytes:
    if isinstance(x, torch.Tensor):
        return x.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(x).tobytes()


def _flat(tree):
    return {verify.leaf_key(p): v
            for p, v in verify.tree_flatten_with_path(tree)}


def _same_tree(got, want):
    fg, fw = _flat(got), _flat(want)
    assert list(fg) == list(fw)
    for k in fw:
        assert tuple(fg[k].shape) == tuple(np.shape(fw[k])), k
        assert _bytes(fg[k]) == _bytes(fw[k]), k


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _members(path):
    with zipfile.ZipFile(path) as zf:
        return [(n, zf.read(n)) for n in zf.namelist()]


def _same_files(dir_a, dir_b, step):
    assert _read(dir_a / f"manifest_{step:08d}.msgpack") == \
        _read(dir_b / f"manifest_{step:08d}.msgpack")
    assert _members(dir_a / f"ckpt_{step:08d}.npz") == \
        _members(dir_b / f"ckpt_{step:08d}.npz")


@pytest.mark.parametrize("root_key", [None, KEY])
@pytest.mark.parametrize("engine_path", [False, True])
def test_full_and_delta_bytes_match_reference(tmp_path, root_key,
                                             engine_path):
    tree, moved = _tree(), _moved(_tree())
    eng = engine.CimEngine(device="cpu") if engine_path else None
    ja, pa = tmp_path / "jax", tmp_path / "port"
    mj = jckpt.save(str(ja), 1, tree, root_key=root_key)
    mp = ckpt.save(str(pa), 1, convert.from_numpy(tree), root_key=root_key,
                   engine=eng, device="cpu")
    assert mp == mj
    _same_files(ja, pa, 1)
    assert "blocks__0__w.npy" in dict(_members(pa / "ckpt_00000001.npz"))
    dj = jckpt.save_delta(str(ja), 2, moved, root_key=root_key)
    dp = ckpt.save_delta(str(pa), 2, convert.from_numpy(moved),
                         root_key=root_key, engine=eng, device="cpu")
    assert dp == dj and dp["base_step"] == 1
    assert [n for n, _ in _members(pa / "ckpt_00000002.npz")] == \
        ["embed.npy"]
    _same_files(ja, pa, 2)


def test_bf16_member_header_is_the_reference_header(tmp_path):
    ckpt.save(str(tmp_path), 1,
              {"w": convert.from_numpy(_tree()["blocks"][0]["w"])},
              device="cpu")
    raw = dict(_members(tmp_path / "ckpt_00000001.npz"))["w.npy"]
    assert b"'descr': '<V2'" in raw[:128]


@pytest.mark.parametrize("root_key", [None, KEY])
def test_cross_restore_is_bitwise_both_ways(tmp_path, root_key):
    tree, moved = _tree(), _moved(_tree())
    ja, pa = tmp_path / "jax", tmp_path / "port"
    jckpt.save(str(ja), 1, tree, root_key=root_key)
    jckpt.save_delta(str(ja), 2, moved, root_key=root_key)
    ckpt.save(str(pa), 1, convert.from_numpy(tree), root_key=root_key,
              device="cpu")
    ckpt.save_delta(str(pa), 2, convert.from_numpy(moved),
                    root_key=root_key, device="cpu")
    like = convert.from_numpy(tree)
    eng = engine.CimEngine(device="cpu")
    for step, want in ((1, tree), (2, moved)):
        for e in (None, eng):
            got, s = ckpt.restore(str(ja), step, like, root_key=root_key,
                                  engine=e, device="cpu")
            assert s == step
            _same_tree(got, want)
        got, _ = jckpt.restore(str(pa), step, _like(tree), root_key=root_key)
        _same_tree(convert.from_numpy(jax.tree.map(np.asarray, got)),
                   convert.from_numpy(want))
    assert ckpt.latest_step(str(ja)) == 2
    got, s = ckpt.restore(str(ja), None, like, root_key=root_key,
                          device="cpu")
    assert s == 2


@pytest.mark.parametrize("root_key", [None, KEY])
@pytest.mark.parametrize("engine_path", [False, True])
def test_flipped_byte_is_found_by_check_and_restore(tmp_path, root_key,
                                                   engine_path):
    """Tamper inside a valid container: the parity check (not the zip
    CRC) must name the leaf."""
    tree = convert.from_numpy(_tree())
    eng = engine.CimEngine(device="cpu") if engine_path else None
    ckpt.save(str(tmp_path), 3, tree, root_key=root_key, engine=eng,
              device="cpu")
    path = str(tmp_path / "ckpt_00000003.npz")
    with np.load(path) as z:
        data = {k: z[k] for k in z.files}
    bad = data["blocks__1__q"].copy()
    bad.view(np.uint8)[17] ^= 0x40
    data["blocks__1__q"] = bad
    with open(path, "wb") as f:
        np.savez(f, **data)
    ok, which = ckpt.check(str(tmp_path), 3, root_key=root_key, engine=eng,
                           device="cpu")
    assert not ok and which == ["blocks/1/q"]
    with pytest.raises(IOError, match="blocks/1/q"):
        ckpt.restore(str(tmp_path), 3, tree, root_key=root_key, engine=eng,
                     device="cpu")
    got, _ = ckpt.restore(str(tmp_path), 3, tree, root_key=root_key,
                          engine=eng, verify_read=False, device="cpu")
    assert _bytes(got["blocks"][1]["q"]) != _bytes(tree["blocks"][1]["q"])


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the default "
                    "device on a machine without CUDA")
def test_entry_points_default_to_the_card(tmp_path):
    """Without ``engine=`` or ``device="cpu"`` the digests and the cipher
    go to the card, so a machine without CUDA refuses, never falling back
    to the host."""
    tree = convert.from_numpy(_tree())
    for call in (lambda: ckpt.save(str(tmp_path), 1, tree),
                 lambda: ckpt.check(str(tmp_path), 1),
                 lambda: ckpt.restore(str(tmp_path), 1, tree)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    import repro_torch.configs as configs
    cfg = configs.get("qwen2-7b+xnor").smoke()
    ckpt.save(str(tmp_path), 1, tree, device="cpu")
    for call in (lambda: ckpt.save_delta(str(tmp_path), 2, tree),
                 lambda: ckpt.check(str(tmp_path), 1),
                 lambda: ckpt.restore_packed(str(tmp_path), 1, cfg)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert not os.path.exists(tmp_path / "ckpt_00000002.npz")


def test_encrypted_checkpoint_needs_the_key(tmp_path):
    tree = convert.from_numpy(_tree())
    ckpt.save(str(tmp_path), 1, tree, root_key=KEY, device="cpu")
    with np.load(tmp_path / "ckpt_00000001.npz") as z:
        assert z["embed"].dtype == np.uint8        # ciphertext on disk
        assert z["embed"].tobytes() != _bytes(tree["embed"])
    with pytest.raises(ValueError, match="root_key"):
        ckpt.restore(str(tmp_path), 1, tree, device="cpu")
    with pytest.raises(IOError, match="corruption"):
        ckpt.restore(str(tmp_path), 1, tree, root_key="wrong", device="cpu")


def test_delta_stores_only_moved_leaves_and_chains(tmp_path):
    t1 = convert.from_numpy(_tree())
    ckpt.save(str(tmp_path), 1, t1, device="cpu")
    m2 = ckpt.save_delta(str(tmp_path), 2, t1, device="cpu")   # nothing moved
    assert _members(tmp_path / "ckpt_00000002.npz") == []
    assert {v["stored_in"] for v in m2["leaves"].values()} == {1}
    t3 = dict(t1, embed=t1["embed"] * 2)
    m3 = ckpt.save_delta(str(tmp_path), 3, t3, device="cpu")
    assert [n for n, _ in _members(tmp_path / "ckpt_00000003.npz")] == \
        ["embed.npy"]
    assert m3["leaves"]["embed"]["stored_in"] == 3
    assert m3["leaves"]["blocks/0/w"]["stored_in"] == 1
    assert ckpt.check(str(tmp_path), 3, device="cpu") == (True, [])
    got, _ = ckpt.restore(str(tmp_path), 3, t1, device="cpu")
    _same_tree(got, t3)
    # a dtype change with identical bytes is stored again
    t4 = dict(t3, blocks=[dict(t3["blocks"][0],
                               q=t3["blocks"][0]["q"].view(torch.uint8)),
                          t3["blocks"][1]])
    m4 = ckpt.save_delta(str(tmp_path), 4, t4, device="cpu")
    assert m4["leaves"]["blocks/0/q"] == dict(
        m3["leaves"]["blocks/0/q"], dtype="uint8", stored_in=4)


def test_cache_backed_delta_stores_a_parity_colliding_change(tmp_path):
    """Swapping two 512-byte blocks leaves the column parity unchanged:
    only the DigestCache's word compare sees it, and the delta stores it."""
    w = torch.arange(512, dtype=torch.float32)
    w2 = w.clone()
    w2[0:128], w2[128:256] = w[128:256].clone(), w[0:128].clone()
    assert np.array_equal(verify.np_digest(w.numpy()),
                          verify.np_digest(w2.numpy()))
    eng = engine.CimEngine(device="cpu")
    cache = incremental.DigestCache(engine=eng, chunk_words=128,
                                    device="cpu")
    t1 = {"w": w, "b": torch.ones(4)}
    ckpt.save(str(tmp_path), 1, t1, engine=eng, device="cpu")
    cache.digests(t1)
    m = ckpt.save_delta(str(tmp_path), 2, {"w": w2, "b": t1["b"]},
                        engine=eng, cache=cache, device="cpu")
    assert m["leaves"]["w"]["stored_in"] == 2
    assert m["leaves"]["b"]["stored_in"] == 1
    got, _ = ckpt.restore(str(tmp_path), 2, t1, device="cpu")
    assert torch.equal(got["w"], w2)
    m = ckpt.save_delta(str(tmp_path), 3, {"w": w2, "b": t1["b"]},
                        engine=eng, cache=cache, device="cpu")
    assert {v["stored_in"] for v in m["leaves"].values()} == {1, 2}
    other = engine.CimEngine(device="cpu")
    with pytest.raises(ValueError, match="conflict"):
        ckpt.save_delta(str(tmp_path), 4, t1, engine=other, cache=cache,
                        device="cpu")


def test_delta_guards(tmp_path):
    tree = convert.from_numpy(_tree())
    with pytest.raises(FileNotFoundError, match="base"):
        ckpt.save_delta(str(tmp_path), 2, tree, device="cpu")
    ckpt.save(str(tmp_path), 1, tree, device="cpu")
    with pytest.raises(ValueError, match="greater"):
        ckpt.save_delta(str(tmp_path), 1, tree, device="cpu")
    with pytest.raises(ValueError, match="encryption"):
        ckpt.save_delta(str(tmp_path), 2, tree, root_key=KEY, device="cpu")
    ckpt.save_delta(str(tmp_path), 2, dict(tree, embed=tree["embed"] + 1),
                    device="cpu")
    # step 1 holds the only copy of leaves step 2 reads: no overwrite
    with pytest.raises(ValueError, match="orphan"):
        ckpt.save(str(tmp_path), 1, tree, device="cpu")
    with pytest.raises(ValueError, match="orphan"):
        jckpt.save(str(tmp_path), 1, _tree())     # the reference agrees
    # a torn newer manifest is not a chain
    (tmp_path / "manifest_00000009.msgpack").write_bytes(
        _msgpack.packb({"step": 9})[:-1])
    ckpt.save(str(tmp_path), 3, tree, device="cpu")
    assert ckpt.latest_step(str(tmp_path)) == 3
    os.remove(tmp_path / "ckpt_00000001.npz")
    with pytest.raises(FileNotFoundError, match="pruned"):
        ckpt.restore(str(tmp_path), 2, tree, device="cpu")
    with pytest.raises(FileNotFoundError, match="pruned"):
        ckpt.check(str(tmp_path), 2, device="cpu")


def test_failed_write_verify_unpublishes_the_step(tmp_path, monkeypatch):
    tree = convert.from_numpy(_tree())
    ckpt.save(str(tmp_path), 1, tree, device="cpu")
    real = ckpt._write_payload

    def corrupting(path, flat, stage):
        digs = real(path, flat, stage)
        with np.load(path) as z:
            data = {k: z[k] for k in z.files}
        data["embed"] = data["embed"].copy()
        data["embed"].view(np.uint32)[0] ^= 1
        with open(path, "wb") as f:
            np.savez(f, **data)
        return digs

    monkeypatch.setattr(ckpt, "_write_payload", corrupting)
    t2 = dict(tree, embed=tree["embed"] + 1)
    with pytest.raises(IOError, match="unpublished"):
        ckpt.save_delta(str(tmp_path), 2, t2, device="cpu")
    monkeypatch.undo()
    assert ckpt.latest_step(str(tmp_path)) == 1
    assert not os.path.exists(tmp_path / "ckpt_00000002.npz")


@pytest.mark.parametrize("root_key", [None, KEY])
def test_restore_packed_equals_pack_of_restore(tmp_path, root_key):
    import repro_torch.configs as configs
    cfg = configs.get("qwen2-7b+xnor").smoke()
    jcfg = jconfigs.get("qwen2-7b+xnor").smoke()
    params = jax.tree.map(np.asarray,
                          jlm.init_params(jcfg, jax.random.PRNGKey(1)))
    jckpt.save(str(tmp_path), 5, params, root_key=root_key)
    like = lm.abstract_params(cfg)
    assert all(t.device.type == "meta" for _, t in
               verify.tree_flatten_with_path(like))
    plain, _ = ckpt.restore(str(tmp_path), 5, like, root_key=root_key,
                            device="cpu")
    _same_tree(plain, convert.from_jax(cfg, params))
    want = lm.pack_params(cfg, plain)
    eng = engine.CimEngine(device="cpu")
    for e in (None, eng):
        got, step = ckpt.restore_packed(str(tmp_path), None, cfg,
                                        root_key=root_key, engine=e,
                                        device="cpu")
        assert step == 5
        fw, fg = _flat(want), _flat(got)
        assert list(fg) == list(fw) and len(fg) > len(_flat(plain))
        for k in fw:
            assert fg[k].dtype == fw[k].dtype and torch.equal(fg[k], fw[k]), k
    float_cfg = configs.get("qwen2-7b").smoke()
    got, _ = ckpt.restore_packed(str(tmp_path), 5, float_cfg,
                                 root_key=root_key, device="cpu")
    _same_tree(got, plain)


# -- the manifest codec -------------------------------------------------------

INT_EDGES = [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
             2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
             -2 ** 31, -2 ** 31 - 1, -2 ** 63]


def test_codec_edges_match_msgpack():
    cases = INT_EDGES + [None, True, False, "", "x" * 31, "x" * 32,
                         "x" * 255, "x" * 256, "x" * 65535, "x" * 65536,
                         "päd/ß", [], list(range(15)), list(range(16)),
                         list(range(65535)), list(range(65536)),
                         {str(i): i for i in range(15)},
                         {str(i): i for i in range(16)},
                         {str(i): None for i in range(65535)},
                         {str(i): [i] for i in range(65536)},
                         {"step": 1, "base_step": None, "encrypted": False,
                          "leaves": {}}]
    for obj in cases:
        raw = _msgpack.packb(obj)
        assert raw == msgpack.packb(obj), repr(obj)[:60]
        assert _msgpack.unpackb(raw) == msgpack.unpackb(raw) == obj
    assert _msgpack.packb({"step": 1, "base_step": None}) == \
        b"\x82\xa4step\x01\xa9base_step\xc0"


def test_codec_rejects_what_the_manifest_never_holds():
    raw = _msgpack.packb({"leaves": {"a": [1, 2, 3]}})
    for cut in range(len(raw)):
        with pytest.raises(ValueError):
            _msgpack.unpackb(raw[:cut])
    with pytest.raises(ValueError, match="extra"):
        _msgpack.unpackb(raw + b"\x00")
    with pytest.raises(ValueError):
        _msgpack.unpackb(msgpack.packb(1.5))
    with pytest.raises(ValueError, match="key"):
        _msgpack.unpackb(msgpack.packb({1: 2}, strict_types=False))
    with pytest.raises(TypeError):
        _msgpack.packb(1.5)
    with pytest.raises(OverflowError):
        _msgpack.packb(2 ** 64)


_leaf_meta = st.fixed_dictionaries({
    "shape": st.lists(st.integers(0, 2 ** 40), max_size=4),
    "dtype": st.sampled_from(["float32", "bfloat16", "int8", "uint8",
                              "float64", "bool"]),
    "digest": st.text(alphabet="0123456789abcdef", min_size=0,
                      max_size=1024),
    "stored_in": st.integers(0, 2 ** 33)})
_manifest = st.fixed_dictionaries({
    "step": st.integers(0, 2 ** 40),
    "base_step": st.one_of(st.none(), st.integers(-2 ** 63, 2 ** 64 - 1)),
    "encrypted": st.booleans(),
    "leaves": st.dictionaries(st.text(min_size=0, max_size=300), _leaf_meta,
                              max_size=40)})


@settings(max_examples=150, deadline=None)
@given(_manifest)
def test_codec_matches_msgpack_on_drawn_manifests(m):
    raw = _msgpack.packb(m)
    assert raw == msgpack.packb(m)
    assert _msgpack.unpackb(raw) == msgpack.unpackb(raw) == m
