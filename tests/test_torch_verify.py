"""Copy verification, encryption, incremental digests and the XNOR-CNN
classifier of the port against the JAX reference, on the CPU.

Trees of f32, bf16, int8 and f64 leaves are made with numpy from a seed;
the reference digests and encrypts the numpy tree (its host byte view,
byte-true for every dtype), the port the same tree carried into tensors by
``repro_torch.convert.from_numpy``.  Digests, keys, ciphertext and cache
accounting are compared exactly; the classifier's logits at 1e-5.
"""

import importlib.util
import pathlib

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import encrypt as jencrypt
from repro.core import engine as jengine
from repro.core import incremental as jincremental
from repro.core import verify as jverify
from repro_torch import convert
from repro_torch.core import bitpack, encrypt, engine, incremental, verify
from repro_torch.models import xnor_classifier

ROOT = pathlib.Path(__file__).resolve().parents[1]
CHUNK = 256


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


def _eng():
    return engine.CimEngine(device="cpu")


def _flat(tree):
    return {verify.leaf_key(p): v
            for p, v in verify.tree_flatten_with_path(tree)}


def _jflat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jverify.leaf_key(p): v for p, v in flat}


def _host(d):
    return bitpack.to_numpy_u32(d) if isinstance(d, torch.Tensor) \
        else np.asarray(d, np.uint32)


def test_tree_digest_and_keys_match_reference():
    tree = _tree()
    ttree = convert.from_numpy(tree)
    got = _flat(verify.tree_digest(ttree, device="cpu"))
    want = _jflat(jverify.tree_digest(tree, impl="ref"))
    assert list(got) == list(want)          # same keys, same order
    assert "blocks/1/w" in got and "stats/1" in got
    for k in want:
        assert np.array_equal(_host(got[k]), np.asarray(want[k])), k
        leaf = _flat(ttree)[k]
        assert np.array_equal(_host(got[k]), jverify.np_digest(
            _jflat(tree)[k])), k
        assert leaf.dtype == convert.from_numpy(
            {"x": np.asarray(_jflat(tree)[k])})["x"].dtype
    # streamed through chunks: the same digests
    streamed = _flat(verify.tree_digest(ttree, engine=_eng(),
                                        chunk_words=128))
    for k in want:
        assert np.array_equal(_host(streamed[k]), np.asarray(want[k])), k


def test_verify_trees_flags_exactly_the_changed_leaf():
    tree = _tree()
    a, b = convert.from_numpy(tree), convert.from_numpy(tree)
    ok, per = verify.verify_trees(a, b, device="cpu")
    jok, jper = jverify.verify_trees(tree, tree, impl="ref")
    assert ok is True and bool(jok)
    b["blocks"][1]["q"][5] += 1
    ok, per = verify.verify_trees(a, b, device="cpu")
    bad = _tree()
    bad["blocks"][1]["q"][5] += 1
    jok, jper = jverify.verify_trees(tree, bad, impl="ref")
    assert ok is False and not bool(jok)
    assert {k: v for k, v in _flat(per).items()} == {
        k: bool(v) for k, v in _jflat(jper).items()}
    assert _flat(per)["blocks/1/q"] is False


def test_np_digest_host_and_device_paths_agree():
    eng = _eng()
    for k, leaf in _flat(_tree()).items():
        host = verify.np_digest(leaf)
        assert np.array_equal(host, jverify.np_digest(leaf)), k
        assert np.array_equal(verify.np_digest_via_device(leaf, eng), host), k


@pytest.mark.parametrize("key", ["embed", "blocks/0/w", "blocks/0/q",
                                 "stats/0"])
def test_encryption_matches_reference_both_ways(key):
    leaf = _flat(_tree())[key]
    ct = encrypt.encrypt_np(leaf, "secret", key)
    assert encrypt.derive_key("secret", key) == jencrypt.derive_key(
        "secret", key)
    assert np.array_equal(ct, jencrypt.encrypt_np(leaf, "secret", key))
    eng = _eng()
    dev = encrypt.encrypt_np_via_device(leaf, "secret", key, eng)
    assert np.array_equal(dev, ct)
    back = encrypt.decrypt_np(dev, "secret", key, leaf.dtype, leaf.shape)
    assert back.tobytes() == leaf.tobytes()
    back = encrypt.decrypt_np_via_device(ct, "secret", key, leaf.dtype,
                                         leaf.shape, eng)
    assert back.tobytes() == leaf.tobytes()
    # the device cipher over a word tensor, against the reference's
    words, _ = verify.np_words(leaf)
    t = bitpack.from_numpy_u32(words)
    got = encrypt.encrypt_device(t, "secret", key, engine=eng)
    want = jencrypt.encrypt_device(jnp.asarray(words), "secret", key,
                                   impl="ref")
    assert np.array_equal(bitpack.to_numpy_u32(got), np.asarray(want))
    assert torch.equal(encrypt.encrypt_device(got, "secret", key,
                                              engine=eng), t)
    assert encrypt.pad_path(3, key) == jencrypt.pad_path(3, key)


def _cache_pair():
    eng = _eng()
    jeng = jengine.CimEngine(impl="ref")
    return (incremental.DigestCache(engine=eng, chunk_words=CHUNK),
            jincremental.DigestCache(engine=jeng, chunk_words=CHUNK))


def _last(c):
    s = c.last
    return (s.leaves, s.clean_leaves, s.new_leaves, s.chunks, s.dirty_chunks)


def test_digest_cache_matches_reference_after_an_update():
    rng = np.random.default_rng(3)
    tree = {"a": rng.integers(0, 2 ** 32, 10 * CHUNK, dtype=np.uint32),
            "b": rng.standard_normal((3 * CHUNK + 5,)).astype(np.float32),
            "c": {"d": rng.integers(0, 2 ** 32, 129, dtype=np.uint32)}}
    jtree = {"a": jnp.asarray(tree["a"]), "b": jnp.asarray(tree["b"]),
             "c": {"d": jnp.asarray(tree["c"]["d"])}}
    ttree = {"a": bitpack.from_numpy_u32(tree["a"]),
             "b": torch.from_numpy(tree["b"].copy()),
             "c": {"d": bitpack.from_numpy_u32(tree["c"]["d"])}}
    cache, jcache = _cache_pair()
    for _ in range(2):                 # prime, then an unchanged pass
        d, jd = cache.digests(ttree), jcache.digests(jtree)
        assert _last(cache) == _last(jcache)
        for k, v in _jflat(jd).items():
            assert np.array_equal(_flat(d)[k], np.asarray(v)), k
    assert cache.last.clean_leaves == 3 and cache.last.dirty_chunks == 0
    # one element of one leaf changes
    jtree["a"] = jtree["a"].at[7 * CHUNK + 3].set(0xDEADBEEF)
    ttree["a"][7 * CHUNK + 3] = bitpack.from_numpy_u32(
        np.array([0xDEADBEEF], np.uint32))[0]
    d, jd = cache.digests(ttree), jcache.digests(jtree)
    assert _last(cache) == _last(jcache)
    assert (cache.last.dirty_chunks, cache.last.clean_leaves) == (1, 2)
    assert cache.last_leaf_dirty == jcache.last_leaf_dirty == {"a": 1}
    for k, v in _jflat(jd).items():
        assert np.array_equal(_flat(d)[k], np.asarray(v)), k
    assert np.array_equal(cache.chunk_digests("a").chunks,
                          jcache.chunk_digests("a").chunks)


def test_digest_cache_catches_an_in_place_edit():
    """Torch tensors are mutable (JAX arrays are not, so the reference has
    no such case): an in-place edit of a tensor the cache has seen, through
    the tensor itself or through a view of it, must reach the word
    compare and move the digest."""
    rng = np.random.default_rng(4)
    w = torch.from_numpy(rng.standard_normal(4 * CHUNK).astype(np.float32))
    tree = {"w": w, "v": torch.zeros(5, dtype=torch.int8)}
    cache = incremental.DigestCache(engine=_eng(), chunk_words=CHUNK)
    d0 = cache.digests(tree)["w"].copy()
    cache.digests(tree)
    assert cache.last.clean_leaves == 2
    w[2 * CHUNK + 1] += 1.0                        # in place, same object
    d1 = cache.digests(tree)["w"]
    assert cache.last.dirty_chunks == 1 and cache.last.clean_leaves == 1
    assert not np.array_equal(d0, d1)
    assert np.array_equal(d1, verify.np_digest(w.numpy()))
    w.view(-1, CHUNK)[3, 0] = 7.0                  # through a view
    d2 = cache.digests(tree)["w"]
    assert cache.last_leaf_dirty == {"w": 1}
    assert np.array_equal(d2, verify.np_digest(w.numpy()))


def test_cache_conflicts_are_refused():
    cache = incremental.DigestCache(engine=_eng(), chunk_words=CHUNK)
    with pytest.raises(ValueError):
        verify.tree_digest({"x": torch.zeros(3)}, engine=_eng(), cache=cache)
    with pytest.raises(ValueError):
        verify.verify_trees({}, {}, cache_a=cache, cache_b=cache)


# ---------------------------------------------------------------------------
# the XNOR-CNN classifier of examples/xnor_cnn_classifier.py
# ---------------------------------------------------------------------------

def _example():
    spec = importlib.util.spec_from_file_location(
        "xnor_cnn_classifier", ROOT / "examples" / "xnor_cnn_classifier.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_xnor_cnn_forward_matches_reference():
    ex = _example()
    params = ex.init(jax.random.PRNGKey(0))
    xtr, ytr = ex.make_data(jax.random.PRNGKey(1), 512)
    xte, _ = ex.make_data(jax.random.PRNGKey(2), 256)

    @jax.jit
    def step(p):
        g = jax.grad(ex.loss_fn)(p, xtr, ytr)
        return jax.tree.map(lambda a, b: a - 0.3 * b, p, g)

    for _ in range(5):
        params = step(params)
    tp = convert.from_numpy(jax.tree.map(np.asarray, params))
    assert (tp["w_in"].shape, tp["w_mid"].shape, tp["w_out"].shape) == (
        (xnor_classifier.D_H, xnor_classifier.D_IN),
        (xnor_classifier.D_H, xnor_classifier.D_H),
        (xnor_classifier.N_CLS, xnor_classifier.D_H))
    x = torch.from_numpy(np.array(xte))
    got = xnor_classifier.forward(tp, x, packed=True)
    want = np.asarray(ex.forward(params, xte, packed=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert np.array_equal(got.argmax(-1).numpy(), want.argmax(-1))
    fl = xnor_classifier.forward(tp, x, packed=False)
    np.testing.assert_allclose(fl.numpy(), got.numpy(), rtol=1e-3, atol=1e-3)


def test_xnor_classifier_data_is_the_stripe_task():
    x, y = xnor_classifier.make_data(np.random.default_rng(0), 64)
    assert x.shape == (64, 256) and x.dtype == np.float32
    img = x.reshape(64, 16, 16)
    # vertical stripes vary along columns, horizontal along rows
    col_var = img.mean(axis=1).var(axis=1)
    row_var = img.mean(axis=2).var(axis=1)
    assert np.array_equal(col_var > row_var, y == 1)
