"""Bulk copy verification — the paper's Fig. 1(a) application, at
framework scale.

The paper XORs a copied row against its source in one cycle; a zero result
verifies the copy.  Here:

* :func:`tree_digest` — per-leaf XOR-parity digests of a parameter tree,
  routed through a banked :class:`repro_torch.core.engine.CimEngine` (the
  parity kernel on CUDA tensors);
* :func:`verify_trees` — compare two trees leaf by leaf by digest;
* :func:`np_digest` — the numpy twin used on the host I/O path, bitwise
  equal to the engine's digest of the same bytes.

Any single-bit corruption flips exactly one digest bit (XOR is linear), so
digest equality is a parity check, not a heuristic hash.

Trees are nested dicts, lists and tuples (namedtuples included) with
tensors, numpy arrays or scalars as leaves; ``None`` holds no leaf and a
:class:`~repro_torch.core.xnor_layers.PackedLinear` holds two, ``pb`` and
``beta``.  Leaves are visited, and keyed by :func:`leaf_key`, exactly as
``jax.tree_util.tree_flatten_with_path`` visits and the reference keys the
same tree: dict keys sorted, ``"a/b/0"``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import bitpack
from repro_torch.core import engine as _engine
from repro_torch.core.xnor_layers import PackedLinear
from repro_torch.kernels import ops as _ops

DIGEST_WIDTH = 128  # words = 512 bytes


def _children(node):
    """(keys, children, rebuild) of an inner node, or None for a leaf."""
    if isinstance(node, dict):
        keys = sorted(node)
        return keys, [node[k] for k in keys], lambda vs: dict(zip(keys, vs))
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return ([f".{f}" for f in node._fields], list(node),
                lambda vs: type(node)(*vs))
    if isinstance(node, (list, tuple)):
        return (list(range(len(node))), list(node),
                lambda vs: type(node)(vs))
    if isinstance(node, PackedLinear):
        return [0, 1], [node.pb, node.beta], \
            lambda vs: PackedLinear(vs[0], vs[1], node.k)
    return None


def tree_flatten_with_path(tree) -> list[tuple[tuple, object]]:
    """[(path, leaf)] in the reference's order; a path is a tuple of keys."""
    out = []

    def walk(node, path):
        if node is None:
            return
        kids = _children(node)
        if kids is None:
            out.append((path, node))
            return
        for k, c in zip(kids[0], kids[1]):
            walk(c, path + (k,))
    walk(tree, ())
    return out


def tree_map(fn, tree):
    """Same-structure tree of ``fn(leaf)``; ``None`` stays ``None``."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return fn(tree)
    return kids[2]([tree_map(fn, c) for c in kids[1]])


def leaf_key(path) -> str:
    """Canonical string key ("a/b/0") of a :func:`tree_flatten_with_path`
    path — the key the checkpoint manifest and the
    :class:`repro_torch.core.incremental.DigestCache` address leaves by."""
    return "/".join(str(p) for p in path)


def tree_digest(tree, engine: _engine.CimEngine | None = None,
                chunk_words: int | None = None, cache=None, device="cuda"):
    """Tree -> same-structure tree of (DIGEST_WIDTH,) digests.

    Digests are int32 tensors on each leaf's device (numpy leaves: the
    engine's device), or host uint32 arrays when ``cache`` (a
    :class:`repro_torch.core.incremental.DigestCache`) makes the pass
    incremental.  ``engine`` shares one engine's stats across calls;
    without it a throwaway engine on ``device`` is built.
    ``chunk_words`` streams each leaf through
    :meth:`~repro_torch.core.engine.CimEngine.digest_stream`."""
    if cache is not None:
        if engine is not None and engine is not cache.engine:
            raise ValueError("tree_digest: cache= and engine= conflict — "
                             "the cache digests through cache.engine; pass "
                             "the same engine (or neither)")
        if cache.digest_width != DIGEST_WIDTH:
            raise ValueError(
                f"tree_digest: cache digest_width={cache.digest_width} "
                f"breaks the ({DIGEST_WIDTH},)-digest contract — build the "
                "cache with the default width")
        if chunk_words is not None and cache.engine._chunk_words(
                chunk_words, cache.digest_width) != cache.chunk_words:
            raise ValueError(
                f"tree_digest: chunk_words={chunk_words} conflicts with the "
                f"cache's chunk_words={cache.chunk_words}")
        return cache.digests(tree)
    eng = engine if engine is not None else _engine.CimEngine(device=device)
    if chunk_words is None:
        return tree_map(lambda x: eng.digest(x, DIGEST_WIDTH), tree)
    return tree_map(lambda x: eng.digest_stream(
        x, DIGEST_WIDTH, chunk_words=chunk_words), tree)


def _host_digest(d) -> np.ndarray:
    if isinstance(d, torch.Tensor):
        return bitpack.to_numpy_u32(d)
    return np.asarray(d, np.uint32)


def verify_trees(a, b, engine: _engine.CimEngine | None = None,
                 chunk_words: int | None = None, cache_a=None, cache_b=None,
                 device="cuda"):
    """(all_ok, same-structure tree of per-leaf ok) comparing digests, as
    Python bools.  ``cache_a``/``cache_b`` make a periodic scrub
    incremental; each tree needs its own cache."""
    if cache_a is not None and cache_a is cache_b:
        raise ValueError("verify_trees: cache_a and cache_b must be distinct "
                         "DigestCaches — a shared cache thrashes between the "
                         "two trees and defeats the incremental scan")
    da = tree_digest(a, engine, chunk_words, cache_a, device)
    db = tree_digest(b, engine, chunk_words, cache_b, device)
    fa, fb = tree_flatten_with_path(da), tree_flatten_with_path(db)
    if [p for p, _ in fa] != [p for p, _ in fb]:
        raise ValueError("verify_trees: the two trees differ in structure")
    oks = iter([bool(np.array_equal(_host_digest(x), _host_digest(y)))
                for (_, x), (_, y) in zip(fa, fb)])
    leaf_ok = tree_map(lambda _: next(oks), da)
    return all(ok for _, ok in tree_flatten_with_path(leaf_ok)), leaf_ok


def np_words(arr: np.ndarray, align: int = 4):
    """Any numpy array's bytes as the little-endian uint32 stream every
    host-side digest and cipher shares, zero-padded to ``align`` bytes ->
    ``(words, nbytes)`` (:func:`repro_torch.kernels.ops.host_words`)."""
    return _ops.host_words(arr, align)


def np_digest(arr: np.ndarray, digest_width: int = DIGEST_WIDTH) -> np.ndarray:
    """Host-side digest of any numpy array (byte view -> uint32 stream)."""
    words, _ = np_words(arr, align=4 * digest_width)
    return np.bitwise_xor.reduce(words.reshape(-1, digest_width), axis=0)


def np_verify(a: np.ndarray, b: np.ndarray) -> bool:
    return bool(np.array_equal(np_digest(a), np_digest(b)))


def np_digest_via_device(arr: np.ndarray, engine: _engine.CimEngine,
                         digest_width: int = DIGEST_WIDTH) -> np.ndarray:
    """Device-routed twin of :func:`np_digest` (bitwise equal): the host
    bytes' word stream is folded on ``engine``'s device."""
    return bitpack.to_numpy_u32(engine.digest(engine._words(arr),
                                              digest_width))
