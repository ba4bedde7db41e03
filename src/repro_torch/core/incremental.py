"""Incremental verification — the paper's backup-scrub workload without the
redundant traffic.

:func:`repro_torch.core.verify.tree_digest` re-digests every leaf on every
scan.  This module re-digests only what changed:

* :class:`ChunkedDigest` — a leaf's (n_chunks, digest_width) digest
  matrix, one row per fixed-size chunk of its word stream, from the
  engine's chunk-level export (one launch of the parity kernel with a
  chunk axis).  Its rows XOR to the leaf's one-shot digest.
* :class:`DigestCache` — keyed by tree path, keeps each leaf's last-seen
  word stream and digest matrix.  Unchanged leaves cost nothing, changed
  leaves one elementwise word compare that finds the dirty chunks, and
  only dirty chunks go back through the engine — ``engine.stats`` shows
  O(dirty chunks) digest cycles, not O(tree).

**Which leaves are trusted unchanged.**  The reference trusts an
immutable ``jax.Array`` it has seen before without reading it.  Torch
tensors are mutable, so here a tensor leaf is trusted only when it is the
same object, at the same data pointer, with the same shape, strides and
dtype, and with the same version counter (``t._version``) as when its
words were last read.  Every in-place PyTorch op on the tensor, or on any
view of its storage, moves that counter, so such an edit always sends the
leaf to the word compare.  Writes that bypass PyTorch's autograd
bookkeeping do not move it: through a numpy view of a CPU tensor, through
DLPack, or through a raw pointer handed to foreign code.  Tensors made
under ``torch.inference_mode()`` have no version counter and are never
trusted: they are word-compared on every pass, like numpy leaves.  The
kept word streams are copies (a tensor's word view is cloned), so the
cache is the reference copy of the pool: one extra copy of the tree.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import bitpack
from repro_torch.core import engine as _engine
from repro_torch.core.verify import (DIGEST_WIDTH, leaf_key,
                                     tree_flatten_with_path, tree_map)


@dataclasses.dataclass
class ChunkedDigest:
    """Per-chunk digest matrix of one leaf's word stream.

    ``chunks[i]`` is the digest of words ``[i*chunk_words,
    (i+1)*chunk_words)``; :meth:`digest` folds the rows into the leaf's
    one-shot digest."""
    chunks: np.ndarray          # (n_chunks, digest_width) uint32, host-side
    chunk_words: int
    nwords: int                 # unpadded length of the word stream
    digest_width: int = DIGEST_WIDTH
    _folded: np.ndarray | None = dataclasses.field(
        default=None, repr=False, compare=False)  # memoized digest() fold

    @property
    def n_chunks(self) -> int:
        return self.chunks.shape[0]

    @classmethod
    def compute(cls, buf, engine: _engine.CimEngine,
                chunk_words: int | None = None,
                digest_width: int = DIGEST_WIDTH) -> "ChunkedDigest":
        """Full compute through the engine's chunk-level digest export."""
        words = engine._words(buf)
        chunk = engine._chunk_words(chunk_words, digest_width)
        rows = bitpack.to_numpy_u32(engine.digest_chunks(words, chunk,
                                                         digest_width))
        return cls(chunks=rows, chunk_words=chunk,
                   nwords=int(words.shape[0]), digest_width=digest_width)

    def digest(self) -> np.ndarray:
        """Whole-leaf digest: XOR fold of the rows (memoized; updates build
        a new ChunkedDigest, so the memo never goes stale)."""
        if self._folded is None:
            self._folded = np.bitwise_xor.reduce(self.chunks, axis=0)
        return self._folded

    def diff(self, other: "ChunkedDigest") -> np.ndarray:
        """Indices of chunk rows that differ from ``other``'s."""
        if (self.chunks.shape != other.chunks.shape
                or self.chunk_words != other.chunk_words):
            raise ValueError(
                f"chunk layouts differ: {self.chunks.shape}x{self.chunk_words}"
                f" vs {other.chunks.shape}x{other.chunk_words}")
        return np.flatnonzero((self.chunks != other.chunks).any(axis=1))


@dataclasses.dataclass
class CacheStats:
    """Work accounting for one :meth:`DigestCache.digests` pass."""
    leaves: int = 0             # leaves examined
    clean_leaves: int = 0       # trusted unchanged: zero dispatch
    new_leaves: int = 0         # first sight / shape change: full dispatch
    chunks: int = 0             # chunks covered by the examined leaves
    dirty_chunks: int = 0       # chunks re-digested through the engine


def _signature(leaf):
    """What must not move for a tensor leaf to be trusted unchanged; None
    when it can never be (numpy leaves, inference tensors)."""
    if not isinstance(leaf, torch.Tensor):
        return None
    try:
        version = leaf._version
    except RuntimeError:        # inference tensors keep no version counter
        return None
    return (version, leaf.data_ptr(), tuple(leaf.shape), leaf.stride(),
            leaf.dtype, leaf.device)


@dataclasses.dataclass
class _Entry:
    leaf: object                # last-seen tensor leaf; None when untrusted
    signature: tuple | None
    words: torch.Tensor         # its word stream (a copy: the baseline)
    cd: ChunkedDigest


class DigestCache:
    """Tree-path-keyed digest cache: O(changed chunks) re-verification.

    ``digests(tree)`` returns the same per-leaf digests as
    :func:`repro_torch.core.verify.tree_digest` (bitwise, as host uint32
    arrays), dispatching the engine only for chunks whose words changed
    since the previous call.  ``last`` holds the :class:`CacheStats` of the
    latest pass."""

    def __init__(self, engine: _engine.CimEngine | None = None,
                 chunk_words: int | None = None,
                 digest_width: int = DIGEST_WIDTH, device="cuda"):
        self.engine = engine if engine is not None \
            else _engine.CimEngine(device=device)
        self.digest_width = digest_width
        self.chunk_words = self.engine._chunk_words(chunk_words, digest_width)
        self._entries: dict[str, _Entry] = {}
        self.last = CacheStats()
        self.last_leaf_dirty: dict[str, int] = {}
        self.last_leaf_new: set[str] = set()
        self.observed_since_save: dict[str, int] = {}

    # -- bookkeeping ---------------------------------------------------------

    def __len__(self) -> int:
        return len(self._entries)

    def chunk_digests(self, key: str) -> ChunkedDigest | None:
        """The cached digest matrix of one tree path (None if unseen)."""
        entry = self._entries.get(key)
        return entry.cd if entry else None

    def drop(self, key: str) -> None:
        self._entries.pop(key, None)
        self.observed_since_save.pop(key, None)

    def clear(self) -> None:
        self._entries.clear()
        self.observed_since_save.clear()

    def mark_saved(self) -> None:
        """Forget the accumulated change evidence (``observed_since_save``)."""
        self.observed_since_save.clear()

    # -- the incremental pass ------------------------------------------------

    def digests(self, tree):
        """Tree -> same-structure tree of (digest_width,) uint32 digests,
        re-digesting only chunks whose words changed.

        ``last_leaf_dirty`` afterwards maps each compared leaf's key to
        the number of chunks found changed in this pass; the counts also
        accumulate into ``observed_since_save`` until :meth:`mark_saved`."""
        stats = CacheStats()
        self.last_leaf_dirty = {}
        self.last_leaf_new = set()
        digs = iter([self._leaf_digest(leaf_key(path), leaf, stats)
                     for path, leaf in tree_flatten_with_path(tree)])
        out = tree_map(lambda _: next(digs), tree)
        self.last = stats
        for k, v in self.last_leaf_dirty.items():
            self.observed_since_save[k] = \
                self.observed_since_save.get(k, 0) + v
        return out

    def _leaf_digest(self, key: str, leaf, stats: CacheStats) -> np.ndarray:
        stats.leaves += 1
        entry = self._entries.get(key)
        sig = _signature(leaf)
        if (entry is not None and sig is not None and leaf is entry.leaf
                and sig == entry.signature):
            stats.clean_leaves += 1
            stats.chunks += entry.cd.n_chunks
            return entry.cd.digest()

        words = self.engine._words(leaf)
        n = int(words.shape[0])
        chunk = self.chunk_words
        n_chunks = max(1, -(-n // chunk))
        stats.chunks += n_chunks

        if entry is None or entry.cd.nwords != n:
            cd = ChunkedDigest.compute(words, self.engine, chunk,
                                       self.digest_width)
            stats.new_leaves += 1
            stats.dirty_chunks += cd.n_chunks
            self.last_leaf_new.add(key)
        else:
            dirty = _dirty_chunks(words, entry.words, chunk)
            rows = entry.cd.chunks.copy()
            # launch every dirty chunk's digest before reading any back
            pending = [(i, self.engine.digest(
                words[i * chunk:(i + 1) * chunk], self.digest_width))
                for i in dirty]
            for i, d in pending:
                rows[i] = bitpack.to_numpy_u32(d)
            stats.dirty_chunks += len(dirty)
            self.last_leaf_dirty[key] = len(dirty)
            cd = ChunkedDigest(rows, chunk, n, self.digest_width)

        if isinstance(leaf, torch.Tensor):
            words = words.clone()       # the baseline must not alias the leaf
        self._entries[key] = _Entry(leaf if sig is not None else None, sig,
                                    words, cd)
        return cd.digest()


def _dirty_chunks(new_words: torch.Tensor, old_words: torch.Tensor,
                  chunk: int) -> np.ndarray:
    """Chunk indices whose words differ: one elementwise compare, no digest
    dispatch."""
    n = new_words.shape[0]
    eq = new_words == old_words.to(new_words.device)
    pad = (-n) % chunk
    if pad:
        eq = torch.nn.functional.pad(eq, (0, pad), value=True)
    mask = torch.logical_not(eq.reshape(-1, chunk).all(dim=1))
    return torch.nonzero(mask).flatten().cpu().numpy()
