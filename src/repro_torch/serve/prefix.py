"""Content-addressed prefix index over cached KV blocks (DESIGN.md §15).

Split out of the engine so a replica-ready process can hold one index per
engine (replicas never share an index — each replica's pool owns its own
residency) and so the chain-hash logic is unit-testable without a model.
"""

from __future__ import annotations

import hashlib

import numpy as np


class PrefixIndex:
    """Content-addressed index over cached prefix blocks (DESIGN.md §15):
    hash-of-block-contents -> physical block id, for *full* blocks only
    (partial blocks are still being written, so their contents are not
    stable).  Keys are chain hashes — a block's key folds its parent's
    key, so key equality implies the whole prefix up to and including the
    block matched (the same prefix-digest idea as ``CimEngine``'s streamed
    digest path, but blake2b rather than the engine's linear XOR fold: an
    index key must survive adversarial collisions, a parity check need
    not).  Correctness never rests on the hash either way: every entry
    stores its actual tokens and lookup verifies them word-exactly, so a
    collision degrades to a cache miss, never to wrong reuse — the same
    hash-then-word-compare discipline DigestCache uses (§12).

    For ctx archs (vlm / enc-dec) the chain root folds a digest of the
    request's modality context, so equal token prefixes under different
    images / audio never share.  Pure host logic; the engine drives
    registration and eviction, and :class:`repro_torch.serve.pools.BlockPool`
    owns residency."""

    ROOT = b"\x00" * 16

    def __init__(self, block_size: int):
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.block_size = block_size
        # key -> (bid, tokens); parent key -> child keys; bid -> (key, parent)
        self._entries: dict[bytes, tuple[int, np.ndarray]] = {}
        self._children: dict[bytes, list[bytes]] = {}
        self._by_block: dict[int, tuple[bytes, bytes]] = {}
        # bumped on every mutation: lookup results are valid (and may be
        # cached by callers) exactly while this stays unchanged
        self.generation = 0

    def __len__(self) -> int:
        return len(self._by_block)

    @staticmethod
    def root_key(ctx=None) -> bytes:
        if ctx is None:
            return PrefixIndex.ROOT
        a = np.ascontiguousarray(np.asarray(ctx))
        return hashlib.blake2b(repr((a.shape, a.dtype.str)).encode()
                               + a.tobytes(), digest_size=16).digest()

    def chain(self, tokens, ctx=None) -> list[tuple[bytes, bytes, np.ndarray]]:
        """(key, parent_key, block_tokens) per full block of ``tokens``."""
        bs = self.block_size
        toks = np.asarray(tokens, np.int32)
        out, parent = [], self.root_key(ctx)
        for i in range(len(toks) // bs):
            blk = toks[i * bs:(i + 1) * bs]
            key = hashlib.blake2b(parent + blk.tobytes(),
                                  digest_size=16).digest()
            out.append((key, parent, blk))
            parent = key
        return out

    def register(self, key: bytes, parent: bytes, bid: int,
                 tokens: np.ndarray) -> bool:
        """Idempotent, keep-first: when two requests with identical
        prompts prefill concurrently both try to register, and the first
        stays canonical (the second's block simply frees unregistered).
        Returns True when ``bid`` newly entered the index."""
        if key in self._entries or bid in self._by_block:
            return False
        self._entries[key] = (bid, np.array(tokens, np.int32))
        self._children.setdefault(parent, []).append(key)
        self._by_block[bid] = (key, parent)
        self.generation += 1
        return True

    def drop_block(self, bid: int) -> None:
        """Remove the entry backed by ``bid`` (pool eviction).  Entries
        that extended it stay registered: lookup can only reach a child
        through its matched parent — which now misses — so orphaned
        descendants are unreachable until a re-registration of the same
        prefix content restores the chain, and meanwhile they age out of
        the idle LRU like any other cold block."""
        key, parent = self._by_block.pop(bid)
        del self._entries[key]
        sibs = self._children[parent]
        sibs.remove(key)
        if not sibs:
            del self._children[parent]
        self.generation += 1

    def lookup(self, prompt, ctx=None):
        """Longest registered chain of full blocks, plus the best partial
        continuation.

        Returns ``(block_ids, n_full, child)``: the matched full blocks'
        ids, how many, and ``(bid, d)`` for the registered block extending
        the chain with the longest common token prefix (``d`` tokens,
        possibly 0; ties break toward the earliest-registered child) — or
        None when no block extends the chain.  Tokens are compared exactly
        at every step; a hash collision is a miss, never a wrong block."""
        bs = self.block_size
        toks = np.asarray(prompt, np.int32)
        ids: list[int] = []
        parent = self.root_key(ctx)
        for key, _, blk in self.chain(toks, ctx):
            ent = self._entries.get(key)
            if ent is None or not np.array_equal(ent[1], blk):
                break
            ids.append(ent[0])
            parent = key
        n_full = len(ids)
        child = None
        rest = toks[n_full * bs:]
        if len(rest):
            best = -1
            for ck in self._children.get(parent, []):
                bid, ctoks = self._entries[ck]
                m = min(len(rest), len(ctoks))
                neq = ctoks[:m] != rest[:m]
                d = int(np.argmax(neq)) if neq.any() else m
                if d > best:
                    best, child = d, (bid, d)
        return ids, n_full, child
