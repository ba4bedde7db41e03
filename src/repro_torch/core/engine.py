"""Banked batched CiM engine: the scheduler over the single-cycle primitive.

The paper's array computes one row-pair XOR/XNOR per sense cycle; a
deployment tiles many independent arrays (banks) behind one controller, so
every cycle every bank senses one row pair across its full width and the
throughput is ``banks * cols`` bit-ops a cycle.

:class:`CimEngine` is that controller.  It has two coupled views of the
same machine:

* the **engine path** — int32 word buffers (uint32 bits) dispatched
  through :mod:`repro_torch.kernels.ops` (the ``bulk_xor``,
  ``parity_digest`` and ``xor_cipher`` kernels on CUDA tensors, their
  plain versions on CPU tensors), with cycle accounting under the bank
  model;
* the **circuit path** (:meth:`CimEngine.simulate`) — the same schedule
  mapped onto a banked :class:`repro_torch.core.cim.ArrayState` and
  computed through the analog sense-line model, the cross-check the
  engine path is held to.

PyTorch runs eagerly, so every call is accounted once, after its dispatch
(a failed dispatch leaves the counters alone).  Tensors stay on their own
device; numpy operands are moved to the engine's ``device``.
:class:`ShardedCimEngine` spreads the bank stack over the ranks of a
mesh axis.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import bitpack, cim
from repro_torch.distributed import sharding
from repro_torch.kernels import ops

MASK = 0xFFFFFFFF


class BankGeometry(NamedTuple):
    """``banks`` arrays of rows x cols cells; ``devices`` is the outer tier
    (1 for the single-device engine)."""
    banks: int = 8
    rows: int = 512       # paper §V: 512 rows at nominal HRS/LRS
    cols: int = 4096      # bits per row (= 128 words)
    devices: int = 1

    @property
    def words_per_row(self) -> int:
        return bitpack.packed_width(self.cols)

    @property
    def bits_per_cycle(self) -> int:
        """One row-wide op per bank per device per cycle."""
        return self.devices * self.banks * self.cols

    @property
    def pass_words(self) -> int:
        """Words one full pass over every row of every bank senses."""
        return self.devices * self.banks * self.rows * self.words_per_row


@dataclasses.dataclass
class EngineStats:
    """Cycle/op counters accumulated across engine calls; ``by_op`` breaks
    the totals down per op kind as ``[cycles, bit_ops, calls]``."""
    cycles: int = 0
    bit_ops: int = 0
    calls: int = 0
    by_op: dict = dataclasses.field(default_factory=dict)

    def account(self, cycles: int, bit_ops: int, op: str = "bulk") -> None:
        self.cycles += cycles
        self.bit_ops += bit_ops
        self.calls += 1
        per = self.by_op.setdefault(op, [0, 0, 0])
        per[0] += cycles
        per[1] += bit_ops
        per[2] += 1

    def snapshot(self) -> "EngineStats":
        """Frozen copy of the counters (deep-copies ``by_op``)."""
        return dataclasses.replace(
            self, by_op={k: list(v) for k, v in self.by_op.items()})

    @property
    def ops_per_cycle(self) -> float:
        return self.bit_ops / self.cycles if self.cycles else 0.0


def _nbits(buf) -> int:
    if isinstance(buf, torch.Tensor):
        return buf.numel() * buf.element_size() * 8
    buf = np.asarray(buf)
    return buf.size * buf.dtype.itemsize * 8


class CimEngine:
    """Schedules arbitrarily large word buffers onto the bank stack.

    ``device`` (``"cuda"`` unless the caller asks for ``"cpu"``) is where
    numpy operands go; tensors run where they lie."""

    def __init__(self, geometry: BankGeometry = BankGeometry(),
                 device="cuda"):
        self.geometry = geometry
        self.device = resolve_device(device)
        self.stats = EngineStats()

    # -- schedule model ------------------------------------------------------

    def cycles_for(self, nbits: int) -> int:
        """Sense cycles to stream ``nbits`` bit-ops through the bank stack."""
        return -(-nbits // self.geometry.bits_per_cycle)

    def _account(self, *buffers, op: str = "bulk") -> None:
        nbits = max(_nbits(b) for b in buffers)
        self.stats.account(self.cycles_for(nbits), nbits, op)

    def _tensor(self, buf):
        """A tensor stays where it is; anything else becomes one on the
        engine's device."""
        if isinstance(buf, torch.Tensor):
            return buf
        return torch.as_tensor(np.asarray(buf), device=self.device)

    # -- engine path: word buffers -------------------------------------------

    def xor(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Bulk XOR of two same-shape int32 word buffers (one pass)."""
        out = ops.bulk_op(a, b, "xor")
        self._account(a, op="xor")
        return out

    def xnor(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Bulk XNOR — the complementary rail, same cycle count."""
        out = ops.bulk_op(a, b, "xnor")
        self._account(a, op="xnor")
        return out

    def digest(self, buf, digest_width: int = 128) -> torch.Tensor:
        """XOR-parity digest of any buffer's word stream through the bank
        stack: one op per bit, as :meth:`xor`."""
        out = ops.digest(self._words(buf), digest_width)
        self._account(buf, op="digest")
        return out

    def _words(self, buf) -> torch.Tensor:
        """The word stream of a tensor (its own device) or of a numpy
        array (the host byte view, moved to the engine's device)."""
        if isinstance(buf, torch.Tensor):
            return ops.as_words(buf)
        return ops.as_words(np.asarray(buf)).to(self.device)

    def words(self, buf) -> torch.Tensor:
        """The word stream of a tensor or a numpy array on the engine's
        device (a tensor already there is viewed, not copied)."""
        return self._words(buf).to(self.device)

    def verify_copy(self, a, b) -> torch.Tensor:
        """Paper Fig. 1(a): XOR source against copy; all-zero means intact.

        Any same-shape, same-dtype pair: both are viewed as their word
        streams (numpy arrays by their host bytes, so 64-bit buffers
        compare byte-true) before the bulk XOR.  Returns a 0-d bool tensor
        on the operands' device."""
        if not isinstance(a, torch.Tensor):
            a = np.asarray(a)
        if not isinstance(b, torch.Tensor):
            b = np.asarray(b)
        if tuple(a.shape) != tuple(b.shape) or a.dtype != b.dtype:
            raise ValueError(
                "verify_copy compares a buffer against its copy: operands "
                f"must share shape/dtype, got {tuple(a.shape)}/{a.dtype} vs "
                f"{tuple(b.shape)}/{b.dtype}")
        return torch.logical_not(self.xor(self._words(a),
                                          self._words(b)).any())

    def stream_cipher(self, buf: torch.Tensor, key,
                      counter: int = 0) -> torch.Tensor:
        """Paper Fig. 1(b): counter-mode XOR pad over the bank stack."""
        out = ops.stream_cipher(buf, key, counter=counter)
        self._account(buf, op="cipher")
        return out

    # -- chunked streaming: buffers larger than one bank pass -----------------

    def _chunk_words(self, chunk_words: int | None, align: int) -> int:
        """The streaming chunk: one bank pass by default, ``align``ed up."""
        chunk = chunk_words if chunk_words else self.geometry.pass_words
        return -(-chunk // align) * align

    def xor_stream(self, a, b, chunk_words: int | None = None):
        """:meth:`xor` over fixed-size chunks of the word stream;
        bit-identical to one-shot :meth:`xor` for any chunk."""
        return self._bulk_stream(a, b, "xor", chunk_words)

    def xnor_stream(self, a, b, chunk_words: int | None = None):
        """Chunked :meth:`xnor`."""
        return self._bulk_stream(a, b, "xnor", chunk_words)

    def _bulk_stream(self, a, b, op, chunk_words):
        if a.shape != b.shape:
            raise ValueError(f"operand shapes differ: {tuple(a.shape)} vs "
                             f"{tuple(b.shape)}")
        bulk = self.xor if op == "xor" else self.xnor
        chunk = self._chunk_words(chunk_words, 128)
        wa, wb = a.reshape(-1), b.reshape(-1)
        n = wa.shape[0]
        if n <= chunk:
            return bulk(a, b)
        outs = [bulk(wa[i:i + chunk], wb[i:i + chunk])
                for i in range(0, n, chunk)]
        return torch.cat(outs).reshape(a.shape)

    def digest_stream(self, buf, digest_width: int = 128,
                      chunk_words: int | None = None) -> torch.Tensor:
        """Chunked :meth:`digest`, bit-identical to the one-shot digest
        (chunks cover whole digest rows, so the chunk digests XOR to it)."""
        words = self._words(buf)
        chunk = self._chunk_words(chunk_words, digest_width)
        n = words.shape[0]
        if n <= chunk:
            whole = isinstance(buf, torch.Tensor) and buf.dtype == torch.int32
            return self.digest(buf if whole else words, digest_width)
        dig = self.digest(words[:chunk], digest_width)
        for i in range(chunk, n, chunk):
            dig = dig ^ self.digest(words[i:i + chunk], digest_width)
        return dig

    def digest_chunks(self, buf, chunk_words: int | None = None,
                      digest_width: int = 128) -> torch.Tensor:
        """One digest row per ``chunk_words`` slab of the word stream ->
        (n_chunks, digest_width) int32; row ``i`` equals :meth:`digest` of
        words ``[i*chunk, (i+1)*chunk)``.  Chunks are aligned to whole
        digest rows, so the rows XOR to the one-shot digest.  The whole
        matrix is one launch of the parity kernel with a chunk axis."""
        words = self._words(buf)
        chunk = self._chunk_words(chunk_words, digest_width)
        out = ops.digest_chunks(words, chunk, digest_width)
        self._account(words, op="digest")
        return out

    # -- circuit path: the analog model, banked ------------------------------

    def simulate(self, bits_a, bits_b, op: str = "xor") -> torch.Tensor:
        """Run N row pairs through the analog banked array model.

        ``bits_a``/``bits_b``: (N, C) 0/1 rows, C <= geometry.cols.  Pair
        ``j`` goes to bank ``j // P`` (P = ceil(N / banks)) as rows
        (2p, 2p+1); one banked :func:`cim.compute` senses banks x P pairs
        (P sense cycles on the hardware).  Returns (N, C) bool."""
        bits_a, bits_b = self._tensor(bits_a), self._tensor(bits_b)
        n, c = bits_a.shape
        if tuple(bits_b.shape) != (n, c):
            raise ValueError(f"operand shapes differ: {tuple(bits_a.shape)} "
                             f"vs {tuple(bits_b.shape)}")
        if c > self.geometry.cols:
            raise ValueError(f"{c} cols exceed bank width "
                             f"{self.geometry.cols}")
        banks = self.geometry.banks
        pairs = -(-n // banks)
        if 2 * pairs > self.geometry.rows:
            raise ValueError(f"{n} pairs need {2 * pairs} rows/bank, "
                             f"bank has {self.geometry.rows}")
        pad = banks * pairs - n
        bits_a = torch.nn.functional.pad(bits_a, (0, 0, 0, pad))
        bits_b = torch.nn.functional.pad(bits_b, (0, 0, 0, pad))
        # (banks, pairs, 2, C) -> interleave operand rows -> (banks, 2P, C)
        stacked = torch.stack([bits_a, bits_b], dim=1)      # (B*P, 2, C)
        cells = stacked.reshape(banks, 2 * pairs, c)
        state = cim.make_array(cells)
        row_a = 2 * torch.arange(pairs, device=cells.device)
        out = cim.compute(state, row_a, row_a + 1, op)      # (banks, P, C)
        self.stats.account(pairs, n * c, "simulate")
        return out.reshape(banks * pairs, c)[:n]


class ShardedCimEngine(CimEngine):
    """The bank stack spread over the ranks of one mesh axis: the axis is
    the outermost bank dimension (``devices`` in the geometry), so the
    throughput is ``devices * banks * cols`` bit-ops a cycle and
    :meth:`cycles_for` is ``devices`` times fewer.

    A buffer's flat word stream is cut into ``devices`` contiguous chunks
    of ``per`` words, ``per`` aligned to 128 words (the kernel tile) and,
    for digests, to ``lcm(128, digest_width)``: rank ``d`` takes words
    ``[d * per, (d + 1) * per)`` (:meth:`local_range`), as the reference's
    ``ShardedCimEngine`` lays them out.  XOR, XNOR and the cipher run on
    the chunk alone (the cipher from keystream index ``counter + d * per``
    mod 2^32); a digest XOR-folds the ranks' partial digests
    (:func:`sharding.pxor`).  The digests are the only data that cross
    ranks.  Every result is bit-identical to the single-device
    :class:`CimEngine`'s.

    Two forms of each call: the global form takes the whole buffer on
    every rank; the ``*_local`` form takes only this rank's chunk and the
    global word count.  XOR, XNOR and the cipher return this rank's chunk
    of the output's word stream in both forms; digests are whole on every
    rank.  ``mesh`` is a ``DeviceMesh`` (``launch.mesh.make_engine_mesh``);
    ``axis`` defaults to its first axis."""

    def __init__(self, mesh, axis: str | None = None,
                 geometry: BankGeometry = BankGeometry(), device="cuda"):
        axis = axis if axis is not None else mesh.mesh_dim_names[0]
        if axis not in mesh.mesh_dim_names:
            raise ValueError(f"axis {axis!r} not in mesh axes "
                             f"{mesh.mesh_dim_names}")
        super().__init__(geometry._replace(
            devices=sharding.axis_size(mesh, axis)), device)
        self.mesh, self.axis = mesh, axis
        self.rank = mesh.get_local_rank(axis)
        self.group = sharding.axis_group(mesh, axis)

    def local_range(self, n_words: int, align: int = 128) -> tuple[int, int]:
        """[start, stop) of this rank's chunk of an ``n_words`` stream."""
        dev = self.geometry.devices
        per = -(-max(n_words, 1) // (dev * align)) * align
        start = min(self.rank * per, n_words)
        return start, min(start + per, n_words)

    def _chunk(self, words, n_words: int, align: int) -> torch.Tensor:
        start, stop = self.local_range(n_words, align)
        if words.numel() != stop - start:
            raise ValueError(f"rank {self.rank} holds words [{start}, "
                             f"{stop}) of {n_words}, got {words.numel()}")
        return words.reshape(-1)

    def _mine(self, words: torch.Tensor, align: int = 128) -> torch.Tensor:
        start, stop = self.local_range(words.numel(), align)
        return words.reshape(-1)[start:stop]

    def _bulk(self, a, b, n_words: int, op: str) -> torch.Tensor:
        if a.dtype != torch.int32 or b.dtype != torch.int32:
            raise TypeError(f"bulk {op} needs int32, got {a.dtype}/{b.dtype}")
        a, b = self._chunk(a, n_words, 128), self._chunk(b, n_words, 128)
        return ops.bulk_op(a, b, op) if a.numel() else a.clone()

    def _digest(self, words, n_words: int, digest_width: int):
        words = self._chunk(words, n_words, math.lcm(128, digest_width))
        part = ops.digest(words, digest_width) if words.numel() else \
            torch.zeros(digest_width, dtype=torch.int32, device=words.device)
        return sharding.pxor(part, self.group)

    def _cipher(self, words, key, n_words: int, counter: int):
        if words.dtype != torch.int32:
            raise TypeError(f"stream_cipher needs int32, got {words.dtype}")
        start, _ = self.local_range(n_words)
        words = self._chunk(words, n_words, 128)
        if not words.numel():
            return words.clone()
        return ops.stream_cipher(words, key, (counter + start) & MASK)

    def _account_words(self, n_words: int, op: str) -> None:
        nbits = 32 * n_words
        self.stats.account(self.cycles_for(nbits), nbits, op)

    # -- local form: this rank's chunk and the global word count ---------

    def xor_local(self, a, b, n_words: int) -> torch.Tensor:
        out = self._bulk(a, b, n_words, "xor")
        self._account_words(n_words, "xor")
        return out

    def xnor_local(self, a, b, n_words: int) -> torch.Tensor:
        out = self._bulk(a, b, n_words, "xnor")
        self._account_words(n_words, "xnor")
        return out

    def digest_local(self, words, n_words: int,
                     digest_width: int = 128) -> torch.Tensor:
        """The digest of the whole ``n_words`` stream from this rank's
        chunk (aligned to ``lcm(128, digest_width)``)."""
        out = self._digest(words, n_words, digest_width)
        self._account_words(n_words, "digest")
        return out

    def stream_cipher_local(self, words, key, n_words: int,
                            counter: int = 0) -> torch.Tensor:
        out = self._cipher(words, key, n_words, counter)
        self._account_words(n_words, "cipher")
        return out

    # -- global form: the whole buffer on every rank ---------------------

    def _bulk_global(self, a, b, op: str) -> torch.Tensor:
        if a.shape != b.shape:
            raise ValueError(f"operand shapes differ: {tuple(a.shape)} vs "
                             f"{tuple(b.shape)}")
        out = self._bulk(self._mine(a), self._mine(b), a.numel(), op)
        self._account(a, op=op)
        return out

    def xor(self, a, b) -> torch.Tensor:
        """This rank's chunk of ``a ^ b``'s word stream."""
        return self._bulk_global(a, b, "xor")

    def xnor(self, a, b) -> torch.Tensor:
        return self._bulk_global(a, b, "xnor")

    def digest(self, buf, digest_width: int = 128) -> torch.Tensor:
        words = self._words(buf)
        out = self._digest(self._mine(words, math.lcm(128, digest_width)),
                           words.numel(), digest_width)
        self._account(buf, op="digest")
        return out

    def digest_chunks(self, buf, chunk_words: int | None = None,
                      digest_width: int = 128) -> torch.Tensor:
        """One digest row per ``chunk_words`` slab, each slab spread over
        the ranks as :meth:`digest` spreads a buffer; the rows' partials
        cross ranks in one fold."""
        words = self._words(buf).reshape(-1)
        chunk = self._chunk_words(chunk_words, digest_width)
        align = math.lcm(128, digest_width)
        rows = []
        for s0 in range(0, max(words.numel(), 1), chunk):
            mine = self._mine(words[s0:s0 + chunk], align)
            rows.append(ops.digest(mine, digest_width) if mine.numel() else
                        torch.zeros(digest_width, dtype=torch.int32,
                                    device=words.device))
        out = sharding.pxor(torch.stack(rows), self.group)
        self._account(words, op="digest")
        return out

    def stream_cipher(self, buf, key, counter: int = 0) -> torch.Tensor:
        """This rank's chunk of the ciphertext's word stream."""
        out = self._cipher(self._mine(buf), key, buf.numel(), counter)
        self._account(buf, op="cipher")
        return out
