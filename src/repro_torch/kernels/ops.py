"""Public ops: shape handling around the kernels, dispatch by device.

Every op runs its CUDA kernel on CUDA tensors and its plain PyTorch version
(:mod:`repro_torch.kernels.ref`) on CPU tensors; the wrappers in
``pack.py``, ``xnor_gemm.py``, ``paged_attn.py``, ``bulk.py``,
``parity.py`` and ``cipher.py`` make that choice from the tensor's device
alone.

Words are int32 tensors carrying uint32 bits.  :func:`as_words` views any
tensor's bytes as that little-endian word stream — zero-copy wherever the
byte count and alignment allow — and :func:`host_words` does the same for
numpy arrays; the two define one byte layout, so digests and ciphertext
agree between the host and device paths.  Unlike the reference, no op pads
its buffer to whole (R, 128) tiles: the kernels mask their own ragged
tails.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import bulk as _bulk
from repro_torch.kernels import cipher as _cipher
from repro_torch.kernels import pack as _pack
from repro_torch.kernels import parity as _parity
from repro_torch.kernels import xnor_gemm as _xnor_gemm


def fused_mode(mode: str = "auto") -> str:
    """Resolve the decode-path fusion setting to ``"kernel"`` or ``"ref"``.

    ``"kernel"`` routes the binarized linears and decode attention through
    the fused ops (kernels on CUDA, their plain versions on the CPU);
    ``"ref"`` keeps the unfused chain: binarize (the pack kernel) ->
    :func:`xnor_matmul` (the ``xnor_gemm`` kernel) -> scale for the
    linears, and the gather / mask / softmax chain in plain PyTorch for
    decode attention (the reference's XLA code, no kernel of its own).
    """
    if mode in ("auto", "on", "kernel", "fused"):
        return "kernel"
    if mode in ("off", "ref", "unfused"):
        return "ref"
    raise ValueError(f"unknown fused-decode mode {mode!r}; expected "
                     "auto|on|kernel|fused|off|ref|unfused")


def binarize(x: torch.Tensor):
    """(..., K) float -> ((..., Kw) int32 planes, (...,) f32 alpha)."""
    lead, k = x.shape[:-1], x.shape[-1]
    planes, alpha = _pack.pack(x.reshape(-1, k).contiguous())
    return planes.reshape(*lead, -1), alpha.reshape(lead)


def xnor_matmul(pa: torch.Tensor, pb: torch.Tensor,
                valid_k: int) -> torch.Tensor:
    """±1 dot in the packed domain: (M, Kw) x (N, Kw) -> (M, N) int32."""
    return _xnor_gemm.xnor_gemm(pa.contiguous(), pb.contiguous(), valid_k)


def xnor_linear_fused(x: torch.Tensor, pb: torch.Tensor, beta: torch.Tensor,
                      valid_k: int) -> torch.Tensor:
    """Single-launch packed linear: (M, K) x (N, Kw) planes -> (M, N) f32."""
    return _xnor_gemm.xnor_linear_fused(x.contiguous(), pb, beta, valid_k)


def digest(buf, digest_width: int = 128) -> torch.Tensor:
    """XOR-parity digest of any tensor (viewed as its word stream) ->
    (digest_width,) int32."""
    return _parity.parity_digest(as_words(buf), digest_width)[0]


def digest_chunks(words: torch.Tensor, chunk_words: int,
                  digest_width: int = 128) -> torch.Tensor:
    """One digest row per ``chunk_words`` slab of a word stream ->
    (n_chunks, digest_width) int32, in one launch."""
    return _parity.parity_digest(words.reshape(-1), digest_width,
                                 chunk_words)


def bulk_op(a: torch.Tensor, b: torch.Tensor, op: str = "xor") -> torch.Tensor:
    """Bulk bitwise XOR/XNOR of two same-shape int32 word buffers — the
    digital form of the banked engine's compute cycle."""
    if op not in ("xor", "xnor"):
        raise ValueError(f"bulk_op supports xor/xnor, got {op!r}")
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError(f"bulk_op needs int32 words, got {a.dtype}/{b.dtype}")
    if a.shape != b.shape:
        raise ValueError(f"operand shapes differ: {tuple(a.shape)} vs "
                         f"{tuple(b.shape)}")
    out = _bulk.bulk_xor(a.reshape(-1), b.reshape(-1), invert=op == "xnor")
    return out.reshape(a.shape)


def stream_cipher(buf: torch.Tensor, key, counter: int = 0) -> torch.Tensor:
    """XOR counter-mode cipher over an int32 word buffer (an involution).

    ``key`` holds (key0, key1) as integers, ``counter`` the keystream
    index of the buffer's first word; both are uint32 values."""
    if buf.dtype != torch.int32:
        raise TypeError(f"stream_cipher needs int32 words, got {buf.dtype}")
    out = _cipher.xor_cipher(buf.reshape(-1), int(key[0]), int(key[1]),
                             int(counter))
    return out.reshape(buf.shape)


def host_words(arr: np.ndarray, align: int = 4):
    """View a numpy array's bytes as the little-endian uint32 stream,
    zero-padding the tail to ``align`` bytes -> ``(words, nbytes)``.

    The one definition of the host byte layout; :func:`as_words` gives the
    same words for a tensor holding the same bytes."""
    raw = np.ascontiguousarray(arr).view(np.uint8).reshape(-1)
    nbytes = raw.size
    pad = (-nbytes) % align
    if pad:
        raw = np.concatenate([raw, np.zeros(pad, np.uint8)])
    return raw.view(np.uint32), nbytes


def as_words(buf) -> torch.Tensor:
    """Any tensor's bytes as a flat int32 word stream (uint32 bits).

    A contiguous tensor whose byte count is a multiple of 4 and whose
    start is 4-byte aligned comes back as a zero-copy ``view``: callers
    that keep the words past a later in-place edit of ``buf`` must clone
    them.  Otherwise the bytes are copied, and a 1- or 2-byte tail is
    zero-padded to a whole word, as the reference pads it (u16 pairs are
    ``lo | hi << 16``, u8 quads ``b0 | b1 << 8 | ...``).  A numpy array
    goes through :func:`host_words` and comes back as a CPU tensor holding
    a copy."""
    if not isinstance(buf, torch.Tensor):
        words, _ = host_words(np.asarray(buf))
        return torch.from_numpy(words.view(np.int32).copy())
    flat = buf.reshape(-1)
    if flat.dtype == torch.int32:
        return flat
    if flat.dtype == torch.bool:
        flat = flat.view(torch.uint8)
    size = flat.element_size()
    pad = (-(flat.numel() * size)) % 4 // size
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    elif (flat.storage_offset() * size) % 4:
        flat = flat.clone()
    return flat.view(torch.int32)
