"""Plain PyTorch versions of the ported kernels.

Each is the semantic ground truth its CUDA kernel is held against on the
card, and the path the wrappers take for CPU tensors.  They follow
``repro/kernels/ref.py`` operation for operation, so on the CPU they match
the JAX reference bitwise in the integer domain.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import bitpack

NEG_INF = -1e30
_CHUNK_ELEMS = 1 << 24      # bounds the (M, n, Kw) int64 temporaries
MASK = 0xFFFFFFFF
GOLDEN = 0x9E3779B9


def xnor_gemm(pa: torch.Tensor, pb: torch.Tensor, valid_k: int) -> torch.Tensor:
    """(M, Kw) x (N, Kw) packed words -> (M, N) int32 ``valid_k - 2*popc``.

    Padding bits must agree between the operands (zero pads pack to 1 in
    both), so each padded slot XORs to 0.  Columns are processed in chunks
    so the int64 popcount temporaries stay bounded at real widths.
    """
    m, kw = pa.shape
    n = pb.shape[0]
    step = max(1, _CHUNK_ELEMS // max(1, m * kw))
    out = []
    for j in range(0, n, step):
        x = pa[:, None, :] ^ pb[None, j:j + step, :]
        out.append(bitpack.popcount(x).sum(-1))
    popc = torch.cat(out, dim=1) if out else pa.new_zeros((m, 0), dtype=torch.int64)
    return (valid_k - 2 * popc).to(torch.int32)


def xnor_dot_float(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Float-domain equivalence oracle: sign(a) @ sign(b).T as int32
    (sign(0) = +1)."""
    sa = torch.where(a >= 0, 1.0, -1.0)
    sb = torch.where(b >= 0, 1.0, -1.0)
    return (sa @ sb.T).to(torch.int32)


def pack(x: torch.Tensor):
    """(M, K) -> ((M, Kw) int32 planes, (M,) f32 alpha = mean|x|).

    K need not be a word multiple: the tail packs as zeros (bit 1), and
    alpha averages over the true K."""
    return (bitpack.pack_bits(bitpack.pad_to_word(x)),
            bitpack.mean_abs(x).to(x.dtype).float())


def xnor_linear_fused(x: torch.Tensor, pb: torch.Tensor, beta: torch.Tensor,
                      valid_k: int) -> torch.Tensor:
    """(M, K) activations x (N, Kw) prepacked planes -> (M, N) f32
    ``(valid_k - 2*popc) * alpha * beta`` — the exact unfused chain, with
    alpha = mean|x| kept in ``x.dtype`` as the reference keeps it."""
    alpha = bitpack.mean_abs(x).to(x.dtype)
    pa = bitpack.pack_bits(bitpack.pad_to_word(x))
    dots = xnor_gemm(pa, pb, valid_k).float()
    return dots * alpha[:, None] * beta[None, :]


def paged_decode(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                 table: torch.Tensor, pos: torch.Tensor, *, window: int = 0,
                 scale: float = 1.0, out_scale: float = 1.0) -> torch.Tensor:
    """One-shot masked-softmax decode attention through a block table.

    q (B, KV, G, dh); ck/cv (n_blocks, KV, bs, dh) in any dtype (int8
    pools carry their fixed-point factors in ``scale``/``out_scale``);
    table (B, W) int32; pos (B,) int32.  Returns (B, KV, G, dh) in q.dtype.
    """
    b, kv, g, dh = q.shape
    bs = ck.shape[2]
    cap = table.shape[1] * bs
    idx = table.long()
    gk = ck[idx].permute(0, 2, 1, 3, 4).reshape(b, kv, cap, dh)
    gv = cv[idx].permute(0, 2, 1, 3, 4).reshape(b, kv, cap, dh)
    s = torch.einsum("bkgd,bksd->bkgs", q.float(), gk.float()) * scale
    kslot = torch.arange(cap, device=q.device)
    p = pos.long()[:, None]
    if window:
        age = torch.remainder(torch.remainder(p, cap) - kslot[None], cap)
        valid = age < torch.clamp(p + 1, max=window)
    else:
        valid = kslot[None] <= p
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bksd->bkgd", w, gv.float())
    return (out * out_scale).to(q.dtype)


def bulk_xor(a: torch.Tensor, b: torch.Tensor,
             invert: bool = False) -> torch.Tensor:
    """Elementwise XOR (XNOR with ``invert``) of two int32 word buffers."""
    x = torch.bitwise_xor(a, b)
    return torch.bitwise_not(x) if invert else x


def parity_digest(words: torch.Tensor, digest_width: int,
                  chunk_words: int) -> torch.Tensor:
    """XOR-fold a flat int32 word stream, one digest row per chunk.

    Row ``c`` of the (n_chunks, digest_width) result folds words
    ``[c*chunk_words, (c+1)*chunk_words)`` (``chunk_words`` a multiple of
    the width); missing words of the last row count as zero.  Torch has no
    XOR reduction, so rows fold by halving (``x[:h] ^ x[h:2h]``, the odd
    row carried), which runs on any device.
    """
    n = words.numel()
    n_chunks = max(1, -(-n // chunk_words))
    flat = words.reshape(-1)
    if n_chunks * chunk_words != n:
        flat = F.pad(flat, (0, n_chunks * chunk_words - n))
    x = flat.reshape(n_chunks, chunk_words // digest_width, digest_width)
    while x.shape[1] > 1:
        h = x.shape[1] // 2
        y = x[:, :h] ^ x[:, h:2 * h]
        if x.shape[1] % 2:
            y[:, 0] ^= x[:, 2 * h]
        x = y
    return x[:, 0].clone()


def keystream_word(idx: torch.Tensor, key0: int, key1: int) -> torch.Tensor:
    """The reference's murmur3-finalizer keystream of word indices.

    ``idx`` is int64 in [0, 2**32); the uint32 arithmetic runs in int64,
    masked to 32 bits after every multiply and add (a product may wrap
    int64, which leaves its low 32 bits intact).  Returns int64 values in
    [0, 2**32)."""
    h = (idx * GOLDEN + key0) & MASK
    h = h ^ key1
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & MASK
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & MASK
    return h ^ (h >> 16)


def xor_cipher(words: torch.Tensor, key0: int, key1: int,
               counter: int = 0) -> torch.Tensor:
    """Counter-mode XOR of a flat int32 word stream (an involution): word
    ``i`` is XORed with ``keystream_word((i + counter) mod 2**32)``.
    Runs in slices of 2**24 words so the int64 temporaries stay bounded."""
    flat = words.reshape(-1)
    out = torch.empty_like(flat)
    for s in range(0, flat.numel(), _CHUNK_ELEMS):
        e = min(s + _CHUNK_ELEMS, flat.numel())
        idx = (torch.arange(s, e, dtype=torch.int64, device=flat.device)
               + counter) & MASK
        out[s:e] = flat[s:e] ^ bitpack.as_int32(
            keystream_word(idx, key0, key1))
    return out.reshape(words.shape)
