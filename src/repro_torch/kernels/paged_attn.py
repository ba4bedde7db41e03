"""Fused block-paged decode attention: wrapper of ``csrc/paged_attn.cu``.

Replaces ``repro/kernels/paged_attn.py::paged_decode_attention`` and the
online softmax of ``repro/kernels/online_softmax.py``, which lives on as
device code inside the kernel.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import cuda, ref

MAX_SMEM = 227 * 1024


def paged_decode_attention(q: torch.Tensor, ck: torch.Tensor,
                           cv: torch.Tensor, table: torch.Tensor,
                           pos: torch.Tensor, *, window: int = 0,
                           scale: float = 1.0,
                           out_scale: float = 1.0) -> torch.Tensor:
    """One decode-attention launch over the block-paged pool.

    q (B, KV, G, dh) f32/bf16; ck, cv (n_blocks, KV, bs, dh) f32/bf16/int8
    with this step's keys already scattered in; table (B, W) int32 block
    ids; pos (B,) int32 positions; ``window`` 0 for monotone tables, else
    the ring's window.  Returns (B, KV, G, dh) in q.dtype.  Table entries
    are trusted to lie in [0, n_blocks) — the host allocator builds them.
    """
    cuda.check(q.ndim == 4 and ck.ndim == 4 and ck.shape == cv.shape,
               f"q {tuple(q.shape)}, pools {tuple(ck.shape)}/"
               f"{tuple(cv.shape)}")
    b, kv, g, dh = q.shape
    _, kv2, bs, dh2 = ck.shape
    cuda.check(kv == kv2 and dh == dh2, f"q {tuple(q.shape)} vs pool "
               f"{tuple(ck.shape)}")
    cuda.check(table.ndim == 2 and table.shape[0] == b
               and tuple(pos.shape) == (b,),
               f"table {tuple(table.shape)}, pos {tuple(pos.shape)} for B={b}")
    if not cuda.use_kernel(q, ck, cv, table, pos):
        return ref.paged_decode(q, ck, cv, table, pos, window=window,
                                scale=scale, out_scale=out_scale)
    cuda.check(q.dtype in (torch.float32, torch.bfloat16),
               f"q must be f32/bf16, got {q.dtype}")
    cuda.check(ck.dtype == cv.dtype and ck.dtype in cuda.DTYPE_CODES,
               f"pools must be f32/bf16/int8, got {ck.dtype}/{cv.dtype}")
    cuda.check(table.dtype == torch.int32 and pos.dtype == torch.int32,
               f"table/pos must be int32, got {table.dtype}/{pos.dtype}")
    cuda.check(all(t.is_contiguous() for t in (q, ck, cv, table, pos)),
               "paged_decode_attention needs contiguous operands")
    w = table.shape[1]
    smem = 4 * (2 * g * dh + bs * (2 * dh + 1) + g * bs + 3 * g)
    cuda.check(smem <= MAX_SMEM, f"G={g}, bs={bs}, dh={dh} need {smem} "
               "bytes of shared memory")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        cuda.launch("paged_decode", q.data_ptr(), cuda.DTYPE_CODES[q.dtype],
                    ck.data_ptr(), cv.data_ptr(), cuda.DTYPE_CODES[ck.dtype],
                    table.data_ptr(), pos.data_ptr(), out.data_ptr(), b, kv,
                    g, dh, bs, w, int(window), float(scale),
                    float(out_scale), cuda.stream(q))
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
