"""Fused (flash) softmax attention: wrapper of ``csrc/flash_attn.cu``.

Replaces ``repro/kernels/flash_attn.py::flash_attention`` (the
``pl.pallas_call`` at flash_attn.py:82), built for qwen2-7b's prefill
attention at long context, where chunked attention streams its f32 scores
through device memory once per chunk.  The kernel keeps each score tile on
chip and reads Q, K and V once per query tile.

CPU tensors run the tiled plain version — the online-softmax recurrence of
:mod:`repro_torch.kernels.online_softmax` over ``bk``-key tiles, with the
reference's rule that a query tile whose keys in a tile are all above the
causal diagonal skips that tile — which is what the JAX kernel computes in
interpret mode.  CUDA tensors launch the kernel, which has its own tile
sizes.  :func:`flash_attention_ref` is the one-shot oracle.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import cuda
from repro_torch.kernels import online_softmax as osm

NEG_INF = osm.NEG_INF
MAX_DH = 256
MAX_HEADS = 65535          # the grid's y extent


def flops(bh: int, s: int, dh: int, causal: bool) -> float:
    """4 * dh operations for each query-key pair the mask keeps."""
    return 4.0 * dh * bh * (s * (s + 1) / 2 if causal else s * s)


def cost(bh: int, s: int, dh: int, causal: bool = True,
         itemsize: int = 2) -> cuda.Cost:
    """One launch: q, k, v read and the output written once."""
    return cuda.Cost(4 * bh * s * dh * itemsize, flops(bh, s, dh, causal),
                     "bf16" if itemsize == 2 else "f32")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, bq: int = 256,
                    bk: int = 256) -> torch.Tensor:
    """q, k, v (BH, S, dh) f32 or bf16 -> (BH, S, dh) in q's dtype.

    ``S`` must be a multiple of ``bq`` and ``bk``, as in the reference;
    the tile sizes shape the plain version's recurrence, not the kernel's.
    Scores are ``(q . k) * dh**-0.5`` in f32 from upcast inputs."""
    cuda.check(q.ndim == 3 and q.shape == k.shape == v.shape,
               f"q, k, v must share one (BH, S, dh) shape, got "
               f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    bh, s, dh = q.shape
    cuda.check(bq > 0 and bk > 0 and s % bq == 0 and s % bk == 0,
               f"S={s} must be a multiple of bq={bq} and bk={bk}")
    cuda.check(q.dtype in (torch.float32, torch.bfloat16)
               and k.dtype == q.dtype and v.dtype == q.dtype,
               f"q, k, v must all be f32 or all bf16, got {q.dtype}, "
               f"{k.dtype}, {v.dtype}")
    if not cuda.use_kernel(q, k, v):
        return _tiled(q, k, v, causal, bq, bk)
    cuda.check(dh % 8 == 0 and 8 <= dh <= MAX_DH,
               f"the flash kernel takes dh a multiple of 8 up to {MAX_DH}, "
               f"got {dh}")
    cuda.check(all(t.is_contiguous() for t in (q, k, v)),
               "flash_attention needs contiguous q, k, v")
    cuda.check(bh <= MAX_HEADS, f"the flash kernel takes up to {MAX_HEADS} "
               f"heads per launch, got BH={bh}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if cuda.traced(q):
        cuda.record("flash_attention",
                    cost(bh, s, dh, causal, q.element_size()))
        return out
    with torch.cuda.device(q.device):
        cuda.launch("flash_attention", q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), out.data_ptr(), cuda.DTYPE_CODES[q.dtype],
                    bh, s, dh, float(dh ** -0.5), int(bool(causal)),
                    cuda.stream(q))
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def _tiled(q, k, v, causal: bool, bq: int, bk: int) -> torch.Tensor:
    """The plain version: the JAX kernel's grid walk, with every query tile
    of a key step updated at once (query tiles are independent)."""
    bh, s, dh = q.shape
    qf, kf, vf = q.float(), k.float(), v.float()
    m, l, acc = osm.init((bh, s), dh, q.device)
    qpos = torch.arange(s, device=q.device)[:, None]
    for k0 in range(0, s, bk):
        # the reference skips query tile i at this key step when
        # k0 > i*bq + bq - 1: the first live tile is ceil((k0+1)/bq) - 1
        r0 = max(0, -(-(k0 + 1) // bq) - 1) * bq if causal else 0
        sc = torch.matmul(qf[:, r0:], kf[:, k0:k0 + bk].transpose(1, 2))
        sc = sc * dh ** -0.5
        if causal:
            kpos = torch.arange(k0, k0 + bk, device=q.device)[None]
            sc = torch.where(kpos <= qpos[r0:], sc, NEG_INF)
        m[:, r0:], l[:, r0:], acc[:, r0:] = osm.update(
            sc, vf[:, k0:k0 + bk], m[:, r0:], l[:, r0:], acc[:, r0:])
    return osm.finish(m, l, acc).to(q.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """Oracle: one-shot masked softmax attention in f32, cast to q's
    dtype."""
    s, dh = q.shape[1], q.shape[2]
    sc = torch.matmul(q.float(), k.float().transpose(1, 2)) * dh ** -0.5
    if causal:
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        sc = torch.where(mask[None], sc, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    return torch.matmul(p, v.float()).to(q.dtype)
