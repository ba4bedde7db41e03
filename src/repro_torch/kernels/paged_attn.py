"""Fused block-paged decode attention: wrapper of ``csrc/paged_attn.cu``.

Replaces ``repro/kernels/paged_attn.py::paged_decode_attention`` and the
online softmax of ``repro/kernels/online_softmax.py``, which lives on as
device code inside the kernel.  The kernel splits each (slot, KV head)'s
table walk across ``n_split`` blocks (:func:`split_plan`, chosen on the
host from shapes alone) and merges the splits' partial (m, l, acc) states
in the last block to finish, as :func:`online_softmax.merge
<repro_torch.kernels.online_softmax.merge>` does.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels import cuda, ref
from repro_torch.kernels import online_softmax as osm

MAX_SMEM = 227 * 1024
WARPS = 4                  # warps of a block, each walking its own columns
MAX_G = 16                 # query rows per KV head the kernel holds
MAX_DH = 256
BLOCKS_PER_SM = 3          # split target: blocks per SM (two in flight)
PLAN_SLOTS = 4             # the batch the split plan sizes its grid for


def split_plan(w: int, kv: int, sms: int) -> tuple[int, int]:
    """-> (n_split, cols): the table's ``w`` columns cut into ``n_split``
    contiguous ranges of ``cols`` (the last may be shorter, none is empty),
    enough for about ``BLOCKS_PER_SM`` blocks on each of ``sms`` SMs over
    ``PLAN_SLOTS`` slots of ``kv`` heads, never more splits than columns.
    Shapes only: the plan never reads positions, so a decode step needs no
    device-to-host copy; and it does not read the launch's batch, so a
    slot's walk and merge order, and with them its output bits, are the
    same in an engine of any ``slots`` (a session migrates between such
    engines token for token).  At ``PLAN_SLOTS`` slots the plan is the
    one a batch-sized plan would pick; at W 2048 on an H100 it was no
    slower than a batch-sized plan at 1, 16 or 32 slots either
    (``chip_smoke.py --paged-plans``)."""
    cuda.check(w >= 1 and kv >= 1 and sms >= 1,
               f"split_plan needs W, KV, SMs >= 1, got {w}, {kv}, {sms}")
    n = max(1, min(w, -(-BLOCKS_PER_SM * sms // (PLAN_SLOTS * kv))))
    cols = -(-w // n)
    return -(-w // cols), cols


def live_columns(pos: torch.Tensor, w: int, bs: int,
                 window: int = 0) -> torch.Tensor:
    """(B, W) bool: table column ``c`` of slot ``b`` holds a key the mask
    keeps — the rule the kernel applies in O(1) per column to skip dead
    columns.  Monotone: ``c*bs <= pos``.  Ring: the column's ages are
    ``a0, a0-1, ..., a0-bs+1 (mod cap)``, ``a0 = (pos % cap - c*bs) mod
    cap``, so it is live when ``a0 - (bs-1) < min(window, pos+1)``."""
    c = torch.arange(w, device=pos.device)[None]
    p = pos.long()[:, None]
    if window:
        cap = w * bs
        a0 = torch.remainder(torch.remainder(p, cap) - c * bs, cap)
        return a0 - (bs - 1) < torch.clamp(p + 1, max=window)
    return c * bs <= p


def split_reference(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                    table: torch.Tensor, pos: torch.Tensor, *,
                    window: int = 0, scale: float = 1.0,
                    out_scale: float = 1.0, sms: int) -> torch.Tensor:
    """The kernel's split walk in plain PyTorch: each split of
    ``split_plan(W, KV, sms)`` runs the online recurrence over its live
    columns, and the splits' states meet in ``online_softmax.merge``.
    Equal to ``ref.paged_decode`` up to f32 rounding; the card tests hold
    the kernel's last-block merge against it."""
    b, kv, g, dh = q.shape
    w, bs = table.shape[1], ck.shape[2]
    n, cols = split_plan(w, kv, sms)
    idx = table.long()
    gk = ck[idx].permute(0, 2, 1, 3, 4).float()       # (B, KV, W, bs, dh)
    gv = cv[idx].permute(0, 2, 1, 3, 4).float()
    kslot = torch.arange(w * bs, device=q.device)[None]
    p = pos.long()[:, None]
    if window:
        age = torch.remainder(torch.remainder(p, w * bs) - kslot, w * bs)
        valid = age < torch.clamp(p + 1, max=window)
    else:
        valid = kslot <= p
    live = live_columns(pos, w, bs, window)
    qf = q.float()
    parts = []
    for i in range(n):
        state = osm.init((b, kv, g), dh, q.device)
        for c in range(i * cols, min(w, (i + 1) * cols)):
            keep = valid[:, c * bs:(c + 1) * bs][:, None, None]
            s = torch.einsum("bkgd,bksd->bkgs", qf, gk[:, :, c]) * scale
            new = osm.update(torch.where(keep, s, osm.NEG_INF), gv[:, :, c],
                             *state)
            on = live[:, c][:, None, None, None]
            state = tuple(torch.where(on, a, o) for a, o in zip(new, state))
        parts.append(state)
    return (osm.finish(*osm.merge(parts)) * out_scale).to(q.dtype)


@functools.lru_cache(maxsize=None)
def instance(g: int, dh: int, item: int) -> tuple[int, int]:
    """-> (gm, rw): the kernel instance ``csrc/paged_attn.cu`` launches for
    G rows at width dh over pool elements of ``item`` bytes: ``rw`` row
    groups of up to ``gm`` rows, one a warp, the four warps forming
    4 / rw walkers of the table."""
    if dh > 128 and (g > 8 or item == 4):
        return 8, 2
    return (16 if g > 8 else 8), 1


def smem_bytes(g: int, dh: int, bs: int, item: int) -> int:
    """Dynamic shared memory of that instance: the walkers' K/V rings
    (reused for their P V sums), the warps' score and (m, l) rows and the
    last-block flag."""
    gm, rw = instance(g, dh, item)
    stages = 2 if item == 4 else 3            # each walker's K/V ring
    ring = (WARPS // rw) * stages * 2 * bs * dh * item
    red = 4 * (WARPS // rw) * g * dh          # the walkers' P V sums
    return max(ring, red) + 4 * WARPS * (bs * gm + 3 * gm) + 16


def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_tickets: dict[int, torch.Tensor] = {}


def _ticket_buffer(device: torch.device, n: int) -> torch.Tensor:
    """The kernel's per-(slot, head) merge tickets on ``device``: zero
    between launches (the last block of each pair resets its own), so one
    buffer serves every launch on the device's stream."""
    buf = _tickets.get(device.index)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _tickets[device.index] = buf
    return buf


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
    item = ck.element_size()
    cuda.check(dh % 8 == 0 and (bs * dh * item) % 16 == 0,
               f"the paged kernel takes dh a multiple of 8 and pool pages of "
               f"a multiple of 16 bytes, got dh={dh}, bs={bs}, {ck.dtype}")
    cuda.check(1 <= g <= MAX_G and dh <= MAX_DH,
               f"the paged kernel takes G up to {MAX_G} and dh up to "
               f"{MAX_DH}; got G={g}, dh={dh}")
    cuda.check(ck.data_ptr() % 16 == 0 and cv.data_ptr() % 16 == 0,
               "paged_decode_attention needs 16-byte-aligned pools")
    smem = smem_bytes(g, dh, bs, item)
    cuda.check(smem <= MAX_SMEM, f"G={g}, bs={bs}, dh={dh} need {smem} "
               "bytes of shared memory")
    out = torch.empty_like(q)
    n_split, cols = split_plan(w, kv, _sm_count(q.device.index))
    scratch = [0, 0, 0]
    if n_split > 1:
        part_acc = torch.empty(b * kv * n_split * g * dh,
                               dtype=torch.float32, device=q.device)
        part_ml = torch.empty(b * kv * n_split * g * 2, dtype=torch.float32,
                              device=q.device)
        scratch = [part_acc.data_ptr(), part_ml.data_ptr(),
                   _ticket_buffer(q.device, b * kv).data_ptr()]
    with torch.cuda.device(q.device):
        cuda.launch("paged_decode", q.data_ptr(), cuda.DTYPE_CODES[q.dtype],
                    ck.data_ptr(), cv.data_ptr(), cuda.DTYPE_CODES[ck.dtype],
                    table.data_ptr(), pos.data_ptr(), out.data_ptr(),
                    *scratch, b, kv, g, dh, bs, w, int(window), n_split,
                    cols, float(scale), float(out_scale), cuda.stream(q))
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
