"""XNOR-popcount products: wrappers of ``csrc/xnor_gemm.cu`` and
``csrc/xnor_linear.cu``.

:func:`xnor_gemm` replaces ``repro/kernels/xnor_gemm.py::xnor_gemm`` (the
packed (M, Kw) x (N, Kw) product of the unfused chain);
:func:`xnor_linear_fused` replaces ``xnor_linear_fused`` there (binarize,
product and scales in one launch, the serving path).  CPU tensors run the
plain versions of :mod:`repro_torch.kernels.ref`; CUDA tensors launch the
kernels.  :func:`linear_plan` is the fused kernel's launch plan, from the
shapes alone; :func:`linear_kernel_order` is the fused linear summed in the
kernel's order, which the kernel equals bitwise.  :func:`gemm_plan` is the
packed GEMM's plan, which ``csrc/xnor_gemm.cu`` computes from the same
shapes.
"""

from __future__ import annotations

import typing

import torch
import torch.nn.functional as F

from repro_torch.core import bitpack
from repro_torch.kernels import cuda, ref

MAX_SMEM = 227 * 1024
MAX_CLUSTER = 8            # blocks of a cluster (the portable limit)
COLS = 32                  # output columns a block: one per lane
RESIDENT = 4 * 132         # 8-warp blocks an H100 keeps resident at once
RANGE_BYTES = 2048         # bytes of an activation row one pack task reads
GEMM_TARGET_WARPS = 132 * 16   # warps that keep the card's memory busy


class LinearPlan(typing.NamedTuple):
    """The fused kernel's launch plan.  A block of ``warps`` warps owns
    ``COLS`` columns of one column tile, the ``split``-th part of K
    (``kq_slice`` 16-byte quads, the last part shorter) and up to ``rows``
    activation rows of one pass; ``cluster_tiles`` tiles times ``split``
    blocks make a cluster."""

    rows: int              # activation rows a pass: 4, 8 or 32
    passes: int            # grid.y: ceil(M / rows)
    warps: int             # warps a block: 4 or 8
    split: int             # blocks that share a column tile's K
    kq_slice: int          # 16-byte quads of K a block
    cluster_tiles: int     # column tiles a cluster
    tiles: int             # column tiles: ceil(N / COLS)
    grid: tuple[int, int]  # (tiles padded to whole clusters * split, passes)
    smem: int              # dynamic shared memory a block, bytes

    @property
    def cluster(self) -> int:
        return self.split * self.cluster_tiles


def _r16(n: int) -> int:
    return -(-n // 16) * 16


def _smem(warps: int, rows: int, split: int, kq_slice: int, cluster: int,
          k: int, itemsize: int) -> int:
    """Mirror of ``Smem`` in ``csrc/xnor_linear.cu``: mbarriers, alpha,
    its per-task parts (16 bytes each), the split's partials, the K
    split's counts (M <= 8), the weight tile and the rows' planes (quads
    in pairs, an odd stride), the x ring (one or two 2 KB TMA segments per
    packing warp) and, per warp, two packed ranges, each with its alpha
    part."""
    kp = kq_slice + kq_slice % 2
    g = pack_tasks(k, itemsize)
    row = k * itemsize
    seg = min(RANGE_BYTES, row) if row % 16 == 0 else 0
    tasks = rows * g
    packers = min(warps, -(-tasks // cluster))
    stages = 0 if not seg else 2 if tasks > warps * cluster else 1
    sq = 2 * (RANGE_BYTES // (32 * itemsize) // 4 + 1)
    size = 16 * warps + 32 + _r16(rows * 4) + 16 * rows * g
    size += 4 * split * rows * COLS if split > 1 else 0
    size += (warps - 2) * 4 * COLS * 4 if rows <= 8 else 0
    size += 16 * (COLS + rows) * (kp + 1)
    return size + packers * stages * seg + warps * 16 * sq


def linear_plan(m: int, n: int, k: int, itemsize: int = 2) -> LinearPlan:
    """-> the plan of one ``xnor_linear_fused`` launch on (M, K) x (N, K)
    with ``itemsize``-byte activations.

    A cluster takes as many column tiles as it can (up to
    ``MAX_CLUSTER``): every cluster packs all the activation rows, so
    fewer, larger clusters pack less.  Blocks have 8 warps (more warps to
    pack with), except at M <= 8 when the grid has more blocks than the
    card keeps resident at 8 warps (``RESIDENT``): then 4, so it runs in
    one wave.  K is split only where a block's tile would not fit its
    shared memory.  Shapes only: the same shapes always get the same
    plan."""
    cuda.check(m >= 1 and n >= 1 and k >= 1,
               f"linear_plan needs M, N, K >= 1, got {m}, {n}, {k}")
    kq = -(-bitpack.packed_width(k) // 4)
    rows = 4 if m <= 4 else 8 if m <= 8 else 32
    passes = -(-m // rows)
    tiles = -(-n // COLS)
    warps = 4 if rows <= 8 and tiles * passes > RESIDENT else 8
    split = 1
    while True:
        kq_slice = -(-kq // split)
        split = -(-kq // kq_slice)               # no empty part
        ct = max(1, min(MAX_CLUSTER // split, tiles))
        smem = _smem(warps, rows, split, kq_slice, split * ct, k, itemsize)
        if smem <= MAX_SMEM or split >= min(MAX_CLUSTER, kq):
            break
        split += 1
    grid = (-(-tiles // ct) * ct * split, passes)
    return LinearPlan(rows, passes, warps, split, kq_slice, ct, tiles, grid,
                      smem)


class BlockWork(typing.NamedTuple):
    rows: range            # activation rows
    cols: range            # output columns
    words: range           # 32-bit words of K


def linear_blocks(plan: LinearPlan, m: int, n: int, k: int):
    """Yield each block's work as the kernel computes it from its index:
    cluster rank ``bx % cluster``, split part ``rank % split``, column tile
    ``(bx // cluster) * cluster_tiles + rank // split``."""
    kw = bitpack.packed_width(k)
    c, s_n = plan.cluster, plan.split
    for by in range(plan.grid[1]):
        r0 = by * plan.rows
        for bx in range(plan.grid[0]):
            rank = bx % c
            s, ct = rank % s_n, rank // s_n
            col0 = ((bx // c) * plan.cluster_tiles + ct) * COLS
            w0 = s * plan.kq_slice * 4
            w1 = min(kw, w0 + plan.kq_slice * 4)
            yield BlockWork(range(r0, min(m, r0 + plan.rows)),
                            range(col0, min(n, col0 + COLS)),
                            range(min(w0, kw), w1))


def pack_tasks(k: int, itemsize: int) -> int:
    """Pack tasks a row: its ranges of ``RANGE_BYTES`` (32 words of bf16,
    16 of f32), each packed by one warp."""
    return -(-bitpack.packed_width(k) // (RANGE_BYTES // (32 * itemsize)))


def packer(t: int, plan: LinearPlan) -> tuple[int, int]:
    """-> (cluster rank, warp) that packs task ``t`` of a pass (task
    ``t`` = range ``t % G`` of row ``t // G``)."""
    return t % plan.cluster, (t // plan.cluster) % plan.warps


def alpha_kernel_order(x: torch.Tensor) -> torch.Tensor:
    """alpha = sum|x| / K summed as ``csrc/xnor_linear.cu`` sums it, in f32:
    lane l of a warp takes element 32w + l of each 32-wide word w (0 past
    K); a row is packed in ranges of ``RANGE_BYTES`` (32 words of bf16,
    16 of f32), within which each lane adds its elements in sequence from
    0 and the 32 lanes meet in an xor butterfly; the ranges' sums are
    added in order, and the total is divided by K."""
    m, k = x.shape
    kw = bitpack.packed_width(k)
    step = RANGE_BYTES // (32 * x.element_size())
    seq = F.pad(x.float().abs(), (0, kw * 32 - k)).reshape(m, kw, 32)
    lanes = torch.arange(32, device=x.device)
    total = None
    for w0 in range(0, kw, step):
        acc = torch.zeros((m, 32), dtype=torch.float32, device=x.device)
        for w in range(w0, min(w0 + step, kw)):
            acc = acc + seq[:, w]
        for o in (16, 8, 4, 2, 1):
            acc = acc + acc[:, lanes ^ o]
        total = acc[:, 0] if total is None else total + acc[:, 0]
    return total / torch.full((m,), float(k), device=x.device)


def linear_kernel_order(x: torch.Tensor, pb: torch.Tensor, beta: torch.Tensor,
                        valid_k: int) -> torch.Tensor:
    """The plain fused linear with the kernel's alpha (f32, its summation
    order) in place of the reference's (``x.dtype``, torch's order): equal
    to the kernel bitwise.  The dots are integers, so the plan's split of
    K does not enter."""
    dots = ref.xnor_gemm(bitpack.pack_bits(bitpack.pad_to_word(x)), pb,
                         valid_k).float()
    return dots * alpha_kernel_order(x)[:, None] * beta[None, :]


class GemmPlan(typing.NamedTuple):
    """The packed GEMM's launch plan (``gemm_plan`` in
    ``csrc/xnor_gemm.cu``).  A warp owns 16 weight columns and ``nt``
    8-row n-tiles of activations; ``ks`` warps split K (16-word steps,
    round robin) and ``ct`` column tiles make a block of ``ks * ct``
    warps; the grid is ``row_tiles * col_blocks`` blocks in one
    dimension."""

    nt: int                # 8-row n-tiles a warp: 1, 2, 4 or 8
    ks: int                # warps splitting K: 1 to 8, or 16 at nt = 1
    ct: int                # 16-column tiles a block
    row_tiles: int         # ceil(M / (8 nt))
    col_blocks: int        # ceil(ceil(N / 16) / ct)

    @property
    def warps(self) -> int:
        return self.ks * self.ct

    @property
    def blocks(self) -> int:
        return self.row_tiles * self.col_blocks


def gemm_plan(m: int, n: int, kw: int) -> GemmPlan:
    """-> the plan of one ``xnor_gemm`` launch on (M, Kw) x (N, Kw) planes.

    Rows: up to 64 a block (8 to 64 by M), so the weights are read once for
    every M <= 64.  K splits across 2, 4 or 8 warps of a block (16 at one
    n-tile a warp) while the warps stay within ``GEMM_TARGET_WARPS`` (16 an
    SM; twice that at one n-tile, whose warps hold fewer bytes in flight)
    and each keeps a 16-word step of K at least.  Shapes only."""
    cuda.check(m >= 1 and n >= 1 and kw >= 0,
               f"gemm_plan needs M, N >= 1 and Kw >= 0, got {m}, {n}, {kw}")
    nt = 1 if m <= 8 else 2 if m <= 16 else 4 if m <= 32 else 8
    row_tiles = -(-m // (8 * nt))
    tiles = -(-n // 16)
    steps = -(-kw // 16)
    target = GEMM_TARGET_WARPS * (2 if nt == 1 else 1)
    max_ks = 16 if nt == 1 else 8
    ks = 1
    while ks < max_ks and 2 * ks <= steps and \
            tiles * row_tiles * 2 * ks <= target:
        ks *= 2
    ct = 1 if ks >= 4 else 4 // ks
    return GemmPlan(nt, ks, ct, row_tiles, -(-tiles // ct))


def gemm_cost(m: int, n: int, kw: int, k: int) -> cuda.Cost:
    """One ``xnor_gemm`` launch: both planes read, the (M, N) int32 dots
    written; 2 M N K binary operations at the int8 tensor-core rate."""
    return cuda.Cost((m + n) * kw * 4 + m * n * 4, 2 * m * n * k, "int8")


def linear_cost(m: int, n: int, k: int, itemsize: int = 2) -> cuda.Cost:
    """One ``xnor_linear_fused`` launch: x, the planes and beta read, the
    (M, N) f32 output written; 2 M N K binary operations at the int8
    tensor-core rate."""
    kw = bitpack.packed_width(k)
    return cuda.Cost(m * k * itemsize + n * kw * 4 + n * 4 + m * n * 4,
                     2 * m * n * k, "int8")


def xnor_gemm(pa: torch.Tensor, pb: torch.Tensor,
              valid_k: int) -> torch.Tensor:
    """(M, Kw) x (N, Kw) int32 planes -> (M, N) int32 ``valid_k - 2*popc``.

    The kernel walks the true Kw words and masks ragged M, N and Kw
    itself: no operand is padded or copied.  One launch of the plan
    :func:`gemm_plan` gives these shapes; any Kw, and any M and N whose
    plan has fewer than 2^31 blocks."""
    cuda.check(pa.ndim == 2 and pb.ndim == 2 and pa.shape[1] == pb.shape[1],
               f"xnor_gemm needs (M, Kw) x (N, Kw), got {tuple(pa.shape)} "
               f"x {tuple(pb.shape)}")
    if not cuda.use_kernel(pa, pb):
        return ref.xnor_gemm(pa, pb, valid_k)
    cuda.check(pa.dtype == torch.int32 and pb.dtype == torch.int32,
               f"planes must be int32 words, got {pa.dtype}/{pb.dtype}")
    cuda.check(pa.is_contiguous() and pb.is_contiguous(),
               "xnor_gemm needs contiguous planes")
    m, kw = pa.shape
    n = pb.shape[0]
    if m == 0 or n == 0:
        return torch.empty((m, n), dtype=torch.int32, device=pa.device)
    cuda.check(m < 2 ** 31 and n < 2 ** 31 and kw < 2 ** 31
               and gemm_plan(m, n, kw).blocks < 2 ** 31,
               f"xnor_gemm takes shapes whose plan has fewer than 2^31 "
               f"blocks, got M={m}, N={n}, Kw={kw}")
    out = torch.empty((m, n), dtype=torch.int32, device=pa.device)
    if cuda.traced(pa):
        cuda.record("xnor_gemm", gemm_cost(m, n, kw, valid_k))
        return out
    with torch.cuda.device(pa.device):
        cuda.launch("xnor_gemm", pa.data_ptr(), pb.data_ptr(),
                    out.data_ptr(), m, n, kw, valid_k, cuda.stream(pa))
    xnor_gemm.launches += 1
    return out


xnor_gemm.launches = 0


def xnor_linear_fused(x: torch.Tensor, pb: torch.Tensor, beta: torch.Tensor,
                      valid_k: int) -> torch.Tensor:
    """(M, K) float x (N, Kw) int32 planes, (N,) f32 beta -> (M, N) f32.

    ``K == valid_k`` is the true width (no host-side pad: the kernel packs
    elements past K as bit 1, matching the planes' tail bits).  One launch
    of the plan :func:`linear_plan` gives these shapes."""
    cuda.check(x.ndim == 2 and pb.ndim == 2 and beta.ndim == 1,
               f"shapes {tuple(x.shape)}, {tuple(pb.shape)}, "
               f"{tuple(beta.shape)}")
    m, k = x.shape
    n, kw = pb.shape
    cuda.check(k == valid_k, f"activation width {k} != valid_k {valid_k}")
    cuda.check(kw == bitpack.packed_width(k),
               f"planes hold {kw} words, K={k} needs "
               f"{bitpack.packed_width(k)}")
    cuda.check(beta.shape[0] == n, f"beta {beta.shape[0]} != N {n}")
    if not cuda.use_kernel(x, pb, beta):
        return ref.xnor_linear_fused(x, pb, beta, valid_k)
    cuda.check(x.dtype in (torch.float32, torch.bfloat16),
               f"x must be f32/bf16, got {x.dtype}")
    cuda.check(pb.dtype == torch.int32 and beta.dtype == torch.float32,
               f"pb must be int32 and beta f32, got {pb.dtype}/{beta.dtype}")
    cuda.check(x.is_contiguous() and pb.is_contiguous()
               and beta.is_contiguous(), "xnor_linear_fused needs contiguous "
               "operands")
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return out
    plan = linear_plan(m, n, k, x.element_size())
    cuda.check(plan.smem <= MAX_SMEM and plan.cluster <= MAX_CLUSTER
               and plan.grid[0] < 2 ** 31 and plan.grid[1] <= 65535,
               f"xnor_linear_fused takes shapes whose plan fits a block's "
               f"{MAX_SMEM} bytes of shared memory, a cluster of "
               f"{MAX_CLUSTER} and the grid; M={m}, N={n}, K={k} need "
               f"{plan.smem} bytes, a cluster of {plan.cluster} and grid "
               f"{plan.grid}")
    if cuda.traced(x):
        cuda.record("xnor_linear_fused", linear_cost(m, n, k,
                                                     x.element_size()))
        return out
    with torch.cuda.device(x.device):
        cuda.launch("xnor_linear_fused", x.data_ptr(),
                    cuda.DTYPE_CODES[x.dtype], pb.data_ptr(),
                    beta.data_ptr(), out.data_ptr(), m, k, kw, n, plan.rows,
                    plan.warps, plan.split, plan.kq_slice,
                    plan.cluster_tiles, cuda.stream(x))
    xnor_linear_fused.launches += 1
    return out


xnor_linear_fused.launches = 0
