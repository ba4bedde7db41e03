// Fused prepacked XNOR linear on Hopper: binarize + popcount GEMM +
// alpha/beta epilogue in one launch.
//
// Replaces: src/repro/kernels/xnor_gemm.py::xnor_linear_fused (the
// pl.pallas_call at xnor_gemm.py:150), reached from every binarized linear
// (core/xnor_layers.py::xnor_linear_prepacked) in prefill and decode:
// seven launches a layer, 196 a qwen2-7b decode step.
//
// Computes out[m, n] = (K - 2*popc(sign(x[m]) XOR pb[n])) * alpha[m] * beta[n]
// in f32, in that order, with alpha[m] = sum|x[m]| / K in f32 (as the TPU
// kernel does; the plain version keeps alpha in x.dtype as ref.py does).
// x is (M, K) f32/bf16 with K the true width; pb is (N, Kw) uint32 planes
// whose tail bits are 1 (the prepacker zero-pads).  Elements of x past K
// pack as 0.0 -> bit 1 here too, so pads XOR to 0 and K - 2*popc is exact
// without a host-side pad copy.
//
// Bound on this card: bytes.  At decode (M = 4) the weight planes are the
// traffic: N*Kw*4 bytes, 8.5 MB for the (18944, 3584) up-projection and
// the (3584, 18944) down-projection, 2.6 us at 3.35 TB/s; the 1.6 MB of
// wq/wo and 0.23 MB of wk/wv are a few DRAM round trips.  What the time
// goes to instead (stage stamps on the card, PERF.md): packing the
// activations and handing them to the cluster, then the binary MMAs.
//
// Design.  The plan (kernels/xnor_gemm.py::linear_plan, shapes only): a
// block of 8 warps (4 when a decode grid would not be resident at once)
// owns 32 output columns and a slice of K (all of it unless shared memory
// forces a split); a thread block cluster holds up to 8 column tiles,
// because every cluster packs all the rows.
// - Pack each activation row once per cluster, not once per block.  A row
//   is cut into 2 KB ranges, each a task for one warp of the cluster; the
//   range comes in by 1-D TMA (cp.async.bulk) into the warp's ring (x read
//   element by element where TMA cannot take it).  Lane l takes element
//   32w + l of word w and a ballot makes the word, 16 words of loads in
//   flight at a time.  Alpha's order: within a task each lane adds its
//   elements in sequence from 0, the lanes meet in an xor butterfly; the
//   tile's first block adds the row's tasks in order and divides by K
//   (xnor_gemm.alpha_kernel_order is the same sum in PyTorch).
// - The task's words go to every block whose slice holds them, and its
//   alpha part to every tile's first block, by DSMEM bulk copies
//   (cp.async.bulk shared::cta -> shared::cluster) that complete on the
//   receiver's mbarrier, which expects exactly its slice of every row.
//   No cluster-wide barrier waits for the slowest packer's neighbours.
// - The weight tile is issued at the start, one 1-D TMA copy per column
//   from the last warp, so DRAM latency hides under the pack and no
//   packing warp waits on memory queues to issue it.
// - XOR-popcount on the tensor cores: popc(a ^ b) = 256 - popc(a & b) -
//   popc(~a & ~b) per 256 bits, two mma.m16n8k256 .b1 AND.POPC (ptxas runs
//   XOR.POPC as AND plus CUDA-core popcounts, slower).  The weight planes
//   are the 16-row operand, the activations the 8-wide one, so M = 4
//   wastes half an MMA.  At M <= 8 the warps of a column tile split K; at
//   M = 32 each warp takes a (column tile, row tile) pair.  Planes and
//   weights sit at an odd 16-byte stride: the fragment loads of 8 rows
//   fall in distinct banks.
// - Epilogue: each thread owns (column, row) pairs of the MMA's fragment;
//   the parts of a K split among warps add through shared memory; a split
//   of K across blocks adds its integer partials in the tile's first block
//   in a fixed order (bulk copies onto its mbarrier).  No global atomics,
//   no scratch in device memory.
// - Rows: up to 32 in one pass (the prefill chunk), so the weights are
//   read once; larger M takes ceil(M / 32) passes, each reading them again.
#include "common.cuh"

namespace {

constexpr int kCols = 32;          // output columns per block, one per lane
constexpr int kMaxCluster = 8;
constexpr int kRangeBytes = 2048;  // bytes of an x row one pack task reads

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// 1-D TMA: `bytes` (a multiple of 16) from global src to shared dst, both
// 16-byte aligned, counted on mbarrier bar.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// The address of this block's shared `addr` in cluster block `rank`.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm("mapa.shared::cluster.u32 %0, %1, %2;\n"
      : "=r"(out)
      : "r"(addr), "r"(rank));
  return out;
}

// DSMEM bulk copy: `bytes` (a multiple of 16) from this block's shared
// memory to a cluster block's, counted on that block's mbarrier.
__device__ __forceinline__ void bulk_push(uint32_t dst, uint32_t src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "r"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's bulk-copy groups are still
// reading their sources.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d += popc(a AND b) over 256 bits on the tensor cores: a 16 x 256-bit tile
// (a, row-major) against an 8 x 256-bit one (b0, b1, column-major), in the
// PTX fragment layout of mma.m16n8k256 .b1.
__device__ __forceinline__ void bmma_and(int (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One element of x as f32 through a volatile load, so the compiler keeps
// a batch of them ahead of their uses (left to itself it issues each load
// just before the ballot that needs it: a shared-memory latency a word).
template <typename T, bool SMEM>
__device__ __forceinline__ float ld_elem(const T* p) {
  if constexpr (sizeof(T) == 2) {
    unsigned short u;
    if constexpr (SMEM)
      asm volatile("ld.shared.b16 %0, [%1];\n" : "=h"(u) : "r"(smem_u32(p)));
    else
      asm volatile("ld.global.nc.b16 %0, [%1];\n" : "=h"(u) : "l"(p));
    return __uint_as_float(static_cast<uint32_t>(u) << 16);
  } else {
    float f;
    if constexpr (SMEM)
      asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(f) : "r"(smem_u32(p)));
    else
      asm volatile("ld.global.nc.f32 %0, [%1];\n" : "=f"(f) : "l"(p));
    return f;
  }
}

// Words [wlo, whi) of a row into stw: lane l takes element 32w + l of word
// w (0 past K; element k at src[k - kofs]) and a ballot makes the word.
// Returns this lane's sum of |x| over them, in order from 0.  Loads go 16
// words at a time, all issued before the first ballot; the index is
// clamped to the row, so no load leaves it.
template <typename T, bool SMEM>
__device__ __forceinline__ float pack_range(const T* __restrict__ src,
                                            int kofs, int wlo, int whi, int K,
                                            int lane,
                                            uint32_t* __restrict__ stw) {
  constexpr int B = 16;
  float acc = 0.f;
  for (int w0 = wlo; w0 < whi; w0 += B) {
    float f[B];
#pragma unroll
    for (int j = 0; j < B; ++j)
      f[j] = ld_elem<T, SMEM>(src + (min((w0 + j) * 32 + lane, K - 1) - kofs));
    if (w0 + B <= whi && (w0 + B) * 32 <= K) {  // a whole batch inside K
#pragma unroll
      for (int j = 0; j < B; ++j) {
        const uint32_t bits = __ballot_sync(0xffffffffu, f[j] >= 0.f);
        if (lane == 0) stw[w0 + j - wlo] = bits;
        acc += fabsf(f[j]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < B; ++j) {
        const bool live = w0 + j < whi;  // uniform across the warp
        const float v = (w0 + j) * 32 + lane < K ? f[j] : 0.f;
        const uint32_t bits = __ballot_sync(0xffffffffu, v >= 0.f);
        if (lane == 0 && live) stw[w0 + j - wlo] = bits;
        acc += live ? fabsf(v) : 0.f;  // + 0 leaves the sum as it is
      }
    }
  }
  return acc;
}

__host__ __device__ __forceinline__ int imin(int a, int b) {
  return a < b ? a : b;
}

struct Layout {
  int S, KQ, CT, C;   // K split, quads a slice, tiles a cluster, cluster
};

// Shared memory, in bytes from the start (host and device):
// [mbarriers | alpha[MR] | alpha parts MR x G, 16 B each | split partials
//  S x MR x 32 | the K split's counts (M <= 8) | weights 32 x SQ quads |
//  planes MR x SQ quads | x ring
//  (stages x 2 KB per packing warp) | per warp two packed ranges, each
//  with its alpha part].
// G: a row's 2 KB ranges, one pack task each.  KP = KQ rounded up to even
// (an MMA takes 8 words); stride SQ = KP + 1 quads (odd: the fragment
// loads of 8 rows fall in distinct banks).
struct Smem {
  int alpha, aparts, parts, red, weights, planes, ring, stage, bytes;
  int G, seg, stages, range, sq;  // sq: a warp's stage, in quads
  __host__ __device__ Smem(int W, int MR, int KQ, int S, int C, int Kw,
                           int K, int item) {
    const int KP = (KQ + 1) & ~1;
    const int row = K * item;
    range = kRangeBytes / (32 * item);  // words a task
    G = (Kw + range - 1) / range;
    sq = 2 * (range / 4 + 1);  // two ranges, each with alpha's part
    seg = row % 16 == 0 ? imin(kRangeBytes, row) : 0;  // x rows by TMA
    const int tasks = MR * G;
    const int packers = imin(W, (tasks + C - 1) / C);
    stages = !seg ? 0 : tasks > W * C ? 2 : 1;
    alpha = 16 * W + 32;  // the mbarriers: two x stages a warp, and three
    aparts = alpha + ((MR * 4 + 15) / 16) * 16;
    parts = aparts + 16 * MR * G;
    red = parts + (S > 1 ? 4 * S * MR * kCols : 0);
    weights = red + (MR <= 8 ? (W - 2) * 4 * kCols * 4 : 0);
    planes = weights + 16 * kCols * (KP + 1);
    ring = planes + 16 * MR * (KP + 1);
    stage = ring + packers * stages * seg;
    bytes = stage + 16 * W * sq;
  }
};

template <typename T, int MR, int kWarps>
__global__ void __launch_bounds__(32 * kWarps)
    xnor_linear_kernel(const T* __restrict__ x, const uint32_t* __restrict__ pb,
                       const float* __restrict__ beta, float* __restrict__ out,
                       int M, int K, int Kw, int N, Layout lay, int tma_x,
                       int vec_w) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int S = lay.S, KQ = lay.KQ, CT = lay.CT, C = lay.C;
  const int KP = (KQ + 1) & ~1, SQ = KP + 1;
  constexpr int kThreads = 32 * kWarps;
  const Smem sm(kWarps, MR, KQ, S, C, Kw, K, static_cast<int>(sizeof(T)));
  const int kq = (Kw + 3) / 4;
  float* alpha = reinterpret_cast<float*>(smem + sm.alpha);
  float4* aparts = reinterpret_cast<float4*>(smem + sm.aparts);
  int* parts = reinterpret_cast<int*>(smem + sm.parts);
  uint32_t* wsm = reinterpret_cast<uint32_t*>(smem + sm.weights);
  uint32_t* psm = reinterpret_cast<uint32_t*>(smem + sm.planes);
  const uint32_t bars = smem_u32(smem);
  // two x ring stages a warp, then the weight tile's, the planes', the
  // split's partials'
  const uint32_t wbar = bars + 16 * kWarps, pbar = wbar + 8, sbar = wbar + 16;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rank = blockIdx.x % C;  // rank in the 1-D cluster
  const int s = rank % S, ct = rank / S;
  const int col0 = ((blockIdx.x / C) * CT + ct) * kCols;
  const int cols = max(0, min(kCols, N - col0));
  const int w0 = s * KQ * 4;                   // this slice's first word
  const int words = max(0, min(KQ * 4, Kw - w0));
  const int nq = (words + 3) / 4;              // this slice's quads
  const int row0 = blockIdx.y * MR;
  const int rows = min(MR, M - row0);
  const int gq = lane >> 2, tq = lane & 3;     // MMA fragment coordinates
  const int cbase = 16 * (warp & 1) + gq;      // this thread's columns: cbase
                                               // and cbase + 8

  // -- pack tasks: (row, 2 KB range of it); task t by warp (t / C) % 4 of
  // cluster block t % C, so a row's ranges pack in parallel, each in
  // through a TMA ring when x allows ----------------------------------------
  const int G = sm.G, range = sm.range;
  const int row_bytes = K * static_cast<int>(sizeof(T));
  const int first = rank + C * warp;
  const int tasks = rows * G;
  const int my_tasks =
      first < tasks ? (tasks - first + C * kWarps - 1) / (C * kWarps) : 0;
  const uint32_t xbar = bars + 16 * warp;
  unsigned char* xring = smem + sm.ring + warp * sm.stages * sm.seg;
  auto issue = [&](int i) {  // this warp's task i into stage i % stages
    const int t = first + i * C * kWarps, r = t / G, g = t % G;
    const uint32_t bytes = min(sm.seg, row_bytes - g * sm.seg);
    const uint32_t bar = xbar + 8 * (i % sm.stages);
    mbar_expect_tx(bar, bytes);
    bulk_load(smem_u32(xring + (i % sm.stages) * sm.seg),
              reinterpret_cast<const unsigned char*>(
                  x + static_cast<size_t>(row0 + r) * K) +
                  static_cast<size_t>(g) * sm.seg,
              bytes, bar);
  };
  // the mbarriers: x ring stages, the weight tile, and what the packers
  // will bring (this slice of every row, the rows' alpha parts to each
  // tile's first block) and the split's partials to it
  if (tid == 0) {
    for (int b = 0; b < 2 * kWarps; ++b) mbar_init(bars + 8 * b, 1);
    mbar_init(wbar, 1);
    mbar_init(pbar, 1);
    mbar_init(sbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(pbar, 16u * rows * (nq + (s == 0 ? G : 0)));
    if (S > 1 && s == 0) mbar_expect_tx(sbar, 4u * (S - 1) * rows * kCols);
  }

  // -- zero the words past this slice's end in both operands --------------
  if (nq < KP) {
    const int pad = (KP - nq) * 4, base = nq * 4;
    for (int i = tid; i < kCols * pad; i += kThreads)
      wsm[(i / pad) * SQ * 4 + base + i % pad] = 0u;
    for (int i = tid; i < rows * pad; i += kThreads)
      psm[(i / pad) * SQ * 4 + base + i % pad] = 0u;
  }
  if (!vec_w) {  // words of the last quad past Kw
    for (int i = tid; i < kCols * (nq * 4 - words); i += kThreads)
      wsm[(i / (nq * 4 - words)) * SQ * 4 + words + i % (nq * 4 - words)] = 0u;
  }
  __syncthreads();  // the barriers are initialised, the pads zero
  // (beta is read only now: the release fence above would wait for it)
  const float beta0 = cbase < cols ? beta[col0 + cbase] : 0.f;
  const float beta1 = cbase + 8 < cols ? beta[col0 + cbase + 8] : 0.f;

  if (tma_x && lane == 0)
    for (int i = 0; i < min(sm.stages, my_tasks); ++i) issue(i);

  // -- the weight tile: one 1-D TMA copy per column from the last warp, so
  // no packing warp waits on the memory queues to issue it ---------------
  if (vec_w) {
    if (warp == kWarps - 1) {
      const uint32_t bytes = static_cast<uint32_t>(words) * 4u;
      if (lane == 0) mbar_expect_tx(wbar, bytes * static_cast<uint32_t>(cols));
      __syncwarp();
      if (lane < cols)
        bulk_load(smem_u32(wsm + lane * SQ * 4),
                  pb + static_cast<size_t>(col0 + lane) * Kw + w0, bytes,
                  wbar);
    }
  } else {
    for (int i = tid; i < cols * words; i += kThreads) {
      const int j = i / words, w = i % words;
      cp_async4(smem_u32(wsm + j * SQ * 4 + w),
                  pb + static_cast<size_t>(col0 + j) * Kw + w0 + w);
    }
  }
  cluster_arrive_relaxed();  // this block has started

  // -- pack each task once per cluster.  Alpha's order: within a task each
  // lane adds its elements in sequence from 0, the lanes meet in an xor
  // butterfly; the tile's first block adds the row's tasks in order and
  // divides by K (xnor_gemm.alpha_kernel_order).  Each block whose slice
  // the task overlaps gets those quads, and each tile's first block the
  // task's alpha part, by DSMEM bulk copies onto its mbarrier --------------
  const int pq = range / 4 + 1;  // a range's quads, then alpha's part
  uint4* wstage = reinterpret_cast<uint4*>(smem + sm.stage) + warp * sm.sq;
  for (int i = 0; i < my_tasks; ++i) {
    const int t = first + i * C * kWarps, r = t / G, g = t % G;
    const int wlo = g * range, whi = min(Kw, wlo + range), n = whi - wlo;
    // two stage buffers a warp: task i's copies read one while task i + 1
    // packs into the other
    uint4* my_stage = wstage + (i & 1) * pq;
    uint32_t* stw = reinterpret_cast<uint32_t*>(my_stage);
    const uint32_t stage_u = smem_u32(my_stage);
    if (i > 1) {
      bulk_wait_read<1>();  // task i - 2's copies have read this buffer
      __syncwarp();
    }
    float acc;
    if (tma_x) {
      const int st = i % sm.stages;
      mbar_wait(xbar + 8 * st, (i / sm.stages) & 1);
      acc = pack_range<T, true>(
          reinterpret_cast<const T*>(xring + st * sm.seg), wlo * 32, wlo,
          whi, K, lane, stw);
    } else {
      acc = pack_range<T, false>(x + static_cast<size_t>(row0 + r) * K, 0,
                                 wlo, whi, K, lane, stw);
    }
    if (lane < (4 - n % 4) % 4) stw[n + lane] = 0u;  // to a whole quad
    const float part = xnor::warp_sum(acc);
    if (lane == 0) my_stage[pq - 1] = make_uint4(__float_as_uint(part), 0, 0, 0);
    fence_proxy_async();  // the stage, for the bulk copies
    __syncwarp();
    if (tma_x && lane == 0 && i + sm.stages < my_tasks) issue(i + sm.stages);
    if (i == 0) cluster_wait();  // every block of the cluster has started
    // copies: per tile, one for each slice the task overlaps, then alpha's
    const int q_lo = wlo / 4, q_hi = q_lo + (n + 3) / 4;
    const int sw0 = q_lo / KQ, nsl = (q_hi - 1) / KQ - sw0 + 1;
    for (int k = lane; k < CT * (nsl + 1); k += 32) {
      const int c = k / (nsl + 1), j = k % (nsl + 1);
      if (j < nsl) {
        const int sw = sw0 + j, tk = c * S + sw;
        const int lo = max(q_lo, sw * KQ), hi = min(q_hi, sw * KQ + KQ);
        bulk_push(map_rank(smem_u32(psm + (r * SQ + lo - sw * KQ) * 4), tk),
                  stage_u + 16u * (lo - q_lo), 16u * (hi - lo),
                  map_rank(pbar, tk));
      } else {
        bulk_push(map_rank(smem_u32(aparts + r * G + g), c * S),
                  stage_u + 16u * (pq - 1), 16u, map_rank(pbar, c * S));
      }
    }
    bulk_commit();
  }
  bulk_wait_read<0>();  // before this block may exit
  if (my_tasks == 0) cluster_wait();
  if (!vec_w) {
    cp_async_wait_all();
    __syncthreads();
  }
  mbar_wait(pbar, 0);  // this slice of every row (and alpha's parts)
  if (s == 0 && tid < rows) {
    float total = aparts[tid * G].x;
    for (int g = 1; g < G; ++g) total += aparts[tid * G + g].x;
    alpha[tid] = total / static_cast<float>(K);
  }
  if (vec_w) mbar_wait(wbar, 0);

  // -- XOR + popcount on the tensor cores, transposed: the weight planes
  // are the 16-row operand (16 columns an MMA), the activation planes the
  // 8-wide one (8 rows), so M = 4 wastes half an MMA, not three quarters;
  // popc(a ^ b) = 256 - popc(a & b) - popc(~a & ~b) per 256 bits.  Warp w
  // takes column tile w & 1; with one row tile (M <= 8) the warps of a
  // column tile split the K steps, with four (M = 32) each warp takes a
  // (column tile, row tile) pair ------------------------------------------
  constexpr int NT = MR < 8 ? 1 : MR / 8;        // 8-row tiles
  constexpr int TP = 2 * NT;                     // (column, row) tile pairs
  constexpr int KS = TP >= kWarps ? 1 : kWarps / TP;  // warps a K split
  constexpr int RT = TP >= kWarps ? TP / kWarps : 1;  // row tiles a warp
  const int ctile = warp & 1;
  const int rt0 = KS == 1 ? (warp >> 1) * RT : 0;
  const int kstart = KS == 1 ? 0 : warp >> 1, kstep = KS;
  int acc[RT][2][4];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0;
  const uint32_t* wa = wsm + (16 * ctile + gq) * SQ * 4 + tq;  // columns
  const uint32_t* wb = wa + 8 * SQ * 4;                         // gq, gq + 8
  int steps = 0;
  for (int p = kstart; p < KP / 2; p += kstep, ++steps) {
    uint32_t a[4], na[4];
    a[0] = wa[8 * p];
    a[1] = wb[8 * p];
    a[2] = wa[8 * p + 4];
    a[3] = wb[8 * p + 4];
#pragma unroll
    for (int e = 0; e < 4; ++e) na[e] = ~a[e];
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int r = 8 * (rt0 + i) + gq;
      const uint32_t b0 = r < rows ? psm[r * SQ * 4 + 8 * p + tq] : 0u;
      const uint32_t b1 = r < rows ? psm[r * SQ * 4 + 8 * p + tq + 4] : 0u;
      bmma_and(acc[i][0], a, b0, b1);
      bmma_and(acc[i][1], na, ~b0, ~b1);
    }
  }
  // thread (gq, tq) holds columns 16 * ctile + gq (+ 8) of rows
  // 8 * rt + 2 * tq (+ 1): popc(a ^ b) over this warp's K steps
  int pxor[RT][4];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      pxor[i][e] = 256 * steps - acc[i][0][e] - acc[i][1][e];
  int* red = reinterpret_cast<int*>(smem + sm.red);
  if (KS > 1) {  // the parts of K meet in warps 0 and 1, in order
    if (warp >= 2) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[((warp - 2) * 4 + e) * 32 + lane] = pxor[0][e];
    }
    __syncthreads();
    if (warp < 2) {
      for (int kp = 1; kp < KS; ++kp)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pxor[0][e] += red[(((kp - 1) * 2 + ctile) * 4 + e) * 32 + lane];
    }
  }
  const bool holds = KS == 1 || warp < 2;

  // -- the split's partials meet in the tile's first block, then are added
  // in order ------------------------------------------------------------
  if (S > 1) {
    int* mine = parts + s * MR * kCols;
    if (holds) {
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 8 * (rt0 + i) + 2 * tq + (e & 1);
          const int j = 16 * ctile + gq + (e >> 1) * 8;
          if (r < rows) mine[r * kCols + j] = pxor[i][e];
        }
    }
    if (s != 0) {
      fence_proxy_async();
      __syncthreads();
      if (tid == 0) {
        bulk_push(map_rank(smem_u32(mine), ct * S), smem_u32(mine),
                  4u * rows * kCols, map_rank(sbar, ct * S));
        bulk_commit();
        bulk_wait_read<0>();
      }
      return;
    }
    __syncthreads();
    mbar_wait(sbar, 0);
  } else {
    __syncthreads();  // alpha
  }
  if (!holds) return;
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 8 * (rt0 + i) + 2 * tq + (e & 1);
      const int j = 16 * ctile + gq + (e >> 1) * 8;
      if (r < rows && j < cols) {
        int p = pxor[i][e];
        if (S > 1) {
          p = parts[r * kCols + j];
          for (int t = 1; t < S; ++t) p += parts[(t * MR + r) * kCols + j];
        }
        out[static_cast<size_t>(row0 + r) * N + col0 + j] =
            static_cast<float>(K - 2 * p) * alpha[r] *
            (e >> 1 ? beta1 : beta0);
      }
    }
}

template <typename T, int MR, int W>
int launch(const void* x, const void* pb, const void* beta, void* out, int M,
           int K, int Kw, int N, Layout lay, cudaStream_t s) {
  const Smem sm(W, MR, lay.KQ, lay.S, lay.C, Kw, K,
                static_cast<int>(sizeof(T)));
  auto kernel = xnor_linear_kernel<T, MR, W>;
  if (sm.bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sm.bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int tma_x = sm.seg > 0 && xnor::aligned16(x);
  const int vec_w = Kw % 4 == 0 && xnor::aligned16(pb);
  const int tiles = (N + kCols - 1) / kCols;
  const int groups = (tiles + lay.CT - 1) / lay.CT;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(groups * lay.C, (M + MR - 1) / MR, 1);
  cfg.blockDim = dim3(32 * W, 1, 1);
  cfg.dynamicSmemBytes = sm.bytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = lay.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(x), static_cast<const uint32_t*>(pb),
      static_cast<const float*>(beta), static_cast<float*>(out), M, K, Kw, N,
      lay, tma_x, vec_w);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int W>
int dispatch_rows(const void* x, const void* pb, const void* beta, void* out,
                  int M, int K, int Kw, int N, int rows, Layout lay,
                  cudaStream_t s) {
  switch (rows) {
    case 4:
      return launch<T, 4, W>(x, pb, beta, out, M, K, Kw, N, lay, s);
    case 8:
      return launch<T, 8, W>(x, pb, beta, out, M, K, Kw, N, lay, s);
    case 32:
      return launch<T, 32, W>(x, pb, beta, out, M, K, Kw, N, lay, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch(const void* x, const void* pb, const void* beta, void* out,
             int M, int K, int Kw, int N, int rows, int warps, Layout lay,
             cudaStream_t s) {
  switch (warps) {
    case 4:
      return dispatch_rows<T, 4>(x, pb, beta, out, M, K, Kw, N, rows, lay, s);
    case 8:
      return dispatch_rows<T, 8>(x, pb, beta, out, M, K, Kw, N, rows, lay, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// rows: activation rows a pass (4, 8 or 32); warps: warps a block (4 or
// 8); split: blocks sharing a column tile's K; kq_slice: 16-byte quads of
// K a block; cluster_tiles: column tiles a cluster
// (kernels/xnor_gemm.py::linear_plan).
extern "C" int xnor_linear_fused(const void* x, int dtype, const void* pb,
                                 const void* beta, void* out, int M, int K,
                                 int Kw, int N, int rows, int warps,
                                 int split, int kq_slice, int cluster_tiles,
                                 void* stream) {
  if (M <= 0 || N <= 0) return 0;
  const int kq = (Kw + 3) / 4;
  Layout lay{split, kq_slice, cluster_tiles, split * cluster_tiles};
  if (split < 1 || kq_slice < 1 || cluster_tiles < 1 ||
      lay.C > kMaxCluster || (split - 1) * kq_slice >= kq ||
      split * kq_slice < kq)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case xnor::kF32:
      return dispatch<float>(x, pb, beta, out, M, K, Kw, N, rows, warps, lay,
                             s);
    case xnor::kBF16:
      return dispatch<__nv_bfloat16>(x, pb, beta, out, M, K, Kw, N, rows,
                                     warps, lay, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
