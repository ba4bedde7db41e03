// Packed XNOR-popcount GEMM on Hopper.
//
// Replaces: src/repro/kernels/xnor_gemm.py::xnor_gemm (the pl.pallas_call
// at xnor_gemm.py:80), reached from ops.xnor_matmul: the packed
// core/xnor_layers.py::xnor_linear (the XNOR-CNN classifier's binary
// layer) and the unfused chain of xnor_linear_prepacked.
//
// Computes out[m, n] = valid_k - 2 * popc(pa[m] XOR pb[n]) as int32, over
// the true Kw words of the (M, Kw) and (N, Kw) uint32 planes.  Padding
// bits past valid_k agree in both operands (zero pads pack to 1), so they
// XOR to 0 and no host-side pad copy or kpad - valid_k correction is
// needed; ragged M, N and Kw are masked here.
//
// Bound on this card: bytes.  At decode (M <= 8) the weight planes are
// the traffic, 8.5 MB for the (18944, 112-word) up-projection, 2.5 us at
// 3.35 TB/s.  At M >= 16 the popcounts would bound a CUDA-core kernel:
// M * N * Kw of them, 68 M at a prefill chunk (M = 32) of the same shape,
// 18 us at 16 an SM a clock; the tensor cores take them instead.
//
// Design: one shape for every M, with nothing staged and nothing waited
// on before the weights are asked for.
// - XOR-popcount on the tensor cores: popc(a ^ b) = 256 - popc(a & b) -
//   popc(~a & ~b) per 256 bits, two mma.m16n8k256 .b1 AND.POPC (ptxas
//   runs XOR.POPC as AND plus CUDA-core popcounts).  The weight planes are
//   the 16-row operand (16 columns a warp), the activation planes the
//   8-wide one (8 rows an n-tile); a warp takes NT n-tiles, so each weight
//   fragment is read once per block for all its rows (M <= 64), and the
//   MMA itself sums across lanes: no shuffle reductions.
// - Operands straight from global memory into the fragments, 16 bytes a
//   lane.  The dot is a sum over K, so K may be visited in any order both
//   operands share: lane (g, t) of a 16-word step loads words 4t..4t+3 of
//   weight columns g and g + 8 and of activation row g, and the step's two
//   MMAs take words (4t, 4t + 1) and (4t + 2, 4t + 3) as their k-slots t
//   and t + 4.  U steps of loads are issued before the first MMA: 2U
//   16-byte weight loads in flight a lane.  The activation planes are
//   small and shared by every block: they come from L1 and L2.
// - Shapes (xnor_gemm.py::gemm_plan mirrors gemm_plan below): a block is
//   4 warps, or KS when K splits 8 or 16 ways; KS warps split K (steps
//   taken round robin) when the column tiles alone would leave the card
//   short of 16 warps an SM (32 at one n-tile a warp), and add their
//   counts through shared memory; the grid is one dimension, (row tile,
//   column block) with columns fastest, so M and N are bounded only by
//   2^31 blocks.
// - Ragged edges: columns past N and rows past M load as 0 and are not
//   stored; words past Kw load as 0 in both operands (XOR 0).  Planes not
//   16-byte aligned, or Kw % 4 != 0, take one-word loads (same mapping).
#include "common.cuh"

namespace {

constexpr int kTargetWarps = 132 * 16;  // warps that keep the card's
                                        // memory queues full (32 an SM
                                        // at one n-tile a warp)

struct Plan {
  int nt;          // 8-row n-tiles a warp: 1, 2, 4 or 8
  int ks;          // warps splitting K: 1, 2, 4, 8 or 16 (at nt = 1)
  int ct;          // 16-column tiles a block
  int row_tiles;   // ceil(M / (8 nt))
  int col_blocks;  // ceil(ceil(N / 16) / ct)
};

Plan gemm_plan(int M, int N, int Kw) {
  Plan p;
  p.nt = M <= 8 ? 1 : M <= 16 ? 2 : M <= 32 ? 4 : 8;
  p.row_tiles = (M + 8 * p.nt - 1) / (8 * p.nt);
  const long long tiles = (N + 15) / 16;
  const int steps = (Kw + 15) / 16;
  const long long tasks = tiles * p.row_tiles;
  // a warp of one n-tile holds few bytes in flight: twice the warps, up
  // to 16 a block
  const long long target = p.nt == 1 ? 2 * kTargetWarps : kTargetWarps;
  const int max_ks = p.nt == 1 ? 16 : 8;
  p.ks = 1;
  while (p.ks < max_ks && 2 * p.ks <= steps && tasks * 2 * p.ks <= target)
    p.ks *= 2;
  p.ct = p.ks >= 4 ? 1 : 4 / p.ks;
  p.col_blocks = static_cast<int>((tiles + p.ct - 1) / p.ct);
  return p;
}

// d += popc(a AND b) over 256 bits on the tensor cores: a 16 x 256-bit tile
// (a, row-major) against an 8 x 256-bit one (b0, b1, column-major), in the
// PTX fragment layout of mma.m16n8k256 .b1.
__device__ __forceinline__ void bmma_and(int (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Words w .. w + 3 of a plane row (0 where the row is dead or past Kw).
// VEC: one 16-byte load (the row is 16-byte aligned and Kw % 4 == 0, so a
// quad is all inside Kw or all past it).
template <bool VEC>
__device__ __forceinline__ uint4 load_quad(const uint32_t* __restrict__ row,
                                           bool live, int w, int Kw) {
  if constexpr (VEC) {
    if (live && w < Kw) return __ldg(reinterpret_cast<const uint4*>(row + w));
    return make_uint4(0u, 0u, 0u, 0u);
  } else {
    uint4 q;
    q.x = live && w < Kw ? __ldg(row + w) : 0u;
    q.y = live && w + 1 < Kw ? __ldg(row + w + 1) : 0u;
    q.z = live && w + 2 < Kw ? __ldg(row + w + 2) : 0u;
    q.w = live && w + 3 < Kw ? __ldg(row + w + 3) : 0u;
    return q;
  }
}

// Both MMAs of one 16-word step for one n-tile: AND and NAND counts.
__device__ __forceinline__ void step_mma(int (&dand)[4], int (&dnand)[4],
                                         const uint4& wa, const uint4& wb,
                                         const uint4& x) {
  bmma_and(dand, wa.x, wb.x, wa.y, wb.y, x.x, x.y);
  bmma_and(dand, wa.z, wb.z, wa.w, wb.w, x.z, x.w);
  bmma_and(dnand, ~wa.x, ~wb.x, ~wa.y, ~wb.y, ~x.x, ~x.y);
  bmma_and(dnand, ~wa.z, ~wb.z, ~wa.w, ~wb.w, ~x.z, ~x.w);
}

template <int NT, int U, bool VEC>
__global__ void __launch_bounds__(512)
    xnor_gemm_kernel(const uint32_t* __restrict__ pa,
                     const uint32_t* __restrict__ pb, int32_t* __restrict__ out,
                     int M, int N, int Kw, int valid_k, int ks, int ct,
                     int col_blocks) {
  extern __shared__ int red[];  // [ks - 1][ct][NT * 4][32]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;  // MMA fragment coordinates
  const int kslice = warp / ct, ctile = warp % ct;
  const int cb = blockIdx.x % col_blocks;
  const long long row0 = static_cast<long long>(blockIdx.x / col_blocks) *
                         (8 * NT);
  const int col0 = (cb * ct + ctile) * 16;

  // this lane's rows: weight columns col0 + gq (+ 8), activation rows
  // row0 + 8 t + gq
  const bool live_a = col0 + gq < N, live_b = col0 + gq + 8 < N;
  const uint32_t* wa_row = pb + static_cast<size_t>(live_a ? col0 + gq : 0) * Kw;
  const uint32_t* wb_row =
      pb + static_cast<size_t>(live_b ? col0 + gq + 8 : 0) * Kw;
  const uint32_t* x_row[NT];
  bool live_x[NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const long long r = row0 + 8 * t + gq;
    live_x[t] = r < M;
    x_row[t] = pa + static_cast<size_t>(live_x[t] ? r : 0) * Kw;
  }

  int dand[NT][4], dnand[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) dand[t][e] = dnand[t][e] = 0;

  const int steps = (Kw + 15) / 16;
  int done = 0;  // steps this warp ran (uniform across the warp)
  for (int s0 = kslice; s0 < steps; s0 += U * ks) {
    uint4 wa[U], wb[U], x[U][NT];
#pragma unroll
    for (int u = 0; u < U; ++u) {  // every load first: 2U weight quads
      const int s = s0 + u * ks;
      const int w = 16 * s + 4 * tq;
      const bool in = s < steps;
      wa[u] = load_quad<VEC>(wa_row, live_a && in, w, Kw);
      wb[u] = load_quad<VEC>(wb_row, live_b && in, w, Kw);
#pragma unroll
      for (int t = 0; t < NT; ++t)
        x[u][t] = load_quad<VEC>(x_row[t], live_x[t] && in, w, Kw);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (s0 + u * ks < steps) {  // uniform across the warp
        ++done;
#pragma unroll
        for (int t = 0; t < NT; ++t)
          step_mma(dand[t], dnand[t], wa[u], wb[u], x[u][t]);
      }
    }
  }

  // popc(a ^ b) over this warp's steps: 512 bits a step, 0 on the words
  // loaded as 0 in both operands
  int pxor[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      pxor[t][e] = 512 * done - dand[t][e] - dnand[t][e];

  if (ks > 1) {  // the K slices meet in slice 0's warps
    if (kslice > 0) {
      int* mine = red + ((kslice - 1) * ct + ctile) * NT * 4 * 32;
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) mine[(t * 4 + e) * 32 + lane] = pxor[t][e];
    }
    __syncthreads();
    if (kslice > 0) return;
    for (int k = 1; k < ks; ++k) {
      const int* part = red + ((k - 1) * ct + ctile) * NT * 4 * 32;
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) pxor[t][e] += part[(t * 4 + e) * 32 + lane];
    }
  }

  // thread (gq, tq) holds weight columns gq (e < 2) and gq + 8 (e >= 2)
  // of activation rows 2 tq and 2 tq + 1 of each n-tile
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long long r = row0 + 8 * t + 2 * tq + (e & 1);
      const int n = col0 + gq + 8 * (e >> 1);
      if (r < M && n < N)
        out[static_cast<size_t>(r) * N + n] = valid_k - 2 * pxor[t][e];
    }
}

template <int NT, int U, bool VEC>
int launch_plan(const uint32_t* pa, const uint32_t* pb, int32_t* out, int M,
                int N, int Kw, int valid_k, const Plan& p, cudaStream_t s) {
  const long long blocks =
      static_cast<long long>(p.row_tiles) * p.col_blocks;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 32 * p.ct * p.ks;
  const size_t smem =
      static_cast<size_t>(p.ks - 1) * p.ct * NT * 4 * 32 * sizeof(int);
  xnor_gemm_kernel<NT, U, VEC><<<static_cast<unsigned>(blocks), threads,
                                    smem, s>>>(pa, pb, out, M, N, Kw, valid_k,
                                               p.ks, p.ct, p.col_blocks);
  return static_cast<int>(cudaGetLastError());
}

// U: steps of loads issued before the first MMA.  At NT = 1 two steps
// (four 16-byte weight loads a lane) with twice the warps measured faster
// than four steps (probes on the card, PERF.md); as NT grows U shrinks, to
// keep the loads' registers near 48 a thread.
template <bool VEC>
int launch_nt(const uint32_t* pa, const uint32_t* pb, int32_t* out, int M,
              int N, int Kw, int valid_k, const Plan& p, cudaStream_t s) {
  switch (p.nt) {
    case 1:
      return launch_plan<1, 2, VEC>(pa, pb, out, M, N, Kw, valid_k, p, s);
    case 2:
      return launch_plan<2, 3, VEC>(pa, pb, out, M, N, Kw, valid_k, p, s);
    case 4:
      return launch_plan<4, 2, VEC>(pa, pb, out, M, N, Kw, valid_k, p, s);
    case 8:
      return launch_plan<8, 1, VEC>(pa, pb, out, M, N, Kw, valid_k, p, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int xnor_gemm(const void* pa, const void* pb, void* out, int M,
                         int N, int Kw, int valid_k, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* a = static_cast<const uint32_t*>(pa);
  const uint32_t* b = static_cast<const uint32_t*>(pb);
  int32_t* o = static_cast<int32_t*>(out);
  const Plan p = gemm_plan(M, N, Kw);
  if (Kw % 4 == 0 && xnor::aligned16(a) && xnor::aligned16(b))
    return launch_nt<true>(a, b, o, M, N, Kw, valid_k, p, s);
  return launch_nt<false>(a, b, o, M, N, Kw, valid_k, p, s);
}

// The plan gemm_plan gives (M, N, Kw): {nt, ks, ct, row_tiles, col_blocks}
// into plan[0..4], for holding xnor_gemm.py::gemm_plan to it.
extern "C" int xnor_gemm_plan(int M, int N, int Kw, int* plan) {
  const Plan p = gemm_plan(M, N, Kw);
  plan[0] = p.nt;
  plan[1] = p.ks;
  plan[2] = p.ct;
  plan[3] = p.row_tiles;
  plan[4] = p.col_blocks;
  return 0;
}
