// Fused prepacked XNOR linear on Hopper: binarize + popcount GEMM +
// alpha/beta epilogue in one launch.
//
// Replaces: src/repro/kernels/xnor_gemm.py::xnor_linear_fused (the
// pl.pallas_call at xnor_gemm.py:150), reached from every binarized linear
// (core/xnor_layers.py::xnor_linear_prepacked) in prefill and decode.
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
// traffic: N*Kw*4 bytes, e.g. 8.5 MB for the (18944, 3584) up-projection,
// 2.5 us at 3.35 TB/s; the 2*M*N*K bit-operations are far below any
// integer peak.  Design: a block owns kRows activation rows and kCols
// output columns.  It first packs its rows into shared memory (one warp
// per row; 16-byte loads, each lane's sign bits merged into words with
// shuffles; alpha from a warp reduction), so the packed activations and
// the integer dots never touch device memory.  Then each warp takes
// kColsPerWarp columns at once: per step every lane loads 16 bytes (four
// words) of each of its columns — coalesced 512-byte reads of pb, all of
// them in flight together — and accumulates __popc(a ^ b) against the
// shared planes for every row; a warp reduction per (column, row) gives
// the dots.  Each weight word is read once per row tile.  Shapes that are
// not 16-byte multiples (ragged K) take one-word loads and per-word
// ballots.  Not yet: cp.async/TMA pipelining of pb, a split over K for
// narrow N, sharing the packed activations between blocks.
#include "common.cuh"

namespace {

constexpr int kRows = 8;    // activation rows per block (one packing warp each)
constexpr int kWarps = 8;   // 256 threads
constexpr int kColsPerWarp = 4;
constexpr int kCols = kWarps * kColsPerWarp;  // output columns per block

template <int NV>
__device__ __forceinline__ void load_words(const uint32_t* p,
                                           uint32_t (&w)[NV]) {
  if constexpr (NV == 4) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  } else {
    w[0] = *p;
  }
}

template <typename T, bool VEC_X, int NV>
__global__ void __launch_bounds__(kWarps * 32)
    xnor_linear_kernel(const T* __restrict__ x, const uint32_t* __restrict__ pb,
                       const float* __restrict__ beta, float* __restrict__ out,
                       int M, int K, int Kw, int N) {
  extern __shared__ __align__(16) uint32_t planes[];  // [kRows][Kw]
  __shared__ float alpha[kRows];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = blockIdx.y * kRows;
  const int col0 = blockIdx.x * kCols;
  const int rows = min(kRows, M - row0);

  // phase 1: pack this block's activation rows (kRows == kWarps)
  if (warp < rows) {
    const float acc = xnor::pack_row<T, VEC_X>(
        x + static_cast<size_t>(row0 + warp) * K, K, Kw, planes + warp * Kw,
        lane);
    const float total = xnor::warp_sum(acc);
    if (lane == 0) alpha[warp] = total / static_cast<float>(K);
  }
  __syncthreads();

  // phase 2: kColsPerWarp columns per warp, NV words per lane per load
  const int cbase = col0 + warp * kColsPerWarp;
  int acc[kColsPerWarp][kRows];
#pragma unroll
  for (int j = 0; j < kColsPerWarp; ++j)
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[j][r] = 0;
  const int nv = Kw / NV;
  for (int v = lane; v < nv; v += 32) {
    uint32_t b[kColsPerWarp][NV];
#pragma unroll
    for (int j = 0; j < kColsPerWarp; ++j) {
      if (cbase + j < N) {
        load_words<NV>(pb + static_cast<size_t>(cbase + j) * Kw + v * NV,
                       b[j]);
      } else {
#pragma unroll
        for (int q = 0; q < NV; ++q) b[j][q] = 0u;
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < rows) {  // uniform across the block
        uint32_t a[NV];
        load_words<NV>(planes + r * Kw + v * NV, a);
#pragma unroll
        for (int j = 0; j < kColsPerWarp; ++j)
#pragma unroll
          for (int q = 0; q < NV; ++q) acc[j][r] += __popc(a[q] ^ b[j][q]);
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kColsPerWarp; ++j) {
    const int n = cbase + j;
    int mine = 0;  // lane r keeps row r's total
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < rows) {
        const int t = xnor::warp_sum(acc[j][r]);
        if (lane == r) mine = t;
      }
    }
    if (n < N && lane < rows) {
      const float dots = static_cast<float>(K - 2 * mine);
      out[static_cast<size_t>(row0 + lane) * N + n] =
          dots * alpha[lane] * beta[n];
    }
  }
}

template <typename T, bool VEC_X, int NV>
int launch(const void* x, const void* pb, const void* beta, void* out, int M,
           int K, int Kw, int N, cudaStream_t s) {
  const size_t smem = static_cast<size_t>(kRows) * Kw * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        xnor_linear_kernel<T, VEC_X, NV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((N + kCols - 1) / kCols, (M + kRows - 1) / kRows);
  xnor_linear_kernel<T, VEC_X, NV><<<grid, kWarps * 32, smem, s>>>(
      static_cast<const T*>(x), static_cast<const uint32_t*>(pb),
      static_cast<const float*>(beta), static_cast<float*>(out), M, K, Kw, N);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T>
int dispatch(const void* x, const void* pb, const void* beta, void* out,
             int M, int K, int Kw, int N, cudaStream_t s) {
  constexpr int chunk = 32 * (16 / static_cast<int>(sizeof(T)));
  const bool vec_x = K % chunk == 0 && aligned16(x);
  const bool vec_w = Kw % 4 == 0 && aligned16(pb);
  if (vec_x && vec_w) return launch<T, true, 4>(x, pb, beta, out, M, K, Kw, N, s);
  if (vec_x) return launch<T, true, 1>(x, pb, beta, out, M, K, Kw, N, s);
  if (vec_w) return launch<T, false, 4>(x, pb, beta, out, M, K, Kw, N, s);
  return launch<T, false, 1>(x, pb, beta, out, M, K, Kw, N, s);
}

}  // namespace

extern "C" int xnor_linear_fused(const void* x, int dtype, const void* pb,
                                 const void* beta, void* out, int M, int K,
                                 int Kw, int N, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case xnor::kF32:
      return dispatch<float>(x, pb, beta, out, M, K, Kw, N, s);
    case xnor::kBF16:
      return dispatch<__nv_bfloat16>(x, pb, beta, out, M, K, Kw, N, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
