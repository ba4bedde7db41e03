// The first design of the packed XNOR-popcount GEMM, kept only as the
// yardstick that chip_smoke.py times the current kernel (xnor_gemm.cu)
// against in the same run.  It is not part of the port's build
// (kernels/cuda.py SOURCES) and no wrapper calls it.
//
// Same C entry point and contract as xnor_gemm.cu: out[m, n] = valid_k -
// 2 * popc(pa[m] XOR pb[n]) as int32 over the true Kw words; ragged M, N
// and Kw masked here.  Design: a block owns 8 activation rows and 32
// output columns and first copies its rows' planes into shared memory;
// each warp then takes 4 columns at once, every lane loading 16 bytes of
// each column a step and adding __popc(a ^ b) against the staged planes
// for every row, and a warp reduction per (column, row) gives the dot.
// Each weight word is read once per 8-row tile.  It takes Kw <= 7264
// (the planes' shared memory) and M <= 524280 (grid.y).
#include "common.cuh"

namespace {

constexpr int kRows = 8;
constexpr int kWarps = 8;  // 256 threads
constexpr int kColsPerWarp = 4;
constexpr int kCols = kWarps * kColsPerWarp;  // output columns per block
constexpr int kMaxSmem = 227 * 1024;

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

template <int NV>
__global__ void __launch_bounds__(kWarps * 32)
    xnor_gemm_kernel(const uint32_t* __restrict__ pa,
                     const uint32_t* __restrict__ pb, int32_t* __restrict__ out,
                     int M, int N, int Kw, int valid_k) {
  extern __shared__ __align__(16) uint32_t planes[];  // [kRows][Kw]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = blockIdx.y * kRows;
  const int col0 = blockIdx.x * kCols;
  const int rows = min(kRows, M - row0);

  // stage this block's activation planes (rows are contiguous in pa)
  const uint32_t* src = pa + static_cast<size_t>(row0) * Kw;
  const int total = rows * Kw / NV;
  for (int i = threadIdx.x; i < total; i += kWarps * 32) {
    if constexpr (NV == 4) {
      reinterpret_cast<uint4*>(planes)[i] =
          reinterpret_cast<const uint4*>(src)[i];
    } else {
      planes[i] = src[i];
    }
  }
  __syncthreads();

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
    if (n < N && lane < rows)
      out[static_cast<size_t>(row0 + lane) * N + n] = valid_k - 2 * mine;
  }
}

template <int NV>
int launch(const uint32_t* pa, const uint32_t* pb, int32_t* out, int M, int N,
           int Kw, int valid_k, cudaStream_t s) {
  const size_t smem = static_cast<size_t>(kRows) * Kw * sizeof(uint32_t);
  if (smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        xnor_gemm_kernel<NV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((N + kCols - 1) / kCols, (M + kRows - 1) / kRows);
  xnor_gemm_kernel<NV><<<grid, kWarps * 32, smem, s>>>(pa, pb, out, M, N, Kw,
                                                       valid_k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int xnor_gemm(const void* pa, const void* pb, void* out, int M,
                         int N, int Kw, int valid_k, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if ((M + kRows - 1) / kRows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* a = static_cast<const uint32_t*>(pa);
  const uint32_t* b = static_cast<const uint32_t*>(pb);
  int32_t* o = static_cast<int32_t*>(out);
  if (Kw % 4 == 0 && xnor::aligned16(a) && xnor::aligned16(b))
    return launch<4>(a, b, o, M, N, Kw, valid_k, s);
  return launch<1>(a, b, o, M, N, Kw, valid_k, s);
}
