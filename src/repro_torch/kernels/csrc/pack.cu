// Fused sign-extract + bit-pack + alpha on Hopper.
//
// Replaces: src/repro/kernels/pack.py::pack (the pl.pallas_call at
// pack.py:45), reached from ops.binarize when lm.pack_params packs every
// binarized linear at load.
//
// Computes, for an (M, K) f32/bf16 matrix: (M, ceil(K/32)) uint32 sign
// planes, LSB-first, bit = 1 <=> x >= 0 (-0.0 -> 1, NaN -> 0), and
// alpha = mean|x| per row over the true K, in one read of x.  Elements
// past K pack as 0.0, i.e. bit 1, which is what bitpack.pad_to_word gives.
//
// Bound on this card: bytes.  It reads M*K elements once and writes
// M*K/32 words + M floats; a compare and an abs per element are nothing
// next to 3.35 TB/s.  Design: one warp per row, kWarps rows per block.
// Where K is a multiple of 32 * (16 / itemsize) and rows are 16-byte
// aligned, each lane loads 16 bytes at a time (coalesced 512-byte warp
// reads), folds its elements' sign bits into a byte or nibble, and
// shuffles merge those into LSB-first words (xnor::pack_row); otherwise
// lane j loads element 32*w + j and __ballot_sync(v >= 0) is the word.
// |x| accumulates per lane and a warp reduction gives alpha, so the sum
// order is fixed and alpha is deterministic.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;

template <typename T, bool VEC>
__global__ void __launch_bounds__(kWarps * 32)
    pack_kernel(const T* __restrict__ x, uint32_t* __restrict__ planes,
                float* __restrict__ alpha, int M, int K, int Kw) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;  // whole warp leaves together
  const float acc = xnor::pack_row<T, VEC>(
      x + static_cast<size_t>(row) * K, K, Kw,
      planes + static_cast<size_t>(row) * Kw, lane);
  const float total = xnor::warp_sum(acc);
  if (lane == 0) alpha[row] = total / static_cast<float>(K);
}

template <typename T>
int launch(const void* x, void* planes, void* alpha, int M, int K, int Kw,
           cudaStream_t s) {
  const dim3 grid((M + kWarps - 1) / kWarps);
  constexpr int chunk = 32 * (16 / static_cast<int>(sizeof(T)));
  const bool vec =
      K % chunk == 0 && (reinterpret_cast<uintptr_t>(x) & 15u) == 0;
  if (vec) {
    pack_kernel<T, true><<<grid, kWarps * 32, 0, s>>>(
        static_cast<const T*>(x), static_cast<uint32_t*>(planes),
        static_cast<float*>(alpha), M, K, Kw);
  } else {
    pack_kernel<T, false><<<grid, kWarps * 32, 0, s>>>(
        static_cast<const T*>(x), static_cast<uint32_t*>(planes),
        static_cast<float*>(alpha), M, K, Kw);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int xnor_pack(const void* x, int dtype, void* planes, void* alpha,
                         int M, int K, int Kw, void* stream) {
  if (M <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case xnor::kF32:
      return launch<float>(x, planes, alpha, M, K, Kw, s);
    case xnor::kBF16:
      return launch<__nv_bfloat16>(x, planes, alpha, M, K, Kw, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
