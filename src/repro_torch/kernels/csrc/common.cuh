// Shared device helpers for the port's Hopper kernels (sm_90a).
//
// Every kernel library is built from one .cu file with a plain C interface
// and loaded with ctypes (kernels/cuda.py).  Each C entry point launches on
// the stream it is given and returns cudaGetLastError(); the Python wrapper
// raises on any non-zero code.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace xnor {

// dtype codes shared with kernels/cuda.py::DTYPE_CODES
enum DType : int { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(int8_t v) {
  return static_cast<float>(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Blocks for a grid-stride loop over `items` work items, `threads` per
// block: enough for 8 resident blocks on every SM of the current device,
// and no more than the items need.
inline int stream_blocks(long long items, int threads) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (sms <= 0) sms = 132;
  const long long need = (items + threads - 1) / threads;
  const long long cap = 8LL * sms;
  return static_cast<int>(need < 1 ? 1 : (need < cap ? need : cap));
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Pack one row of a matrix into LSB-first sign words dst[0, Kw) (elements
// past K count as 0.0, bit 1) and return this lane's share of sum|x|; one
// warp per row.  VEC: K is a multiple of 32 * (16 / sizeof(T)) and the row is
// 16-byte aligned.
template <typename T, bool VEC>
__device__ __forceinline__ float pack_row(const T* __restrict__ xr, int K,
                                          int Kw, uint32_t* dst, int lane) {
  float acc = 0.f;
  if constexpr (VEC) {
    constexpr int E = 16 / sizeof(T);  // elements per lane per load
    constexpr int L = 32 / E;          // lanes per word
    const int nchunks = K / (32 * E);
    const uint4* src = reinterpret_cast<const uint4*>(xr);
#pragma unroll 4
    for (int c = 0; c < nchunks; ++c) {
      const uint4 raw = src[c * 32 + lane];
      const T* v = reinterpret_cast<const T*>(&raw);
      uint32_t bits = 0;
#pragma unroll
      for (int i = 0; i < E; ++i) {
        const float f = to_f32(v[i]);
        bits |= static_cast<uint32_t>(f >= 0.f) << i;
        acc += fabsf(f);
      }
#pragma unroll
      for (int s = 1; s < L; s <<= 1)
        bits |= __shfl_down_sync(0xffffffffu, bits, s) << (E * s);
      if (lane % L == 0) dst[c * E + lane / L] = bits;
    }
  } else {
    for (int w = 0; w < Kw; ++w) {
      const int k = w * 32 + lane;
      const float v = k < K ? to_f32(xr[k]) : 0.f;
      const uint32_t bits = __ballot_sync(0xffffffffu, v >= 0.f);
      if (lane == 0) dst[w] = bits;
      acc += fabsf(v);
    }
  }
  return acc;
}

}  // namespace xnor
