// Bulk XOR / XNOR of two word buffers on Hopper.
//
// Replaces: src/repro/kernels/bulk.py::bulk_xor (the pl.pallas_call at
// bulk.py:39), reached from ops.bulk_op: CimEngine.xor / xnor /
// verify_copy and their chunked *_stream modes.
//
// Computes out[i] = a[i] ^ b[i], or ~(a[i] ^ b[i]) with invert (the
// complementary rail), for i < n words.  n is any length: there is no
// padding to (R, 128) tiles; the ragged tail is the loop's own bound.
//
// Bound on this card: bytes.  Two reads and one write, 12 bytes a word —
// a 3.8 GB leaf (950 M words) moves 11.4 GB, 3.4 ms at 3.35 TB/s; one
// logic op per word is nothing beside that.  Design: a grid-stride loop
// sized to keep 8 blocks on every SM; when all three pointers are 16-byte
// aligned each lane moves four words per step with 16-byte loads and
// stores (a warp reads 512 contiguous bytes of each operand), and the
// first n % 4 threads of the grid take the scalar tail; otherwise one
// word per lane per step.  No shared memory, no reduction.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <bool INVERT>
__device__ __forceinline__ uint32_t op(uint32_t x, uint32_t y) {
  return INVERT ? ~(x ^ y) : (x ^ y);
}

template <bool INVERT, bool VEC>
__global__ void __launch_bounds__(kThreads)
    bulk_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                uint32_t* __restrict__ out, long long n) {
  const long long tid =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  if constexpr (VEC) {
    const long long n4 = n >> 2;
    const uint4* a4 = reinterpret_cast<const uint4*>(a);
    const uint4* b4 = reinterpret_cast<const uint4*>(b);
    uint4* o4 = reinterpret_cast<uint4*>(out);
    for (long long i = tid; i < n4; i += stride) {
      const uint4 x = a4[i];
      const uint4 y = b4[i];
      o4[i] = make_uint4(op<INVERT>(x.x, y.x), op<INVERT>(x.y, y.y),
                         op<INVERT>(x.z, y.z), op<INVERT>(x.w, y.w));
    }
    const long long t = (n4 << 2) + tid;  // the n % 4 tail words
    if (t < n) out[t] = op<INVERT>(a[t], b[t]);
  } else {
    for (long long i = tid; i < n; i += stride) out[i] = op<INVERT>(a[i], b[i]);
  }
}

template <bool INVERT>
int launch(const uint32_t* a, const uint32_t* b, uint32_t* out, long long n,
           cudaStream_t s) {
  if (xnor::aligned16(a) && xnor::aligned16(b) && xnor::aligned16(out)) {
    const int grid = xnor::stream_blocks(n >> 2, kThreads);
    bulk_kernel<INVERT, true><<<grid, kThreads, 0, s>>>(a, b, out, n);
  } else {
    const int grid = xnor::stream_blocks(n, kThreads);
    bulk_kernel<INVERT, false><<<grid, kThreads, 0, s>>>(a, b, out, n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int bulk_xor(const void* a, const void* b, void* out, long long n,
                        int invert, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* pa = static_cast<const uint32_t*>(a);
  const uint32_t* pb = static_cast<const uint32_t*>(b);
  uint32_t* po = static_cast<uint32_t*>(out);
  return invert ? launch<true>(pa, pb, po, n, s)
                : launch<false>(pa, pb, po, n, s);
}
