// Bulk XOR / XNOR of two word buffers on Hopper.
//
// Replaces: src/repro/kernels/bulk.py::bulk_xor (the pl.pallas_call at
// bulk.py:39), reached from ops.bulk_op: CimEngine.xor / xnor /
// verify_copy and their chunked *_stream modes.
//
// Computes out[i] = a[i] ^ b[i], or ~(a[i] ^ b[i]) with invert (the
// complementary rail), for i < n words.  n is any length: there is no
// padding to (R, 128) tiles; ragged ends are masked in the kernel.
//
// Bound on this card: bytes.  Two reads and one write, 12 bytes a word —
// the 719 MB layer-stacked wq leaf (179.8 M words) moves 2.16 GB, 0.644 ms
// at 3.35 TB/s; one logic op per word is nothing beside that.  Design:
// one 16-byte quad of each operand per thread and a grid sized to the
// work, as PyTorch's elementwise kernels do — no grid-stride loop.  Timed
// against variant builds at that leaf (PERF.md, PR 15): a grid-stride
// loop over 8 blocks an SM (this kernel's first design) or 4 reached
// 87-89 % of the byte bound, one chunk a block 91-93 %, and of those one
// quad a thread with plain loads and stores was the fastest; more quads in
// flight a thread, or streaming cache hints, did not help.  When a, b and
// out share their offset mod 16 bytes, the words before the first 16-byte
// boundary are peeled off and the rest takes the quad path (the wrapper
// allocates out at a's offset when a and b share one); other alignments
// take one word a thread.  The n % 4 words past the last quad go to the
// first threads of block 0.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <bool INVERT>
__device__ __forceinline__ uint32_t op(uint32_t x, uint32_t y) {
  return INVERT ? ~(x ^ y) : (x ^ y);
}

// Quads [0, n4) from word `head` on; words [0, head) and the ragged tail
// past the last quad on the first threads of block 0.
template <bool INVERT>
__global__ void __launch_bounds__(kThreads)
    bulk_quads(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
               uint32_t* __restrict__ out, long long n, int head,
               long long n4) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < n4) {
    const uint4 x = reinterpret_cast<const uint4*>(a + head)[i];
    const uint4 y = reinterpret_cast<const uint4*>(b + head)[i];
    reinterpret_cast<uint4*>(out + head)[i] =
        make_uint4(op<INVERT>(x.x, y.x), op<INVERT>(x.y, y.y),
                   op<INVERT>(x.z, y.z), op<INVERT>(x.w, y.w));
  }
  if (blockIdx.x == 0) {
    const int t = threadIdx.x;
    const long long tail = head + (n4 << 2) + t;
    if (t < head) out[t] = op<INVERT>(a[t], b[t]);
    if (tail < n) out[tail] = op<INVERT>(a[tail], b[tail]);
  }
}

// Buffers whose offsets differ mod 16 bytes: one word a thread.
template <bool INVERT>
__global__ void __launch_bounds__(kThreads)
    bulk_words(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
               uint32_t* __restrict__ out, long long n) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < n) out[i] = op<INVERT>(a[i], b[i]);
}

unsigned blocks(long long items) {
  return static_cast<unsigned>(items > 0 ? (items + kThreads - 1) / kThreads
                                         : 1);
}

template <bool INVERT>
int launch(const uint32_t* a, const uint32_t* b, uint32_t* out, long long n,
           cudaStream_t s) {
  const uintptr_t off = reinterpret_cast<uintptr_t>(a) & 15u;
  if ((reinterpret_cast<uintptr_t>(b) & 15u) == off &&
      (reinterpret_cast<uintptr_t>(out) & 15u) == off) {
    const long long peel = static_cast<long long>((16 - off) % 16 / 4);
    const int head = static_cast<int>(n < peel ? n : peel);
    const long long n4 = (n - head) >> 2;
    bulk_quads<INVERT><<<blocks(n4), kThreads, 0, s>>>(a, b, out, n, head,
                                                        n4);
  } else {
    bulk_words<INVERT><<<blocks(n), kThreads, 0, s>>>(a, b, out, n);
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
