// Counter-mode XOR stream cipher on Hopper.
//
// Replaces: src/repro/kernels/cipher.py::xor_cipher (the pl.pallas_call at
// cipher.py:47), reached from ops.stream_cipher: CimEngine.stream_cipher,
// core/encrypt.py::encrypt_device and the *_via_device host twins.
//
// Computes out[i] = in[i] ^ ks(idx), idx = (i + counter) mod 2^32, with the
// keystream of src/repro/kernels/ref.py::keystream_word (murmur3's fmix32
// over idx * 0x9E3779B9 + key0, XOR key1), all in uint32 arithmetic.  The
// index is formed in 64 bits and truncated, so it equals the reference's
// arange(n, uint32) + counter for any counter in [0, 2^32), wrap included.
// Decryption is the same call (an involution).
//
// Bound on this card: bytes.  One read and one write, 8 bytes a word; the
// keystream is made in registers and never touches memory.  Its ~12
// integer ops a word (two 32-bit multiplies) come to ~1.3e10 for a 3.8 GB
// leaf, far under the card's integer rate.  Design: as csrc/bulk.cu — a
// grid-stride loop, four words a lane through 16-byte loads and stores
// when both pointers are 16-byte aligned (the n % 4 tail by the first
// threads of the grid), one word a lane otherwise.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t keystream(uint32_t idx, uint32_t k0,
                                              uint32_t k1) {
  uint32_t h = idx * 0x9E3779B9u + k0;
  h ^= k1;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t word_index(long long i, uint32_t ctr) {
  return static_cast<uint32_t>(static_cast<unsigned long long>(i) + ctr);
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
    cipher_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                  long long n, uint32_t k0, uint32_t k1, uint32_t ctr) {
  const long long tid =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  if constexpr (VEC) {
    const long long n4 = n >> 2;
    const uint4* i4 = reinterpret_cast<const uint4*>(in);
    uint4* o4 = reinterpret_cast<uint4*>(out);
    for (long long v = tid; v < n4; v += stride) {
      const uint4 x = i4[v];
      const long long w = v << 2;
      o4[v] = make_uint4(x.x ^ keystream(word_index(w, ctr), k0, k1),
                         x.y ^ keystream(word_index(w + 1, ctr), k0, k1),
                         x.z ^ keystream(word_index(w + 2, ctr), k0, k1),
                         x.w ^ keystream(word_index(w + 3, ctr), k0, k1));
    }
    const long long t = (n4 << 2) + tid;  // the n % 4 tail words
    if (t < n) out[t] = in[t] ^ keystream(word_index(t, ctr), k0, k1);
  } else {
    for (long long i = tid; i < n; i += stride)
      out[i] = in[i] ^ keystream(word_index(i, ctr), k0, k1);
  }
}

}  // namespace

extern "C" int xor_cipher(const void* in, void* out, long long n,
                          unsigned int key0, unsigned int key1,
                          unsigned int counter, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* pi = static_cast<const uint32_t*>(in);
  uint32_t* po = static_cast<uint32_t*>(out);
  if (xnor::aligned16(pi) && xnor::aligned16(po)) {
    const int grid = xnor::stream_blocks(n >> 2, kThreads);
    cipher_kernel<true><<<grid, kThreads, 0, s>>>(pi, po, n, key0, key1,
                                                  counter);
  } else {
    const int grid = xnor::stream_blocks(n, kThreads);
    cipher_kernel<false><<<grid, kThreads, 0, s>>>(pi, po, n, key0, key1,
                                                   counter);
  }
  return static_cast<int>(cudaGetLastError());
}
