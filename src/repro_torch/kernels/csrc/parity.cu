// XOR-fold parity digest on Hopper, one digest row per chunk.
//
// Replaces: src/repro/kernels/parity.py::parity_digest (the pl.pallas_call
// at parity.py:47), reached from ops.digest: CimEngine.digest /
// digest_stream / digest_chunks, core/verify.py::tree_digest and the
// DigestCache of core/incremental.py.  The reference's chunk-level export
// (engine.py's digest_chunks, an XLA reduce) runs here too: a plain digest
// is the one-chunk case.
//
// Computes out[c, j] ^= XOR of words[c * chunk + r * width + j] over the
// rows r of chunk c, for every word index below n (a ragged last row
// counts its missing words as zero, the reference's XOR-neutral pad).
// ``out`` (n_chunks, width) is zeroed by the caller; width <= 1024.
//
// Bound on this card: bytes.  One read of the buffer, 4 bytes a word, and
// a digest row per chunk written; one XOR a word.  Design: a chunk is cut
// into spans of S = width * floor(1024 / width) words (1024 for the usual
// power-of-two widths) and each block folds a run of consecutive spans of
// one chunk (grid: chunks x blocks per chunk, enough blocks to keep 8 on
// every SM).  Lane t of the block owns span positions 4t..4t+3 (16-byte
// loads, a warp reads 512 contiguous bytes; when the buffer, the chunk or
// S is not 16-byte aligned, positions t + 256q with one-word loads) and
// XORs into four registers.  A span holds whole digest rows, so span
// position p always lands on digest lane p % width: at the end the block
// writes its partial words to shared memory, folds them to width words
// and applies one atomicXor per non-zero word.  XOR is exact in any
// order, so the atomics' order does not matter.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSpan = 4 * kThreads;  // words one block folds per step

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
    parity_kernel(const uint32_t* __restrict__ words, long long n,
                  long long chunk_words, int width, int span,
                  long long spans_per_block, uint32_t* __restrict__ out) {
  __shared__ uint32_t fold[kMaxSpan];
  const long long c = blockIdx.x;
  const long long base = c * chunk_words;
  const long long rest = n - base;
  const long long len = rest < chunk_words ? rest : chunk_words;
  const long long spans = (len + span - 1) / span;
  const long long s0 = static_cast<long long>(blockIdx.y) * spans_per_block;
  const long long s1 =
      spans < s0 + spans_per_block ? spans : s0 + spans_per_block;
  const uint32_t* cw = words + base;
  const int t = threadIdx.x;
  uint32_t acc[4] = {0u, 0u, 0u, 0u};
#pragma unroll 4
  for (long long s = s0; s < s1; ++s) {
    const long long o = s * span;
    if constexpr (VEC) {  // span % 4 == 0: a lane's four words share a span
      if (4 * t < span) {
        const long long p = o + 4 * t;
        if (p + 4 <= len) {
          const uint4 v = *reinterpret_cast<const uint4*>(cw + p);
          acc[0] ^= v.x;
          acc[1] ^= v.y;
          acc[2] ^= v.z;
          acc[3] ^= v.w;
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (p + q < len) acc[q] ^= cw[p + q];
        }
      }
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = t + q * kThreads;
        const long long p = o + r;
        if (r < span && p < len) acc[q] ^= cw[p];
      }
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) fold[VEC ? 4 * t + q : t + q * kThreads] = acc[q];
  __syncthreads();
  for (int j = t; j < width; j += kThreads) {
    uint32_t v = 0u;
    for (int m = j; m < span; m += width) v ^= fold[m];
    if (v) atomicXor(out + c * width + j, v);
  }
}

}  // namespace

extern "C" int parity_digest(const void* words, long long n,
                             long long chunk_words, int width, void* out,
                             void* stream) {
  if (n <= 0) return 0;
  if (width <= 0 || width > kMaxSpan || chunk_words <= 0 ||
      chunk_words % width != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_chunks = (n + chunk_words - 1) / chunk_words;
  if (n_chunks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int span = width * (kMaxSpan / width);
  const long long max_spans = (chunk_words + span - 1) / span;
  const long long target = xnor::stream_blocks(1LL << 62, kThreads);
  long long per_chunk = (target + n_chunks - 1) / n_chunks;
  if (per_chunk > max_spans) per_chunk = max_spans;
  if (per_chunk > 65535) per_chunk = 65535;
  const long long spans_per_block = (max_spans + per_chunk - 1) / per_chunk;
  per_chunk = (max_spans + spans_per_block - 1) / spans_per_block;
  const dim3 grid(static_cast<unsigned>(n_chunks),
                  static_cast<unsigned>(per_chunk));
  const uint32_t* w = static_cast<const uint32_t*>(words);
  uint32_t* o = static_cast<uint32_t*>(out);
  if (xnor::aligned16(w) && chunk_words % 4 == 0 && span % 4 == 0) {
    parity_kernel<true><<<grid, kThreads, 0, s>>>(w, n, chunk_words, width,
                                                  span, spans_per_block, o);
  } else {
    parity_kernel<false><<<grid, kThreads, 0, s>>>(w, n, chunk_words, width,
                                                   span, spans_per_block, o);
  }
  return static_cast<int>(cudaGetLastError());
}
