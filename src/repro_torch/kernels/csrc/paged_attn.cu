// Fused block-paged decode attention on Hopper.
//
// Replaces: src/repro/kernels/paged_attn.py::paged_decode_attention (the
// pl.pallas_call at paged_attn.py:146) with its online softmax
// (src/repro/kernels/online_softmax.py) as device code; reached from
// models/attention.py::paged_attention for every decode step (C == 1).
//
// Computes, per slot b and KV head h, attention of the G query rows
// q[b, h] over the keys the block table row table[b] points at: key slot
// w*bs + t lives in pool block table[b, w], offset t.  Masks: monotone
// (kslot <= pos[b]) or the window ring
// (age = (pos % cap - kslot) mod cap < min(window, pos + 1), cap = W*bs,
// with a floor modulo — C's % truncates, so it is written
// ((a % cap) + cap) % cap).  Scores are (q . k) * scale; masked scores are
// NEG_INF = -1e30; the online (m, l, acc) recurrence runs in f32; the end
// normalises by max(l, 1e-30), multiplies by out_scale and stores in
// q's dtype.  int8 pools decode as plain integers: the fixed-point factors
// arrive folded into scale and out_scale.
//
// Bound on this card: bytes — each live K/V block is read once
// (2 * bs * dh * itemsize per column per head); the 4*G*dh flops per key
// are negligible.  Design: one block per (slot, KV head).  CUDA has no
// scalar prefetch, so the block reads its own table row and position.
// It walks the W table columns; a column whose keys are all masked is
// skipped (the decision depends only on pos, so it is uniform across the
// block) — this is both the dead-block fast path and the guard against
// exp(NEG_INF - NEG_INF) poisoning l.  A live column's K and V blocks are
// staged in shared memory as f32 (K rows padded by one word against bank
// conflicts), one thread per (row, key) computes a score, one thread per
// row updates (m, l), and every thread updates its own acc[g][d] entries.
// Simple first: with B*KV blocks the card is far from full at small batch;
// splitting the table walk across blocks (flash-decoding) is later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ bool key_valid(int kslot, int pos, int cap,
                                          int window) {
  if (window > 0) {
    const int age = (((pos % cap) - kslot) % cap + cap) % cap;
    return age < min(window, pos + 1);
  }
  return kslot <= pos;
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ ck,
                        const TKV* __restrict__ cv,
                        const int32_t* __restrict__ table,
                        const int32_t* __restrict__ pos_b,
                        TQ* __restrict__ out, int KV, int G, int dh, int bs,
                        int W, int window, float scale, float out_scale) {
  extern __shared__ float smem[];
  const int ks = dh + 1;                 // padded K row stride
  float* q_s = smem;                     // [G][dh]
  float* k_s = q_s + G * dh;             // [bs][dh + 1]
  float* v_s = k_s + bs * ks;            // [bs][dh]
  float* acc_s = v_s + bs * dh;          // [G][dh]
  float* p_s = acc_s + G * dh;           // [G][bs] scores, then probabilities
  float* m_s = p_s + G * bs;             // [G]
  float* l_s = m_s + G;                  // [G]
  float* c_s = l_s + G;                  // [G] rescale factors

  const int b = blockIdx.x / KV;
  const int h = blockIdx.x % KV;
  const int tid = threadIdx.x;
  const int pos = pos_b[b];
  const int cap = W * bs;
  const size_t qbase = (static_cast<size_t>(b) * KV + h) * G * dh;

  for (int i = tid; i < G * dh; i += kThreads) {
    q_s[i] = xnor::to_f32(q[qbase + i]);
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }

  for (int w = 0; w < W; ++w) {
    bool any = false;
    for (int t = 0; t < bs; ++t) any |= key_valid(w * bs + t, pos, cap, window);
    if (!any) continue;  // uniform: depends on pos and w only

    const int phys = table[static_cast<size_t>(b) * W + w];
    const size_t kvbase = (static_cast<size_t>(phys) * KV + h) * bs * dh;
    __syncthreads();  // previous column's readers are done with k_s/v_s/p_s
    for (int i = tid; i < bs * dh; i += kThreads) {
      const int t = i / dh, d = i - t * dh;
      k_s[t * ks + d] = xnor::to_f32(ck[kvbase + i]);
      v_s[i] = xnor::to_f32(cv[kvbase + i]);
    }
    __syncthreads();

    for (int i = tid; i < G * bs; i += kThreads) {
      const int g = i / bs, t = i - g * bs;
      float s = kNegInf;
      if (key_valid(w * bs + t, pos, cap, window)) {
        float dot = 0.f;
        for (int d = 0; d < dh; ++d) dot += q_s[g * dh + d] * k_s[t * ks + d];
        s = dot * scale;
      }
      p_s[i] = s;
    }
    __syncthreads();

    for (int g = tid; g < G; g += kThreads) {
      const float m_prev = m_s[g];
      float mx = m_prev;
      for (int t = 0; t < bs; ++t) mx = fmaxf(mx, p_s[g * bs + t]);
      float sum = 0.f;
      for (int t = 0; t < bs; ++t) {
        const float p = expf(p_s[g * bs + t] - mx);
        p_s[g * bs + t] = p;
        sum += p;
      }
      const float corr = expf(m_prev - mx);
      l_s[g] = l_s[g] * corr + sum;
      c_s[g] = corr;
      m_s[g] = mx;
    }
    __syncthreads();

    for (int i = tid; i < G * dh; i += kThreads) {
      const int g = i / dh, d = i - g * dh;
      float a = acc_s[i] * c_s[g];
      for (int t = 0; t < bs; ++t) a += p_s[g * bs + t] * v_s[t * dh + d];
      acc_s[i] = a;
    }
  }
  __syncthreads();

  for (int i = tid; i < G * dh; i += kThreads) {
    const int g = i / dh;
    out[qbase + i] =
        xnor::from_f32<TQ>(acc_s[i] / fmaxf(l_s[g], 1e-30f) * out_scale);
  }
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* ck, const void* cv, const int32_t* table,
           const int32_t* pos, void* out, int B, int KV, int G, int dh, int bs,
           int W, int window, float scale, float out_scale, cudaStream_t s) {
  const size_t floats = static_cast<size_t>(G) * dh * 2 +
                        static_cast<size_t>(bs) * (2 * dh + 1) +
                        static_cast<size_t>(G) * bs + 3 * G;
  const size_t smem = floats * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel<TQ, TKV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  paged_decode_kernel<TQ, TKV><<<B * KV, kThreads, smem, s>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(ck),
      static_cast<const TKV*>(cv), table, pos, static_cast<TQ*>(out), KV, G,
      dh, bs, W, window, scale, out_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ>
int dispatch_kv(int kv_dtype, const void* q, const void* ck, const void* cv,
                const int32_t* table, const int32_t* pos, void* out, int B,
                int KV, int G, int dh, int bs, int W, int window, float scale,
                float out_scale, cudaStream_t s) {
  switch (kv_dtype) {
    case xnor::kF32:
      return launch<TQ, float>(q, ck, cv, table, pos, out, B, KV, G, dh, bs,
                               W, window, scale, out_scale, s);
    case xnor::kBF16:
      return launch<TQ, __nv_bfloat16>(q, ck, cv, table, pos, out, B, KV, G,
                                       dh, bs, W, window, scale, out_scale, s);
    case xnor::kI8:
      return launch<TQ, int8_t>(q, ck, cv, table, pos, out, B, KV, G, dh, bs,
                                W, window, scale, out_scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int paged_decode(const void* q, int q_dtype, const void* ck,
                            const void* cv, int kv_dtype, const void* table,
                            const void* pos, void* out, int B, int KV, int G,
                            int dh, int bs, int W, int window, float scale,
                            float out_scale, void* stream) {
  if (B <= 0 || KV <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* tbl = static_cast<const int32_t*>(table);
  const int32_t* p = static_cast<const int32_t*>(pos);
  switch (q_dtype) {
    case xnor::kF32:
      return dispatch_kv<float>(kv_dtype, q, ck, cv, tbl, p, out, B, KV, G,
                                dh, bs, W, window, scale, out_scale, s);
    case xnor::kBF16:
      return dispatch_kv<__nv_bfloat16>(kv_dtype, q, ck, cv, tbl, p, out, B,
                                        KV, G, dh, bs, W, window, scale,
                                        out_scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
