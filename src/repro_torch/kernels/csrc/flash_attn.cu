// Fused (flash) causal or full softmax attention on Hopper.
//
// Replaces: src/repro/kernels/flash_attn.py::flash_attention (the
// pl.pallas_call at flash_attn.py:82) and the online softmax of
// src/repro/kernels/online_softmax.py, carried here as device code.
//
// Computes, for each of BH independent heads, o = softmax(q k^T * scale) v
// over (S, dh) rows, masked to kpos <= qpos when causal.  Inputs are f32 or
// bf16 and are upcast; scores, the online (m, l, acc) recurrence and the
// normalisation by max(l, 1e-30) run in f32 with expf; the output is cast to
// q's dtype.  Masked scores are NEG_INF = -1e30, as in the reference.
//
// Bound on this card: operations (4 * dh flops per query-key pair against
// reading q, k, v and writing o once).  This first kernel runs on the CUDA
// cores in f32: tensor cores (mma.sync / wgmma), TMA and a pipelined
// producer are later work.  Design: one block of 256 threads per (query
// tile of 64 rows, head); blocks of the later, heavier causal tiles start
// first.  Four lanes share a query row: each lane scores 16 of a key tile's
// 64 keys from shared memory with 16-byte loads, the row's max and sum
// meet in a two-step xor butterfly, and each lane keeps its quarter of the
// row's (dh)-wide accumulator in registers, so no score tile or
// accumulator leaves the SM.  K and V tiles are staged in shared memory as
// f32 (rows padded by four words against bank conflicts); keys past S are
// zero and masked.  Causal blocks walk key tiles only up to the diagonal;
// the first key of every walked tile is at or below each row's position,
// so no row of a walked tile is all masked (the online-softmax edge case
// cannot arise).
#include "common.cuh"

namespace {

constexpr int kBQ = 64;                 // query rows per block
constexpr int kBK = 64;                 // keys per tile
constexpr int kLanes = 4;               // lanes per query row
constexpr int kThreads = kBQ * kLanes;  // 256
constexpr int kCols = kBK / kLanes;     // scores per lane per tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// DMAX: the largest dh this instance takes; a lane owns the 4-column
// chunks c = sub + 4 * j, j < DMAX / 16, of its row's accumulator.
template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S, int dh,
                 float scale, int causal) {
  constexpr int kChunks = DMAX / 16;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ld = dh + 4;            // padded row stride, 16-byte aligned
  float* q_s = smem;                // [kBQ][ld]
  float* k_s = q_s + kBQ * ld;      // [kBK][ld]
  float* v_s = k_s + kBK * ld;      // [kBK][dh]

  const int nqt = (S + kBQ - 1) / kBQ;
  const int q0 = (nqt - 1 - static_cast<int>(blockIdx.x)) * kBQ;
  const size_t base = static_cast<size_t>(blockIdx.y) * S * dh;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int row = tid / kLanes, sub = tid % kLanes;
  const int qpos = q0 + row;

  const int q_rows = min(kBQ, S - q0);
  for (int i = tid; i < kBQ * dh; i += kThreads) {
    const int r = i / dh, d = i - r * dh;
    q_s[r * ld + d] =
        r < q_rows ? xnor::to_f32(q[base + static_cast<size_t>(q0) * dh + i])
                   : 0.f;
  }

  float m = kNegInf, l = 0.f;
  float4 acc[kChunks];
#pragma unroll
  for (int j = 0; j < kChunks; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);

  const int kend = causal ? min(S, q0 + kBQ) : S;
  for (int k0 = 0; k0 < kend; k0 += kBK) {
    const int k_rows = min(kBK, S - k0);
    __syncthreads();  // the previous tile's readers are done (and q_s is set)
    for (int i = tid; i < kBK * dh; i += kThreads) {
      const int r = i / dh, d = i - r * dh;
      const size_t g = base + static_cast<size_t>(k0) * dh + i;
      const bool in = r < k_rows;
      k_s[r * ld + d] = in ? xnor::to_f32(k[g]) : 0.f;
      v_s[i] = in ? xnor::to_f32(v[g]) : 0.f;
    }
    __syncthreads();

    // scores of keys k0 + sub + 4 * j
    float s[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) s[j] = 0.f;
    const float4* qr = reinterpret_cast<const float4*>(q_s + row * ld);
    for (int d4 = 0; d4 < dh / 4; ++d4) {
      const float4 a = qr[d4];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float4 b = reinterpret_cast<const float4*>(
            k_s + (sub + kLanes * j) * ld)[d4];
        s[j] = dot4(a, b, s[j]);
      }
    }
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int kpos = k0 + sub + kLanes * j;
      const bool valid = kpos < S && (!causal || kpos <= qpos);
      s[j] = valid ? s[j] * scale : kNegInf;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      s[j] = expf(s[j] - m_new);
      sum += s[j];
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float corr = expf(m - m_new);
    l = l * corr + sum;
    m = m_new;

#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      acc[j].x *= corr;
      acc[j].y *= corr;
      acc[j].z *= corr;
      acc[j].w *= corr;
    }
    // acc += p @ v: key c = t + 4 * jj lives in lane t of this row's group
#pragma unroll
    for (int jj = 0; jj < kCols; ++jj) {
#pragma unroll
      for (int t = 0; t < kLanes; ++t) {
        const float p =
            __shfl_sync(0xffffffffu, s[jj], (lane & ~(kLanes - 1)) | t);
        const float* vr = v_s + (t + kLanes * jj) * dh;
#pragma unroll
        for (int j = 0; j < kChunks; ++j) {
          const int col = 4 * (sub + kLanes * j);
          if (col < dh) {
            const float4 b = *reinterpret_cast<const float4*>(vr + col);
            acc[j].x = fmaf(p, b.x, acc[j].x);
            acc[j].y = fmaf(p, b.y, acc[j].y);
            acc[j].z = fmaf(p, b.z, acc[j].z);
            acc[j].w = fmaf(p, b.w, acc[j].w);
          }
        }
      }
    }
  }

  if (qpos < S) {
    const float den = fmaxf(l, 1e-30f);
    T* orow = o + base + static_cast<size_t>(qpos) * dh;
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int col = 4 * (sub + kLanes * j);
      if (col < dh) {
        orow[col + 0] = xnor::from_f32<T>(acc[j].x / den);
        orow[col + 1] = xnor::from_f32<T>(acc[j].y / den);
        orow[col + 2] = xnor::from_f32<T>(acc[j].z / den);
        orow[col + 3] = xnor::from_f32<T>(acc[j].w / den);
      }
    }
  }
}

template <typename T, int DMAX>
int launch(const void* q, const void* k, const void* v, void* o, int BH,
           int S, int dh, float scale, int causal, cudaStream_t s) {
  const size_t smem =
      (static_cast<size_t>(kBQ + kBK) * (dh + 4) + kBK * dh) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<T, DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((S + kBQ - 1) / kBQ, BH);
  flash_kernel<T, DMAX><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, dh, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dh(const void* q, const void* k, const void* v, void* o, int BH,
                int S, int dh, float scale, int causal, cudaStream_t s) {
  if (dh <= 64) return launch<T, 64>(q, k, v, o, BH, S, dh, scale, causal, s);
  if (dh <= 128)
    return launch<T, 128>(q, k, v, o, BH, S, dh, scale, causal, s);
  return launch<T, 256>(q, k, v, o, BH, S, dh, scale, causal, s);
}

}  // namespace

// q, k, v, o: (BH, S, dh) contiguous, dtype code 0 (f32) or 1 (bf16);
// dh a multiple of 8 in [8, 256] (checked by the wrapper, and here).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int dtype, int BH, int S, int dh,
                               float scale, int causal, void* stream) {
  if (BH <= 0 || S <= 0) return 0;
  if (dh < 8 || dh > 256 || dh % 8 != 0 || BH > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case xnor::kF32:
      return dispatch_dh<float>(q, k, v, o, BH, S, dh, scale, causal, s);
    case xnor::kBF16:
      return dispatch_dh<__nv_bfloat16>(q, k, v, o, BH, S, dh, scale, causal,
                                        s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
