// Fused (flash) causal or full softmax attention on Hopper.
//
// Replaces: src/repro/kernels/flash_attn.py::flash_attention (the
// pl.pallas_call at flash_attn.py:82) and the online softmax of
// src/repro/kernels/online_softmax.py, carried here as device code.
//
// Computes, for each of BH independent heads, o = softmax(q k^T * scale) v
// over (S, dh) rows, masked to kpos <= qpos when causal.  Scores, the
// online (m, l, acc) recurrence and the normalisation by max(l, 1e-30) run
// in f32; masked scores are NEG_INF = -1e30, as in the reference; the
// output is cast to q's dtype.
//
// Bound on this card: operations (4 * dh flops per query-key pair against
// reading q, k, v and writing o once); the bf16 tensor cores (989 TFLOP/s)
// are the only way near it.
//
// bf16 (the main path): warp-specialised, FA-3 style.  One block of three
// warpgroups per (query tile of 128 rows, head); blocks of the heavier
// causal tiles start first.  Warpgroup 0 is the producer: it gives up
// registers (setmaxnreg 24) and one thread issues TMA loads — the Q tile
// once, then K and V tiles of BK keys into a three-stage ring (two for
// dh > 128), each stage with its own full (K, V) and empty mbarriers.
// Warpgroups 1 and 2 are consumers (setmaxnreg 240), 64 query rows each:
// S = Q K^T is a chain of wgmma m64nBKk16 with both operands K-major in
// shared memory (K's natural (S, dh) rows); the online softmax runs on the
// accumulator fragment in f32 (a row's max and sum meet over the four
// threads of a quad, MUFU exp2 of pre-scaled scores, the mask applied only
// to tiles the causal diagonal or the sequence end crosses); O += P V is a
// wgmma with A = P from registers
// (the f32 accumulator, converted pairwise to bf16, is the A fragment) and
// B = V read MN-major (transpose bit).  P is carried as bf16 hi + lo and
// issued as two products, so the P V product keeps P to 2^-17 and the
// output stays within one bf16 ulp of the f32 recurrence.  TMA's 128-byte
// swizzle is the layout the wgmma descriptors read; its zero fill covers
// the ragged sequence end and dh below the instance width (64, 128 or 256;
// dh a multiple of 8), so no input is padded or copied.  Tiles: BQ = 128;
// BK = 128 for dh <= 128, 64 for dh <= 256.  The tensor maps are encoded on
// the host at each call (cuTensorMapEncodeTiled, looked up with
// cudaGetDriverEntryPoint, so no -lcuda) and passed as __grid_constant__
// parameters.
//
// f32 inputs keep a CUDA-core kernel (the tensor cores would compute
// f32 only as TF32, which cannot hold the reference suite's 2e-5): one
// block of 256 threads per (64-row query tile, head), four lanes per query
// row, K and V tiles in shared memory as f32, (m, l, acc) in registers.  It
// is a kernel of its own, not the plain version.
#include <cuda.h>

#include "common.cuh"

namespace {

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// f32: the CUDA-core kernel
namespace cuda_core {

constexpr int kBQ = 64;                 // query rows per block
constexpr int kBK = 64;                 // keys per tile
constexpr int kLanes = 4;               // lanes per query row
constexpr int kThreads = kBQ * kLanes;  // 256
constexpr int kCols = kBK / kLanes;     // scores per lane per tile

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
    flash_f32_kernel(const T* __restrict__ q, const T* __restrict__ k,
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
int launch_f32(const void* q, const void* k, const void* v, void* o, int BH,
           int S, int dh, float scale, int causal, cudaStream_t s) {
  const size_t smem =
      (static_cast<size_t>(kBQ + kBK) * (dh + 4) + kBK * dh) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_f32_kernel<T, DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((S + kBQ - 1) / kBQ, BH);
  flash_f32_kernel<T, DMAX><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, dh, scale, causal);
  return static_cast<int>(cudaGetLastError());
}


}  // namespace cuda_core

// ---------------------------------------------------------------------------
// bf16: wgmma on the tensor cores, K and V by TMA through an mbarrier ring
namespace tc {

constexpr int kBQ = 128;                  // query rows per block
constexpr int kThreads = 384;             // producer + two consumer groups

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// TMA: box (c0 = column, c1 = row, c2 = head) of `map` into shared memory
// at dst; completion is counted in bytes on mbarrier bar.
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor for a 128-byte-swizzled tile (TMA's
// SWIZZLE_128B, 1024-byte-aligned atoms of 8 rows x 128 bytes): start
// address >> 4, leading and stride byte offsets >> 4, layout type 1.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving accesses of accumulator registers across
// a wgmma wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// 2^x in one MUFU op (flushes subnormal results to zero; 2^-1e30 is 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += A . B^T, m64n64k16: A (64 x 16) and B (64 x 16), both K-major in
// shared memory (descriptors da, db); d the thread's 32 f32 accumulators.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += A . B, m64n64k16: A (64 x 16 bf16) from registers a0..a3, in the
// accumulator fragment's order; B (16 x 64) MN-major in shared memory
// (descriptor db, transpose bit set).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], uint32_t a0,
                                            uint32_t a1, uint32_t a2,
                                            uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// d += A . B^T, m64n128k16: A (64 x 16) and B (128 x 16), both K-major in
// shared memory (descriptors da, db); d the thread's 64 f32 accumulators.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += A . B, m64n128k16: A (64 x 16 bf16) from registers a0..a3, in the
// accumulator fragment's order; B (16 x 128) MN-major in shared memory
// (descriptor db, transpose bit set).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], uint32_t a0,
                                            uint32_t a1, uint32_t a2,
                                            uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// S (64 x BK) += Q-slice . K-slice^T for one k16 step.
template <int BK>
__device__ __forceinline__ void qk_step(float (&s)[BK / 2], uint64_t da,
                                        uint64_t db, int scale_d) {
  if constexpr (BK == 64) {
    wgmma_ss_n64(s, da, db, scale_d);
  } else {
    wgmma_ss_n128(s, da, db, scale_d);
  }
}

// O (64 x DH) += P-slice (registers a0..a3) . V-slice for one k16 step;
// v_addr is the step's first key row in box 0, box_bytes the distance
// between the 64-column boxes of V (the MN-major leading byte offset).
template <int DH>
__device__ __forceinline__ void pv_step(float (&o)[DH / 2], uint32_t a0,
                                        uint32_t a1, uint32_t a2,
                                        uint32_t a3, uint32_t v_addr,
                                        uint32_t box_bytes) {
  if constexpr (DH == 64) {
    wgmma_rs_n64(o, a0, a1, a2, a3, sw128_desc(v_addr, box_bytes, 1024));
  } else if constexpr (DH == 128) {
    wgmma_rs_n128(o, a0, a1, a2, a3, sw128_desc(v_addr, box_bytes, 1024));
  } else {
    wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(&o[0]), a0, a1, a2, a3,
                  sw128_desc(v_addr, box_bytes, 1024));
    wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(&o[64]), a0, a1, a2, a3,
                  sw128_desc(v_addr + 2 * box_bytes, box_bytes, 1024));
  }
}

template <int DH, int BK>
struct Cfg {
  // K/V ring depth: three stages where they fit beside Q (227 KB)
  static constexpr int kStages = DH == 256 ? 2 : 3;
  static constexpr int kBoxes = DH / 64;            // 64-column TMA boxes
  static constexpr int kQBytes = kBQ * DH * 2;
  static constexpr int kTileBytes = BK * DH * 2;    // one K or V tile
  static constexpr int kBarOffset = kQBytes + kStages * 2 * kTileBytes;
  // + 1024 to align the tiles, + the 1 + 3 * kStages mbarriers
  static constexpr int kSmem = kBarOffset + 1024 + 8 * (1 + 3 * kStages);
};

// Shared memory, from a 1024-byte-aligned base: Q [boxes][kBQ][64];
// stage st: K [boxes][BK][64], then V the same; then the mbarriers
// q_full, k_full[st], v_full[st], empty[st].
template <int DH, int BK>
__global__ void __launch_bounds__(kThreads, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       __nv_bfloat16* __restrict__ o, int S, int dh,
                       float scale_log2, int causal) {
  using C = Cfg<DH, BK>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t q_s = (raw + 1023u) & ~1023u;
  const uint32_t kv_s = q_s + C::kQBytes;
  const uint32_t bars = q_s + C::kBarOffset;
  const uint32_t q_full = bars;
  const uint32_t k_full = bars + 8;                    // + 8 * stage
  const uint32_t v_full = bars + 8 * (1 + C::kStages);
  const uint32_t empty = bars + 8 * (1 + 2 * C::kStages);

  const int nqt = (S + kBQ - 1) / kBQ;
  const int q0 = (nqt - 1 - static_cast<int>(blockIdx.x)) * kBQ;
  const int bh = blockIdx.y;
  const int kend = causal ? min(S, q0 + kBQ) : S;
  const int n_kt = (kend + BK - 1) / BK;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int st = 0; st < C::kStages; ++st) {
      mbar_init(k_full + 8 * st, 1);
      mbar_init(v_full + 8 * st, 1);
      mbar_init(empty + 8 * st, 8);      // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == 0) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == 0) {
      mbar_expect_tx(q_full, C::kQBytes);
#pragma unroll
      for (int b = 0; b < C::kBoxes; ++b)
        tma_load_3d(q_s + b * kBQ * 128, &tm_q, 64 * b, q0, bh, q_full);
      for (int t = 0; t < n_kt; ++t) {
        const int st = t % C::kStages;
        const uint32_t ph = (t / C::kStages) & 1;
        mbar_wait(empty + 8 * st, ph ^ 1);   // the previous round released
        const uint32_t ks = kv_s + st * 2 * C::kTileBytes;
        const uint32_t vs = ks + C::kTileBytes;
        mbar_expect_tx(k_full + 8 * st, C::kTileBytes);
#pragma unroll
        for (int b = 0; b < C::kBoxes; ++b)
          tma_load_3d(ks + b * BK * 128, &tm_k, 64 * b, t * BK, bh,
                      k_full + 8 * st);
        mbar_expect_tx(v_full + 8 * st, C::kTileBytes);
#pragma unroll
        for (int b = 0; b < C::kBoxes; ++b)
          tma_load_3d(vs + b * BK * 128, &tm_v, 64 * b, t * BK, bh,
                      v_full + 8 * st);
      }
    }
    return;
  }

  // ---- consumers: warpgroup cw owns query rows q0 + 64 * cw + [0, 64) ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int cw = wg - 1;
  const int t = tid - 128 * wg;
  const int lane = t % 32;
  // this thread's accumulator rows (r, r + 8) and column pair in each
  // 8-column chunk: element i of a fragment is row r + 8 * ((i >> 1) & 1),
  // column 8 * (i >> 2) + cq + (i & 1)
  const int qpos0 = q0 + 64 * cw + 16 * (t / 32) + lane / 4;
  const int qpos1 = qpos0 + 8;
  const int cq = 2 * (lane % 4);
  const uint32_t q_wg = q_s + cw * 64 * 128;

  float oacc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) oacc[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  mbar_wait(q_full, 0);
  for (int it = 0; it < n_kt; ++it) {
    const int st = it % C::kStages;
    const uint32_t ph = (it / C::kStages) & 1;
    const uint32_t ks = kv_s + st * 2 * C::kTileBytes;
    const uint32_t vs = ks + C::kTileBytes;
    const int k0 = it * BK;

    // S = Q K^T
    float s[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
    mbar_wait(k_full + 8 * st, ph);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;   // 16 columns: 32 bytes
      const uint64_t da =
          sw128_desc(q_wg + (kk / 4) * kBQ * 128 + off, 16, 1024);
      const uint64_t db = sw128_desc(ks + (kk / 4) * BK * 128 + off, 16, 1024);
      qk_step<BK>(s, da, db, kk > 0);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);

    // online softmax in the log2 domain (scores pre-scaled by
    // scale * log2(e)); rows r and r + 8 reduce over their quad
    const bool masked =
        k0 + BK > S || (causal && k0 + BK - 1 > q0 + 64 * cw);
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      float x = s[i] * scale_log2;
      if (masked) {
        const int kpos = k0 + 8 * (i >> 2) + cq + (i & 1);
        const int qpos = (i & 2) ? qpos1 : qpos0;
        if (kpos >= S || (causal && kpos > qpos)) x = kNegInf;
      }
      s[i] = x;
      if (i & 2) {
        mx1 = fmaxf(mx1, x);
      } else {
        mx0 = fmaxf(mx0, x);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const float p = fast_exp2(s[i] - ((i & 2) ? mx1 : mx0));
      s[i] = p;
      if (i & 2) {
        sum1 += p;
      } else {
        sum0 += p;
      }
    }
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
    const float c0 = fast_exp2(m0 - mx0), c1 = fast_exp2(m1 - mx1);
    l0 = l0 * c0 + sum0;
    l1 = l1 * c1 + sum1;
    m0 = mx0;
    m1 = mx1;
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) oacc[i] *= (i & 2) ? c1 : c0;

    // P as bf16 hi + lo pairs: the A fragments of the P V products
    uint32_t p_hi[BK / 4], p_lo[BK / 4];
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) {
      const float a = s[2 * i], b = s[2 * i + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
      const float2 hf = __bfloat1622float2(h);
      p_hi[i] = bf16x2_bits(h);
      p_lo[i] = bf16x2_bits(__floats2bfloat162_rn(a - hf.x, b - hf.y));
    }

    // O += P V
    mbar_wait(v_full + 8 * st, ph);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t v_addr = vs + kk * 16 * 128;
      pv_step<DH>(oacc, p_hi[4 * kk], p_hi[4 * kk + 1], p_hi[4 * kk + 2],
                  p_hi[4 * kk + 3], v_addr, BK * 128);
      pv_step<DH>(oacc, p_lo[4 * kk], p_lo[4 * kk + 1], p_lo[4 * kk + 2],
                  p_lo[4 * kk + 3], v_addr, BK * 128);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(oacc);
    if (lane == 0) mbar_arrive(empty + 8 * st);   // K and V read: release
  }

  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  const size_t base = static_cast<size_t>(bh) * S;
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    const int col = 8 * j + cq;
    if (col < dh) {
      if (qpos0 < S)
        *reinterpret_cast<__nv_bfloat162*>(
            o + (base + qpos0) * dh + col) =
            __floats2bfloat162_rn(oacc[4 * j] / d0, oacc[4 * j + 1] / d0);
      if (qpos1 < S)
        *reinterpret_cast<__nv_bfloat162*>(
            o + (base + qpos1) * dh + col) =
            __floats2bfloat162_rn(oacc[4 * j + 2] / d1, oacc[4 * j + 3] / d1);
    }
  }
}

// ---- host side ----

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (dh, S, BH) bf16 tensor map with 64-column, `rows`-row boxes and
// 128-byte swizzle; out-of-bounds elements load as zero.
int encode(CUtensorMap* map, const void* ptr, int BH, int S, int dh,
           int rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(dh),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(BH)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(dh) * 2,
                                 static_cast<cuuint64_t>(S) * dh * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int DH, int BK>
int launch(const void* q, const void* k, const void* v, void* o, int BH,
           int S, int dh, float scale, int causal, cudaStream_t s) {
  if (!xnor::aligned16(q) || !xnor::aligned16(k) || !xnor::aligned16(v) ||
      !xnor::aligned16(o))
    return static_cast<int>(cudaErrorMisalignedAddress);
  CUtensorMap tq, tk, tv;
  int e = encode(&tq, q, BH, S, dh, kBQ);
  if (e == 0) e = encode(&tk, k, BH, S, dh, BK);
  if (e == 0) e = encode(&tv, v, BH, S, dh, BK);
  if (e != 0) return e;
  const int smem = Cfg<DH, BK>::kSmem;
  const cudaError_t a = cudaFuncSetAttribute(
      flash_wgmma_kernel<DH, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (a != cudaSuccess) return static_cast<int>(a);
  const dim3 grid((S + kBQ - 1) / kBQ, BH);
  // log2(e): scores are exponentiated with exp2
  flash_wgmma_kernel<DH, BK><<<grid, kThreads, smem, s>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), S, dh,
      scale * 1.4426950408889634f, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

int dispatch_f32(const void* q, const void* k, const void* v, void* o, int BH,
                 int S, int dh, float scale, int causal, cudaStream_t s) {
  using cuda_core::launch_f32;
  if (dh <= 64)
    return launch_f32<float, 64>(q, k, v, o, BH, S, dh, scale, causal, s);
  if (dh <= 128)
    return launch_f32<float, 128>(q, k, v, o, BH, S, dh, scale, causal, s);
  return launch_f32<float, 256>(q, k, v, o, BH, S, dh, scale, causal, s);
}

int dispatch_bf16(const void* q, const void* k, const void* v, void* o,
                  int BH, int S, int dh, float scale, int causal,
                  cudaStream_t s) {
  if (dh <= 64)
    return tc::launch<64, 128>(q, k, v, o, BH, S, dh, scale, causal, s);
  if (dh <= 128)
    return tc::launch<128, 128>(q, k, v, o, BH, S, dh, scale, causal, s);
  return tc::launch<256, 64>(q, k, v, o, BH, S, dh, scale, causal, s);
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
      return dispatch_f32(q, k, v, o, BH, S, dh, scale, causal, s);
    case xnor::kBF16:
      return dispatch_bf16(q, k, v, o, BH, S, dh, scale, causal, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
