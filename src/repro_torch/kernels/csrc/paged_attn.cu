// Fused block-paged decode attention on Hopper, split across blocks
// (flash-decoding).
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
// are few, but on the CUDA cores they are not free.  One block per (slot,
// KV head) would leave most of the 132 SMs idle and walk a long table
// serially, so the walk is split: the grid is (B*KV, n_split), and block
// (bh, i) walks table columns [i*cols, min(W, (i+1)*cols)).  The host
// picks n_split and cols from W, KV and the SM count alone, sizing the
// grid for a fixed number of slots (kernels/paged_attn.py::split_plan),
// never from pos, so a decode step needs no device-to-host read, and
// never from B, so a slot's result is the same bits in a batch of any
// size.  A column's liveness is O(1) and depends
// only on pos and the column, so a dead column is skipped uniformly (which
// is also the guard against exp(NEG_INF - NEG_INF)).
//
// Inside a block the four warps form 4 / RW walkers of RW warps each; a
// walker walks its own columns (every (4 / RW)-th), with no block barrier
// in the walk: it streams its live columns' K and V pages into its own
// shared-memory ring (three stages, two for f32 pages) with 16-byte
// cp.async, a column or two ahead, each page's pool block id loaded one
// issue ahead.  With RW = 1 a walker is one warp holding every query row;
// with RW = 2 (dh > 128 with G > 8, or f32 pools at dh > 128) the query
// rows are cut in two groups, one a warp, that score the same staged page
// (each K/V page still crosses HBM once) and meet at a named barrier per
// column.  That keeps a lane's q chunks and P V sums in registers at
// G 16, dh 256 (two groups of 8 rows, 128 + 64 floats), and halves the
// rings, so f32 pools at dh 256 fit (2 walkers x 2 stages x 32 KB).  Scores: a half-warp per key, each lane holding its
// 8-column chunk of every query row in registers; the rows' partial dots
// meet in a reduce-scatter of at most 15 shuffles, four keys at a time so
// their shuffles overlap.  (m, l): all rows at once, 32 / G lanes a row.
// P V: each lane owns one 8-column chunk of every row over half the keys,
// so a V element is read and converted once; a row whose max did not move
// skips its rescale.  After the walk the warps' (m, l, acc) merge in
// shared memory.  With one split the block then writes the output.
// Otherwise each split writes its partial (m, l, acc[G, dh]) in f32 to
// scratch, and the last block to finish for its (slot, head) — a
// __threadfence and an atomic ticket, which that block resets — merges
// them: M = max m_i, weights exp(m_i - M) (a split that saw no live key
// keeps m = NEG_INF, l = 0 and weighs nothing), then normalises, scales
// and stores.  One launch per decode step and layer, as before.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// K/V ring depth per warp, in table columns: three for 1- and 2-byte
// pools, two for f32 (whose pages are twice the size)
template <typename TKV>
__host__ __device__ constexpr int stages() {
  return sizeof(TKV) == 4 ? 2 : 3;
}
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ bool key_valid(int kslot, int pos, int cap,
                                          int window) {
  if (window > 0) {
    const int age = (((pos % cap) - kslot) % cap + cap) % cap;
    return age < min(window, pos + 1);
  }
  return kslot <= pos;
}

// Some key of column w is valid.  Ring: the column's ages are
// a0, a0 - 1, ..., a0 - bs + 1 (mod cap) with a0 the age of its first
// slot, so the least is max(a0 - bs + 1, 0), and min(window, pos + 1) >= 1.
// Mirrored by kernels/paged_attn.py::live_columns.
__device__ __forceinline__ bool column_live(int w, int pos, int bs, int cap,
                                            int window) {
  if (window > 0) {
    const int a0 = (((pos % cap) - w * bs) % cap + cap) % cap;
    return a0 - (bs - 1) < min(window, pos + 1);
  }
  return w * bs <= pos;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// 8 consecutive elements (16-byte aligned for f32 and bf16, 8-byte for
// int8) from shared or global memory, as f32
__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
  x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const int8_t* p, float (&x)[8]) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  const int8_t* c = reinterpret_cast<const int8_t*>(&r);
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = static_cast<float>(c[i]);
}

// Sum GM per-lane values over the 16 lanes of a half-warp, halving the
// values at each step (reduce-scatter): lane `sub` ends with the full sum
// of row sub / (16 / GM), in 15 shuffles or fewer for GM <= 16.
template <int GM>
__device__ __forceinline__ float row_sums16(float (&v)[GM], int sub) {
  int n = GM;
#pragma unroll
  for (int bit = 8; bit >= 1; bit >>= 1) {
    if (n > 1) {
      const int half = n / 2;
      const bool up = (sub & bit) != 0;
#pragma unroll
      for (int i = 0; i < GM / 2; ++i) {
        if (i < half) {
          const float send = up ? v[i] : v[i + half];
          const float keep = up ? v[i + half] : v[i];
          v[i] = keep + __shfl_xor_sync(0xffffffffu, send, bit);
        }
      }
      n = half;
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], bit);
    }
  }
  return v[0];
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared memory: each walker's K/V ring (stage s: K page, then V page,
// each bs*dh elements of TKV), which after the walk holds the walkers' P V
// sums [kWarps / RW][G][dh] f32; then each warp's scores and then
// probabilities [bs][GM] (rows past its group stay zero) and its corr, m,
// l [GM]; then the last-block flag.  GM: query rows a warp holds (its
// group has ceil(G / RW)); NC: 8-column chunks of q a lane holds per row
// (dh <= 128 * NC); RW: warps a walker (row groups); STAGES: ring depth
// per walker, in table columns.
template <typename TQ, typename TKV, int GM, int NC, int RW>
__global__ void __launch_bounds__(kThreads, GM * NC == 8 ? 2 : 1)
    paged_split_kernel(const TQ* __restrict__ q, const TKV* __restrict__ ck,
                       const TKV* __restrict__ cv,
                       const int32_t* __restrict__ table,
                       const int32_t* __restrict__ pos_b, TQ* __restrict__ out,
                       float* __restrict__ part_acc,
                       float* __restrict__ part_ml, int* __restrict__ tickets,
                       int KV, int G, int dh, int bs, int W, int window,
                       int n_split, int cols, float scale, float out_scale) {
  constexpr int STAGES = stages<TKV>();
  constexpr int CH = 16 * NC;               // P V: lanes per key group
  constexpr int NKG = 32 / CH;              // P V: key groups per warp
  constexpr int LPR = 32 / GM;              // softmax: lanes per row
  constexpr int KP = GM * NC == 8 ? 4 : 1;  // scores: keys a half-warp
  constexpr int NW = kWarps / RW;           // walkers
  extern __shared__ __align__(16) unsigned char smem[];
  const int page = bs * dh;
  const int chunks = dh / 8;                // 8-column chunks of a row
  const size_t ring_bytes =
      static_cast<size_t>(NW) * STAGES * 2 * page * sizeof(TKV);
  const size_t red_bytes = sizeof(float) * NW * G * dh;
  const int wstride = bs * GM + 3 * GM;     // floats of a warp's state
  float* red = reinterpret_cast<float*>(smem);
  float* states = reinterpret_cast<float*>(
      smem + (ring_bytes > red_bytes ? ring_bytes : red_bytes));
  int* last = reinterpret_cast<int*>(states + kWarps * wstride);

  const int bh = blockIdx.x;
  const int b = bh / KV, h = bh % KV;
  const int split = blockIdx.y;
  const int w_lo = split * cols, w_hi = min(W, w_lo + cols);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int pos = pos_b[b];
  const int cap = W * bs;
  // this warp's walker and row group: rows [row0, row0 + GR) of q
  const int walker = warp / RW, rg = warp % RW;
  const int GG = (G + RW - 1) / RW;         // rows a group
  const int row0 = rg * GG;
  const int GR = max(0, min(GG, G - row0));
  const size_t qbase = static_cast<size_t>(bh) * G * dh;
  const size_t qrow = qbase + static_cast<size_t>(row0) * dh;

  TKV* ring = reinterpret_cast<TKV*>(smem) +
              static_cast<size_t>(walker) * STAGES * 2 * page;
  float* p_w = states + warp * wstride;     // [bs][GM]
  float* c_w = p_w + bs * GM;               // [GM]
  float* m_w = c_w + GM;                    // [GM]
  float* l_w = m_w + GM;                    // [GM]

  // scores: a half-warp per key, lane `sub` holding chunks sub + 16 j of
  // every query row in registers
  const int sub = lane % 16;
  float qr[NC][GM][8];
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int c = sub + 16 * j;
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (c < chunks && g < GR) {
        load8(q + qrow + g * dh + 8 * c, qr[j][g]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) qr[j][g][e] = 0.f;
      }
    }
  }
  for (int i = lane; i < bs * GM; i += 32) p_w[i] = 0.f;
  for (int g = lane; g < GM; g += 32) {
    c_w[g] = 1.f;
    m_w[g] = kNegInf;
    l_w[g] = 0.f;
  }
  // P V: lane (pc, kg) sums keys kg, kg + NKG, ... into all GM rows of
  // its 8-column chunk pc
  const int pc = lane % CH, kg = lane / CH;
  float acc[GM][8];
#pragma unroll
  for (int g = 0; g < GM; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;

  // this walker's columns: w_lo + walker, then every NW-th, the dead ones
  // skipped (a live prefix or a live ring arc falls evenly on the walkers)
  auto next_mine = [&](int w) {
    while (w < w_hi && !column_live(w, pos, bs, cap, window)) w += NW;
    return w;
  };
  // a column's pool block id, loaded one issue ahead of its use
  auto phys_of = [&](int w) {
    return w < w_hi ? __ldg(table + static_cast<size_t>(b) * W + w) : 0;
  };
  const int chunks16 = page * static_cast<int>(sizeof(TKV)) / 16;
  auto issue = [&](int phys, int stage) {
    const size_t off = (static_cast<size_t>(phys) * KV + h) * page;
    const char* kp = reinterpret_cast<const char*>(ck + off);
    const char* vp = reinterpret_cast<const char*>(cv + off);
    const uint32_t kd = static_cast<uint32_t>(
        __cvta_generic_to_shared(ring + 2 * stage * page));
    const uint32_t vd = kd + page * sizeof(TKV);
    for (int i = rg * 32 + lane; i < chunks16; i += 32 * RW) {
      cp_async16(kd + 16 * i, kp + 16 * i);
      cp_async16(vd + 16 * i, vp + 16 * i);
    }
  };
  // every lane of the walker: its copies of a column landed, and the
  // previous column is done with
  auto walker_sync = [&]() {
    if constexpr (RW == 1) {
      __syncwarp();
    } else {
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + walker), "r"(32 * RW)
                   : "memory");
    }
  };

  // prologue: this walker's first STAGES - 1 live columns in flight
  int w_next = next_mine(w_lo + walker);
  int p_next = phys_of(w_next);
  const int w_first = w_next;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (w_next < w_hi) {
      issue(p_next, s);
      w_next = next_mine(w_next + NW);
      p_next = phys_of(w_next);
    }
    cp_commit();
  }

  int stage = 0;
  for (int w = w_first; w < w_hi; w = next_mine(w + NW)) {
    cp_wait<STAGES - 2>();   // this lane's copies of column w landed
    walker_sync();           // every lane's; the previous column is done
    if (w_next < w_hi) {
      issue(p_next, (stage + STAGES - 1) % STAGES);
      w_next = next_mine(w_next + NW);
      p_next = phys_of(w_next);
    }
    cp_commit();
    const TKV* k_s = ring + 2 * stage * page;
    const TKV* v_s = k_s + page;

    // scores: keys t0 + 2 u + lane / 16 for u < KP, all rows at once (KP
    // keys a half-warp, so their shuffles overlap)
    for (int t0 = 0; t0 < bs; t0 += 2 * KP) {
      float v[KP][GM];
#pragma unroll
      for (int u = 0; u < KP; ++u) {
#pragma unroll
        for (int g = 0; g < GM; ++g) v[u][g] = 0.f;
        const int t = t0 + 2 * u + lane / 16;
        if (t < bs) {
#pragma unroll
          for (int j = 0; j < NC; ++j) {
            const int c = sub + 16 * j;
            if (c < chunks) {
              float kx[8];
              load8(k_s + t * dh + 8 * c, kx);
#pragma unroll
              for (int g = 0; g < GM; ++g)
#pragma unroll
                for (int e = 0; e < 8; ++e)
                  v[u][g] = fmaf(qr[j][g][e], kx[e], v[u][g]);
            }
          }
        }
      }
      float dot[KP];
#pragma unroll
      for (int u = 0; u < KP; ++u) dot[u] = row_sums16<GM>(v[u], sub);
      const int g = sub / (16 / GM);
#pragma unroll
      for (int u = 0; u < KP; ++u) {
        const int t = t0 + 2 * u + lane / 16;
        if (t < bs && sub % (16 / GM) == 0 && g < GR)
          p_w[t * GM + g] = key_valid(w * bs + t, pos, cap, window)
                                ? dot[u] * scale
                                : kNegInf;
      }
    }
    __syncwarp();

    // (m, l): every row at once, LPR lanes a row
    {
      const int g = lane / LPR, ls = lane % LPR;
      const bool row = g < GR;
      float mx = kNegInf;
      if (row)
        for (int t = ls; t < bs; t += LPR) mx = fmaxf(mx, p_w[t * GM + g]);
#pragma unroll
      for (int o = LPR / 2; o >= 1; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = row ? m_w[g] : 0.f;
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      if (row)
        for (int t = ls; t < bs; t += LPR) {
          const float p = expf(p_w[t * GM + g] - m_new);
          p_w[t * GM + g] = p;
          sum += p;
        }
#pragma unroll
      for (int o = LPR / 2; o >= 1; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      __syncwarp();
      if (row && ls == 0) {
        const float corr = expf(m_old - m_new);
        c_w[g] = corr;
        l_w[g] = l_w[g] * corr + sum;
        m_w[g] = m_new;
      }
    }
    __syncwarp();

    // acc = acc * corr + p @ v over this lane's keys of the column; a row
    // whose max did not move (corr == 1) skips its rescale
    if (pc < chunks) {
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        const float corr = c_w[g];
        if (corr != 1.f) {
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[g][e] *= corr;
        }
      }
      for (int t = kg; t < bs; t += NKG) {
        float vx[8];
        load8(v_s + t * dh + 8 * pc, vx);
        float p[GM];
#pragma unroll
        for (int g4 = 0; g4 < GM / 4; ++g4) {
          const float4 p4 = reinterpret_cast<const float4*>(p_w + t * GM)[g4];
          p[4 * g4] = p4.x, p[4 * g4 + 1] = p4.y;
          p[4 * g4 + 2] = p4.z, p[4 * g4 + 3] = p4.w;
        }
#pragma unroll
        for (int g = 0; g < GM; ++g)
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(p[g], vx[e], acc[g][e]);
      }
    }
    stage = (stage + 1) % STAGES;
  }
  cp_wait<0>();

  // the warp's key groups meet, then the warps: their states' rows
  // weigh exp(m_w - M), as in a merge of splits
  if constexpr (NKG == 2) {
#pragma unroll
    for (int g = 0; g < GM; ++g)
#pragma unroll
      for (int e = 0; e < 8; ++e)
        acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], 16);
  }
  __syncthreads();   // every ring is free: it becomes the walkers' sums
  if (kg == 0 && pc < chunks) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g < GR) {
        float4* r = reinterpret_cast<float4*>(
            red + (walker * G + row0 + g) * dh + 8 * pc);
        r[0] = make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
        r[1] = make_float4(acc[g][4], acc[g][5], acc[g][6], acc[g][7]);
      }
    }
  }
  __syncthreads();

  // (row, chunk) items: the block's state, then the output or the partial
  const int n_items = G * chunks;
  const size_t part = static_cast<size_t>(bh) * n_split + split;
  for (int item = tid; item < n_items; item += kThreads) {
    const int g = item / chunks, c = item - g * chunks;
    const int gw = g / GG, gl = g - gw * GG;  // row group, row in it
    float M = kNegInf;
#pragma unroll
    for (int k = 0; k < NW; ++k)
      M = fmaxf(M, states[(k * RW + gw) * wstride + bs * GM + GM + gl]);
    float L = 0.f, a[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) a[e] = 0.f;
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      const float* st = states + (k * RW + gw) * wstride + bs * GM;
      const float wgt = expf(st[GM + gl] - M);
      L += st[2 * GM + gl] * wgt;
      const float4* r =
          reinterpret_cast<const float4*>(red + (k * G + g) * dh + 8 * c);
      const float4 x = r[0], y = r[1];
      a[0] += x.x * wgt, a[1] += x.y * wgt, a[2] += x.z * wgt;
      a[3] += x.w * wgt, a[4] += y.x * wgt, a[5] += y.y * wgt;
      a[6] += y.z * wgt, a[7] += y.w * wgt;
    }
    if (n_split == 1) {
      const float den = fmaxf(L, 1e-30f);
      TQ* o = out + qbase + g * dh + 8 * c;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        o[e] = xnor::from_f32<TQ>(a[e] / den * out_scale);
    } else {
      float4* pa = reinterpret_cast<float4*>(part_acc +
                                             (part * G + g) * dh + 8 * c);
      pa[0] = make_float4(a[0], a[1], a[2], a[3]);
      pa[1] = make_float4(a[4], a[5], a[6], a[7]);
      if (c == 0) {
        part_ml[(part * G + g) * 2] = M;
        part_ml[(part * G + g) * 2 + 1] = L;
      }
    }
  }
  if (n_split == 1) return;
  __threadfence();
  __syncthreads();
  if (tid == 0) *last = atomicAdd(&tickets[bh], 1) == n_split - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();

  // the last block merges every split of (b, h): a warp per row finds
  // M = max m_i and L = sum l_i exp(m_i - M), and leaves each split's
  // weight exp(m_i - M) in place of its m_i
  float* l_row = red;                       // [G], the rows' L
  const size_t first = static_cast<size_t>(bh) * n_split;
  for (int g = warp; g < G; g += kWarps) {
    float mx = kNegInf;
    for (int i = lane; i < n_split; i += 32)
      mx = fmaxf(mx, __ldcg(part_ml + ((first + i) * G + g) * 2));
    const float M = warp_max(mx);
    float L = 0.f;
    for (int i = lane; i < n_split; i += 32) {
      float* ml = part_ml + ((first + i) * G + g) * 2;
      const float wgt = expf(__ldcg(ml) - M);
      L += __ldcg(ml + 1) * wgt;
      ml[0] = wgt;
    }
    L = xnor::warp_sum(L);
    if (lane == 0) l_row[g] = L;
  }
  __syncthreads();
  for (int item = tid; item < n_items; item += kThreads) {
    const int g = item / chunks, c = item - g * chunks;
    float a[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) a[e] = 0.f;
#pragma unroll 4
    for (int i = 0; i < n_split; ++i) {
      const size_t pi = (first + i) * G + g;
      const float wgt = __ldcg(part_ml + 2 * pi);
      const float4* pa =
          reinterpret_cast<const float4*>(part_acc + pi * dh + 8 * c);
      const float4 x = __ldcg(pa), y = __ldcg(pa + 1);
      a[0] += x.x * wgt, a[1] += x.y * wgt, a[2] += x.z * wgt;
      a[3] += x.w * wgt, a[4] += y.x * wgt, a[5] += y.y * wgt;
      a[6] += y.z * wgt, a[7] += y.w * wgt;
    }
    const float den = fmaxf(l_row[g], 1e-30f);
    TQ* o = out + qbase + g * dh + 8 * c;
#pragma unroll
    for (int e = 0; e < 8; ++e)
      o[e] = xnor::from_f32<TQ>(a[e] / den * out_scale);
  }
  if (tid == 0) tickets[bh] = 0;   // ready for the next launch
}

template <typename TQ, typename TKV, int GM, int NC, int RW>
int launch_gm(const void* q, const void* ck, const void* cv,
              const int32_t* table, const int32_t* pos, void* out,
              float* part_acc, float* part_ml, int* tickets, int B, int KV,
              int G, int dh, int bs, int W, int window, int n_split, int cols,
              float scale, float out_scale, cudaStream_t s) {
  constexpr int NW = kWarps / RW;
  const size_t ring = static_cast<size_t>(NW) * stages<TKV>() * 2 * bs * dh *
                      sizeof(TKV);
  const size_t red = sizeof(float) * NW * G * dh;
  const size_t smem =
      (ring > red ? ring : red) +
      sizeof(float) * kWarps * (static_cast<size_t>(bs) * GM + 3 * GM) + 16;
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_split_kernel<TQ, TKV, GM, NC, RW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(B * KV, n_split);
  paged_split_kernel<TQ, TKV, GM, NC, RW><<<grid, kThreads, smem, s>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(ck),
      static_cast<const TKV*>(cv), table, pos, static_cast<TQ*>(out),
      part_acc, part_ml, tickets, KV, G, dh, bs, W, window, n_split, cols,
      scale, out_scale);
  return static_cast<int>(cudaGetLastError());
}

// Instances: dh <= 128: one row group of up to 8 or 16 rows.  dh <= 256:
// one group of up to 8 rows (1- and 2-byte pools), or two groups of up to
// 8 rows each (G <= 16, and f32 pools at any G, whose four-warp ring
// would not fit).
template <typename TQ, typename TKV>
int launch(const void* q, const void* ck, const void* cv, const int32_t* table,
           const int32_t* pos, void* out, float* part_acc, float* part_ml,
           int* tickets, int B, int KV, int G, int dh, int bs, int W,
           int window, int n_split, int cols, float scale, float out_scale,
           cudaStream_t s) {
  const size_t page_bytes = static_cast<size_t>(bs) * dh * sizeof(TKV);
  if (dh % 8 != 0 || dh > 256 || page_bytes % 16 != 0 || G < 1 || G > 16 ||
      !xnor::aligned16(ck) || !xnor::aligned16(cv))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dh > 128 && (G > 8 || sizeof(TKV) == 4))
    return launch_gm<TQ, TKV, 8, 2, 2>(q, ck, cv, table, pos, out, part_acc,
                                       part_ml, tickets, B, KV, G, dh, bs, W,
                                       window, n_split, cols, scale,
                                       out_scale, s);
  if (G > 8)
    return launch_gm<TQ, TKV, 16, 1, 1>(q, ck, cv, table, pos, out, part_acc,
                                        part_ml, tickets, B, KV, G, dh, bs, W,
                                        window, n_split, cols, scale,
                                        out_scale, s);
  if (dh > 128)
    return launch_gm<TQ, TKV, 8, 2, 1>(q, ck, cv, table, pos, out, part_acc,
                                       part_ml, tickets, B, KV, G, dh, bs, W,
                                       window, n_split, cols, scale,
                                       out_scale, s);
  return launch_gm<TQ, TKV, 8, 1, 1>(q, ck, cv, table, pos, out, part_acc,
                                     part_ml, tickets, B, KV, G, dh, bs, W,
                                     window, n_split, cols, scale, out_scale,
                                     s);
}

template <typename TQ>
int dispatch_kv(int kv_dtype, const void* q, const void* ck, const void* cv,
                const int32_t* table, const int32_t* pos, void* out,
                float* part_acc, float* part_ml, int* tickets, int B, int KV,
                int G, int dh, int bs, int W, int window, int n_split,
                int cols, float scale, float out_scale, cudaStream_t s) {
  switch (kv_dtype) {
    case xnor::kF32:
      return launch<TQ, float>(q, ck, cv, table, pos, out, part_acc, part_ml,
                               tickets, B, KV, G, dh, bs, W, window, n_split,
                               cols, scale, out_scale, s);
    case xnor::kBF16:
      return launch<TQ, __nv_bfloat16>(q, ck, cv, table, pos, out, part_acc,
                                       part_ml, tickets, B, KV, G, dh, bs, W,
                                       window, n_split, cols, scale,
                                       out_scale, s);
    case xnor::kI8:
      return launch<TQ, int8_t>(q, ck, cv, table, pos, out, part_acc,
                                part_ml, tickets, B, KV, G, dh, bs, W, window,
                                n_split, cols, scale, out_scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B, KV, G, dh), out likewise; ck, cv (n_blocks, KV, bs, dh); table
// (B, W) and pos (B,) int32.  Columns split into n_split ranges of `cols`
// ((n_split - 1) * cols < W <= n_split * cols).  With n_split > 1:
// part_acc (B*KV*n_split*G*dh) and part_ml (B*KV*n_split*G*2) f32 scratch,
// and tickets (B*KV) int32, zero on entry and left zero.
extern "C" int paged_decode(const void* q, int q_dtype, const void* ck,
                            const void* cv, int kv_dtype, const void* table,
                            const void* pos, void* out, void* part_acc,
                            void* part_ml, void* tickets, int B, int KV,
                            int G, int dh, int bs, int W, int window,
                            int n_split, int cols, float scale,
                            float out_scale, void* stream) {
  if (B <= 0 || KV <= 0) return 0;
  if (W <= 0 || n_split <= 0 || cols <= 0 || n_split > 65535 ||
      static_cast<long long>(n_split - 1) * cols >= W ||
      static_cast<long long>(n_split) * cols < W ||
      (n_split > 1 &&
       (part_acc == nullptr || part_ml == nullptr || tickets == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* tbl = static_cast<const int32_t*>(table);
  const int32_t* p = static_cast<const int32_t*>(pos);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  int* tk = static_cast<int*>(tickets);
  switch (q_dtype) {
    case xnor::kF32:
      return dispatch_kv<float>(kv_dtype, q, ck, cv, tbl, p, out, pa, pm, tk,
                                B, KV, G, dh, bs, W, window, n_split, cols,
                                scale, out_scale, s);
    case xnor::kBF16:
      return dispatch_kv<__nv_bfloat16>(kv_dtype, q, ck, cv, tbl, p, out, pa,
                                        pm, tk, B, KV, G, dh, bs, W, window,
                                        n_split, cols, scale, out_scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
