// AttnCon column sums: col[b, j] = sum_{h, i} softmax(q k^T / sqrt(Dh))[i, j]
// over the query heads h and queries i, without ever forming the T x T
// attention map; causal (a decoder's self-attention) or not (an
// encoder's), a template flag C of both passes.
//
// Replaces: attn_colsum_pallas in src/repro/kernels/attn_colsum/kernel.py
// (its two pallas_calls, _rowstats_kernel and _colsum_kernel, and their
// static `causal`).
//
// What bounds it on the H100: operations.  The function needs q k^T once,
// its causal half B·H·T(T+1)/2·Dh multiply-adds (non-causal: B·H·T²·Dh),
// and an exp per score,
// on 2·T·Dh input values per head.  fp32 q and k are held to 1e-4, so the
// least time is that product at the cheapest fp32-accurate tensor-core
// rate: each operand as three bf16 terms, the six term products i + j < 3
// at the bf16 rate (bf16 q and k: one exact product).  The two passes below
// compute it twice.
//
// Design: the TPU kernel's two passes, each a kernel on the tensor cores
// (mma.sync m16n8k16, bf16 in, fp32 sums), and a third that adds the
// passes' column pieces in a fixed order: no float atomics, so a call gives
// the same bits every time.  Each warp of a block holds a fixed operand of
// 16 rows as A fragments in registers (split once); the block streams the
// other operand in 64-row tiles: cp.async 16-byte copies of the raw rows
// into shared memory (the next tile's in flight while this one is
// multiplied), split there once into bf16 terms (rows padded by 16 bytes:
// ldmatrix reads them without bank conflicts), B fragments by ldmatrix.x4.
// fp32 x = hi + mid + lo exactly to ~2^-24 (hopper.cuh split3); of the
// products, hi·hi goes to one accumulator and the five cross products to
// another, so the large sum takes one tensor-core add a k-step and no
// long run of truncating adds (the lesson of gram, PR 18).
// A block has 8 warps for fp32 q and k and 4 for bf16 (measured: 8 are
// 7% faster at llama3-8b's heads and 33% at the MLA path's in fp32, where
// a lane's A fragments leave room for one block an SM; 4 are faster in
// bf16), 16 fixed rows a warp.
//   pass 1 (rowstats): a block takes the n_rep query heads that share a
//     key head (4 of them, or 2, or 1: hb) at 16·warps / hb query
//     positions, so each key tile is loaded once for all of them; warp w
//     holds 16 rows (one head, 16 positions) and keeps, per query, the
//     running max and denominator (log2 domain) over key tiles up to the
//     diagonal (non-causal: over every key tile).
//   pass 2 (colsum): a block takes 16·warps keys of one key head, warp w
//     its 16 keys as the fixed operand, and streams the query tiles at or
//     below the diagonal (non-causal: every query tile) of every query
//     head of the group: Sᵀ = K Qᵀ, so
//     a key's column sum is a row sum inside the warp (over the lane's
//     columns, then a fixed butterfly over the 4 lanes of a row).  The
//     (head, query tile) items of a key block are dealt to Z blocks in
//     turn (Z from the launcher's plan, for the card's SMs); each block
//     writes its own piece of the (B, KV·Z, T) scratch.  Z counts blocks,
//     not work: the non-causal form's key blocks all hold the same items
//     (n_rep x every query tile, twice the causal form's average), so
//     dealing them in turn already balances them, and the same plan (and
//     scratch size) serves both forms.
//   pass 3: col[b, j] = the pieces of (b, j) added in (key head, z) order.
// Measured (chip_smoke.py on an H100 80GB HBM3 at 700 W, fp32 q and k,
// B 4, T 512): 0.24 ms at llama3-8b's heads (32 on 8, Dh 128) against the
// materialised softmax's 0.80 and a 0.026 ms bound; 1.32 ms at the MLA
// path's (128 on 128, Dh 192) against 3.62 and 0.157.  What holds it back:
// mma.sync issue with one block an SM at Dh 192 (one kernel spills 184
// bytes), and the tile split and the score epilogue in series with the
// products.
// Ragged T and Dh are masked (zero rows and columns); Dh up to 192 (the
// A fragments of 16 rows of 192 fp32 values in three terms take 144
// registers a lane).  GQA: query head h reads key head h / n_rep straight
// from the (B, T, KV, Dh) layout.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>
#include <cmath>

#include "hopper.cuh"

namespace {

// warps a block, 16 fixed rows each: 8 for fp32 q and k (three terms;
// measured faster at both shapes), 4 for bf16 (one term; faster there)
__host__ __device__ constexpr int warps_for(int nt) {
  return nt == 3 ? 8 : 4;
}
constexpr int TILE = 64;       // rows of a streamed tile
constexpr int MAX_KS = 12;     // k16 steps: Dh <= 192
constexpr int MAX_Z = 4;       // pass 2 blocks a key tile
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

struct Geo {
  int B, T, H, KV, Dh, n_rep, hb;
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a · b, m16n8k16, bf16 in, fp32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// Shared memory of a block: the raw streamed tile (TILE rows of KS·16
// values of T, zero past Dh), its NT bf16 terms (rows KS·16 + 8 values
// apart), and the tile's (max, 1 / denominator) per row (pass 2).
template <typename T, int KS, int NT> struct Smem {
  static constexpr int RP = KS * 16;      // raw row pitch, values
  static constexpr int PITCH = RP + 8;    // term row pitch, bf16 values
  static constexpr int RAW = TILE * RP * sizeof(T);
  static constexpr int TERMS = NT * TILE * PITCH * 2;
  static constexpr int BYTES = RAW + TERMS + TILE * 8;
  // n-tiles of 8 streamed rows a warp multiplies at once
  static constexpr int NJ = 4;
};

// The warp's fixed operand: rows r0 (lane row g) and r1 (g + 8), null past
// T, split into NT terms of A fragments, zero past Dh.
template <typename T, int KS, int NT>
__device__ __forceinline__ void load_fixed(uint32_t (&af)[KS][NT][4],
                                           const T* r0, const T* r1, int Dh) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int s = 0; s < KS; ++s)
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int ri = 0; ri < 2; ++ri) {
        const T* row = ri ? r1 : r0;
        const int d = 16 * s + 8 * half + 2 * t;
        const float x0 = row != nullptr && d < Dh ? to_f(row[d]) : 0.f;
        const float x1 = row != nullptr && d + 1 < Dh ? to_f(row[d + 1]) : 0.f;
        if constexpr (NT == 1) {
          af[s][0][ri + 2 * half] = pack_bf16(x0, x1);  // exact: x is bf16
        } else {
          uint32_t tr[SPLIT_TERMS];
          split3(x0, x1, tr);
#pragma unroll
          for (int i = 0; i < NT; ++i) af[s][i][ri + 2 * half] = tr[i];
        }
      }
}

// Copy the streamed tile's rows (row(i) -> its Dh values, or null) into
// raw: 16-byte cp.async when vec (rows 16-byte aligned), else plain loads;
// `any` is a global address for the zero-filling copies, which read none.
template <typename T, int KS, int NT, typename RowFn>
__device__ __forceinline__ void issue_tile(unsigned char* smem, RowFn row,
                                           const T* any, int Dh, int vec) {
  using S = Smem<T, KS, NT>;
  T* raw = reinterpret_cast<T*>(smem);
  constexpr int E = 16 / sizeof(T);          // values a chunk
  constexpr int CPR = S::RP / E;             // chunks a row
  constexpr int THREADS = 32 * warps_for(NT);
  if (vec) {
    const uint32_t base = smem_u32(raw);
    for (int idx = threadIdx.x; idx < TILE * CPR; idx += THREADS) {
      const int i = idx / CPR, c = idx % CPR;
      const T* src = row(i);
      const bool ok = src != nullptr && c * E < Dh;
      cp_async16(base + (i * S::RP + c * E) * sizeof(T),
                 ok ? src + c * E : any,
                 ok ? 16 : 0);
    }
    cp_async_commit();
  } else {
    for (int idx = threadIdx.x; idx < TILE * S::RP; idx += THREADS) {
      const int i = idx / S::RP, d = idx % S::RP;
      const T* src = row(i);
      raw[idx] = src != nullptr && d < Dh ? src[d] : T(0.f);
    }
  }
}

// raw -> the NT bf16 terms (every thread; raw is complete and visible)
template <typename T, int KS, int NT>
__device__ __forceinline__ void split_tile(unsigned char* smem) {
  using S = Smem<T, KS, NT>;
  constexpr int THREADS = 32 * warps_for(NT);
  unsigned char* terms = smem + S::RAW;
  if constexpr (NT == 1) {  // bf16: 8 values at a time into the padded rows
    const uint4* raw = reinterpret_cast<const uint4*>(smem);
    for (int idx = threadIdx.x; idx < TILE * S::RP / 8; idx += THREADS) {
      const int i = idx / (S::RP / 8), c = idx % (S::RP / 8);
      *reinterpret_cast<uint4*>(terms + (i * S::PITCH + 8 * c) * 2) =
          raw[idx];
    }
  } else {
    const float4* raw = reinterpret_cast<const float4*>(smem);
    for (int idx = threadIdx.x; idx < TILE * S::RP / 4; idx += THREADS) {
      const int i = idx / (S::RP / 4), c = idx % (S::RP / 4);
      const float4 v = raw[idx];
      uint32_t lo[SPLIT_TERMS], hi[SPLIT_TERMS];
      split3(v.x, v.y, lo);
      split3(v.z, v.w, hi);
#pragma unroll
      for (int j = 0; j < NT; ++j)
        *reinterpret_cast<uint2*>(
            terms + ((j * TILE + i) * S::PITCH + 4 * c) * 2) =
            make_uint2(lo[j], hi[j]);
    }
  }
}

// Part h2 (NJ n-tiles of 8 rows) of the streamed tile against the warp's
// 16 fixed rows: sh = hi·hi, sx = the five cross products (fp32 x) over
// all k16 steps; n-tile j covers streamed rows 8·(NJ·h2 + j) .. + 7.
template <int KS, int NT, int NJ>
__device__ __forceinline__ void scores(float (&sh)[NJ][4], float (&sx)[NJ][4],
                                       const uint32_t (&af)[KS][NT][4],
                                       uint32_t terms, int pitch, int h2) {
  const int lane = threadIdx.x & 31, mat = lane >> 3, r = lane & 7;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sh[j][e] = sx[j][e] = 0.f;
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    // one B term at a time, with the A terms it meets (hi·hi into sh;
    // mid·hi, lo·hi, hi·mid, mid·mid, hi·lo into sx), each product over
    // the NJ n-tiles in turn: independent accumulators back to back
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      uint32_t bf[NJ / 2][4];
#pragma unroll
      for (int jp = 0; jp < NJ / 2; ++jp) {
        const int row = i * TILE + 8 * NJ * h2 + 16 * jp + 8 * (mat >> 1) + r;
        ldsm_x4(bf[jp], terms + (row * pitch + 16 * s + 8 * (mat & 1)) * 2);
      }
      // the A terms this B term meets: i = 0: hi, mid, lo; 1: hi, mid; 2: hi
#pragma unroll
      for (int ia = 0; ia < NT - i; ++ia)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          float (&d)[4] = i == 0 && ia == 0 ? sh[j] : sx[j];
          mma_bf16(d, af[s][ia], bf[j >> 1][2 * (j & 1)],
                   bf[j >> 1][2 * (j & 1) + 1]);
        }
    }
  }
}

// Pass 1.  Grid (B·H/hb, ceil(T / qb)), qb = 16·warps / hb query
// positions; the last query tiles (causal: the most key tiles) first.  Warp w:
// head h0 + w % hb, positions q0 + 16·(w / hb) + 0..15.
// ml[(b·H + h)·T + p] = (max in log2 units, denominator).
template <typename T, int KS, int NT, bool C>
__global__ void __launch_bounds__(32 * warps_for(NT),
                                  KS <= 8 && warps_for(NT) == 4 ? 2 : 1)
rowstats_kernel(const T* __restrict__ q, const T* __restrict__ k,
                float2* __restrict__ ml, Geo g, float sl2, int vec) {
  using S = Smem<T, KS, NT>;
  constexpr int NJ = S::NJ;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, t = lane & 3;
  constexpr int FIXED = 16 * warps_for(NT);  // fixed rows a block
  const int qb = FIXED / g.hb;
  const int groups = g.H / g.hb;
  const int b = blockIdx.x / groups, h0 = (blockIdx.x % groups) * g.hb;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * qb;
  const int h = h0 + warp % g.hb, kvh = h0 / g.n_rep;
  const int p0 = q0 + 16 * (warp / g.hb);  // the warp's first position
  const size_t qs = (size_t)g.H * g.Dh, ks = (size_t)g.KV * g.Dh;
  const T* qh = q + ((size_t)b * g.T * g.H + h) * g.Dh;
  const T* kh = k + ((size_t)b * g.T * g.KV + kvh) * g.Dh;

  uint32_t af[KS][NT][4];
  load_fixed<T, KS, NT>(af, p0 + gr < g.T ? qh + (p0 + gr) * qs : nullptr,
                        p0 + gr + 8 < g.T ? qh + (p0 + gr + 8) * qs : nullptr,
                        g.Dh);
  const int n_kt = ((C ? min(g.T, q0 + qb) : g.T) - 1) / TILE + 1;
  auto key_row = [&](int kt) {
    return [=](int i) -> const T* {
      const int j = kt * TILE + i;
      return j < g.T ? kh + j * ks : nullptr;
    };
  };
  const uint32_t terms = smem_u32(smem + S::RAW);
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  issue_tile<T, KS, NT>(smem, key_row(0), kh, g.Dh, vec);
  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait_all();
    __syncthreads();  // tile kt landed; every warp is done with the terms
    split_tile<T, KS, NT>(smem);
    __syncthreads();
    if (kt + 1 < n_kt)
      issue_tile<T, KS, NT>(smem, key_row(kt + 1), kh, g.Dh, vec);
#pragma unroll
    for (int h2 = 0; h2 < 8 / NJ; ++h2) {
      const int key0 = kt * TILE + 8 * NJ * h2;
      // all masked: warp-uniform
      if ((C && key0 > p0 + 15) || key0 >= g.T) continue;
      float sh[NJ][4], sx[NJ][4];
      scores<KS, NT, NJ>(sh, sx, af, terms, S::PITCH, h2);
#pragma unroll
      for (int ri = 0; ri < 2; ++ri) {
        const int p = p0 + gr + 8 * ri;
        float v[2 * NJ], mx = NEG;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = key0 + 8 * j + 2 * t + e;
            const float sv = (sh[j][2 * ri + e] + sx[j][2 * ri + e]) * sl2;
            v[2 * j + e] = (!C || key <= p) && key < g.T ? sv : NEG;
            mx = fmaxf(mx, v[2 * j + e]);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[ri], mx);
        float ps = 0.f;
#pragma unroll
        for (int e = 0; e < 2 * NJ; ++e) ps += exp2f(v[e] - m_new);
        ps += __shfl_xor_sync(0xffffffffu, ps, 1);
        ps += __shfl_xor_sync(0xffffffffu, ps, 2);
        l[ri] = l[ri] * exp2f(m[ri] - m_new) + ps;
        m[ri] = m_new;
      }
    }
  }
  if (t == 0) {
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      const int p = p0 + gr + 8 * ri;
      if (p < g.T)
        ml[((size_t)b * g.H + h) * g.T + p] = make_float2(m[ri], l[ri]);
    }
  }
}

// Pass 2.  Grid (B·KV, ceil(T / F), Z), F = 16·warps: block (b·KV + kvh,
// kt, z) takes keys kt·F .. + F - 1 of key head kvh, warp w keys kt·F +
// 16w + 0..15 as its fixed rows, and the items (head hl of the group,
// 64-query tile qt >= qt0 = kt·F / 64, or every tile (qt0 = 0) when not
// causal), numbered hl·(n_qt - qt0) + qt - qt0, that are z mod Z.  Each key's sum runs
// over the items in order, then over its lane's columns in order, then the
// 4 lanes in a fixed butterfly; part[(b·KV·Z + kvh·Z + z)·T + key].
template <typename T, int KS, int NT, bool C>
__global__ void __launch_bounds__(32 * warps_for(NT),
                                  KS <= 8 && warps_for(NT) == 4 ? 2 : 1)
colsum_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const float2* __restrict__ ml, float* __restrict__ part, Geo g,
              float sl2, int vec) {
  using S = Smem<T, KS, NT>;
  constexpr int NJ = S::NJ;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / g.KV, kvh = blockIdx.x % g.KV;
  const int kt = blockIdx.y, z = blockIdx.z, Z = gridDim.z;
  constexpr int FIXED = 16 * warps_for(NT);  // fixed rows a block
  const int k0 = kt * FIXED + 16 * warp;  // the warp's first key
  const size_t qs = (size_t)g.H * g.Dh, ks = (size_t)g.KV * g.Dh;
  const T* kh = k + ((size_t)b * g.T * g.KV + kvh) * g.Dh;
  const T* qb = q + (size_t)b * g.T * g.H * g.Dh;

  uint32_t af[KS][NT][4];
  load_fixed<T, KS, NT>(af, k0 + gr < g.T ? kh + (k0 + gr) * ks : nullptr,
                        k0 + gr + 8 < g.T ? kh + (k0 + gr + 8) * ks : nullptr,
                        g.Dh);
  const int n_qt = (g.T - 1) / TILE + 1;
  // the first query tile: at the diagonal, or the first of all
  const int qt0 = C ? kt * FIXED / TILE : 0;
  const int per_head = n_qt - qt0;
  const int n_items = g.n_rep * per_head;
  auto query_row = [&](int it) {
    const int h = kvh * g.n_rep + it / per_head;
    const int qt = qt0 + it % per_head;
    return [=](int i) -> const T* {
      const int p = qt * TILE + i;
      return p < g.T ? qb + (size_t)p * qs + (size_t)h * g.Dh : nullptr;
    };
  };
  const uint32_t terms = smem_u32(smem + S::RAW);
  float2* st = reinterpret_cast<float2*>(smem + S::RAW + S::TERMS);
  float acc[2] = {0.f, 0.f};
  if (z < n_items) issue_tile<T, KS, NT>(smem, query_row(z), qb, g.Dh, vec);
  for (int it = z; it < n_items; it += Z) {
    const int h = kvh * g.n_rep + it / per_head;
    const int qt = qt0 + it % per_head;
    cp_async_wait_all();
    __syncthreads();  // tile `it` landed; every warp is done with the terms
    split_tile<T, KS, NT>(smem);
    if (threadIdx.x < TILE) {
      const int p = qt * TILE + threadIdx.x;
      float2 s = make_float2(0.f, 0.f);
      if (p < g.T) {
        const float2 v = ml[((size_t)b * g.H + h) * g.T + p];
        s = make_float2(v.x, 1.f / fmaxf(v.y, 1e-30f));
      }
      st[threadIdx.x] = s;
    }
    __syncthreads();
    if (it + Z < n_items)
      issue_tile<T, KS, NT>(smem, query_row(it + Z), qb, g.Dh, vec);
    if (k0 >= g.T) continue;  // this warp's keys lie past T
#pragma unroll
    for (int h2 = 0; h2 < 8 / NJ; ++h2) {
      const int qs0 = qt * TILE + 8 * NJ * h2;
      // all masked (queries before the warp's keys, or past T): uniform
      if ((C && qs0 + 8 * NJ - 1 < k0) || qs0 >= g.T) continue;
      float sh[NJ][4], sx[NJ][4];
      scores<KS, NT, NJ>(sh, sx, af, terms, S::PITCH, h2);
#pragma unroll
      for (int ri = 0; ri < 2; ++ri) {
        const int key = k0 + gr + 8 * ri;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 8 * (NJ * h2 + j) + 2 * t + e;  // row of the tile
            const int p = qt * TILE + i;
            const float2 s = st[i];
            const float sv = (sh[j][2 * ri + e] + sx[j][2 * ri + e]) * sl2;
            if ((!C || p >= key) && p < g.T)
              acc[ri] += exp2f(sv - s.x) * s.y;
          }
      }
    }
  }
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    float v = acc[ri];
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    const int key = k0 + gr + 8 * ri;
    if (t == 0 && key < g.T)
      part[((size_t)b * g.KV * Z + kvh * Z + z) * g.T + key] = v;
  }
}

// Pass 3: col[b, j] = part[b, 0, j] + part[b, 1, j] + ... in order
__global__ void sum_pieces(const float* __restrict__ part,
                           float* __restrict__ col, int B, int T,
                           int pieces) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * T) return;
  const int b = idx / T, j = idx % T;
  const float* p = part + (size_t)b * pieces * T + j;
  float v = 0.f;
  for (int s = 0; s < pieces; ++s) v += p[(size_t)s * T];
  col[idx] = v;
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 132;
  return n;
}

// pass 2's blocks a key block (Z), the launcher's plan: about four blocks
// an SM; a block holds `fixed` keys
int plan_z(int B, int T, int KV, int fixed) {
  const int blocks = B * KV * ((T - 1) / fixed + 1);
  return std::max(1, std::min(MAX_Z, (4 * sm_count() + blocks - 1) / blocks));
}

int heads_a_block(int n_rep) {
  return n_rep % 4 == 0 ? 4 : n_rep % 2 == 0 ? 2 : 1;
}

template <typename T, int KS, int NT, bool C>
int launch(const T* q, const T* k, float* scratch, float* col, const Geo& g,
           cudaStream_t s) {
  using S = Smem<T, KS, NT>;
  const float sl2 =
      static_cast<float>(1.4426950408889634 / sqrt(static_cast<double>(g.Dh)));
  const int vec = (g.Dh * sizeof(T)) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(k) % 16 == 0;
  int err = allow_smem(
      reinterpret_cast<const void*>(rowstats_kernel<T, KS, NT, C>), S::BYTES);
  if (err == 0)
    err = allow_smem(
        reinterpret_cast<const void*>(colsum_kernel<T, KS, NT, C>), S::BYTES);
  if (err != 0) return err;
  float2* ml = reinterpret_cast<float2*>(scratch);
  float* part = scratch + 2 * (size_t)g.B * g.H * g.T;
  constexpr int THREADS = 32 * warps_for(NT), FIXED = 16 * warps_for(NT);
  const int qb = FIXED / g.hb;
  const dim3 grid1(g.B * (g.H / g.hb), (g.T + qb - 1) / qb);
  rowstats_kernel<T, KS, NT, C><<<grid1, THREADS, S::BYTES, s>>>(q, k, ml, g,
                                                                 sl2, vec);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int Z = plan_z(g.B, g.T, g.KV, FIXED);
  const dim3 grid2(g.B * g.KV, (g.T - 1) / FIXED + 1, Z);
  colsum_kernel<T, KS, NT, C><<<grid2, THREADS, S::BYTES, s>>>(
      q, k, ml, part, g, sl2, vec);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  sum_pieces<<<(g.B * g.T + 255) / 256, 256, 0, s>>>(part, col, g.B, g.T,
                                                     g.KV * Z);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NT, bool C>
int launch_ks(const void* q, const void* k, float* scratch, float* col,
              const Geo& g, cudaStream_t s) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  if (g.Dh <= 64) return launch<T, 4, NT, C>(qt, kt, scratch, col, g, s);
  if (g.Dh <= 128) return launch<T, 8, NT, C>(qt, kt, scratch, col, g, s);
  return launch<T, MAX_KS, NT, C>(qt, kt, scratch, col, g, s);
}

template <bool C>
int launch_type(const void* q, const void* k, int bf16, float* scratch,
                float* col, const Geo& g, cudaStream_t s) {
  if (bf16) return launch_ks<__nv_bfloat16, 1, C>(q, k, scratch, col, g, s);
  return launch_ks<float, SPLIT_TERMS, C>(q, k, scratch, col, g, s);
}

}  // namespace

// Floats of scratch attn_colsum_launch needs: the row stats (2·B·H·T) and
// pass 2's column pieces (B·KV·Z·T, Z the launcher's plan).  The one owner
// of both sizes.
extern "C" long attn_colsum_scratch(int B, int T, int H, int KV, int bf16) {
  const int fixed = 16 * warps_for(bf16 ? 1 : SPLIT_TERMS);
  return 2L * B * H * T +
         static_cast<long>(B) * KV * plan_z(B, T, KV, fixed) * T;
}

// q: (B, T, H, Dh), k: (B, T, KV, Dh), both fp32 (bf16 == 0) or bf16,
// contiguous, Dh <= 192 (else cudaErrorInvalidValue); causal: 1 for the
// causal map, 0 for the full one; scratch: the floats attn_colsum_scratch
// gives; col: (B, T) fp32, written (not accumulated).
extern "C" int attn_colsum_launch(const void* q, const void* k, int bf16,
                                  int causal, float* scratch, float* col,
                                  int B, int T, int H, int KV, int Dh,
                                  void* stream) {
  if (Dh < 1 || Dh > 16 * MAX_KS || T < 1 || KV < 1 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Geo g{B, T, H, KV, Dh, H / KV, heads_a_block(H / KV)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (causal) return launch_type<true>(q, k, bf16, scratch, col, g, s);
  return launch_type<false>(q, k, bf16, scratch, col, g, s);
}
