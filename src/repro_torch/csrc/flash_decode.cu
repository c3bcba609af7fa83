// Quantized-KV flash attention for Hopper (sm_90a): one-token decode over a
// flat or block-paged kv8/kv2 cache, and the chunked-prefill extend over
// paged past pages plus the chunk's own fp keys.
//
// Replaces the reference's Pallas kernels in
// src/repro/kernels/flash_decode/kernel.py:
//   flash_decode_pallas        (:125) -> fd_decode_kernel, tbl == nullptr
//   paged_flash_decode_pallas  (:207) -> fd_decode_kernel, tbl != nullptr
//   paged_flash_extend_pallas  (:323) -> fe_extend_kernel
//
// Decode.  Reads every live code and scale of the cache once per token:
// bound by bytes on paper, but at G = 4 each code costs 4 FMAs and its
// conversion, so in practice by instruction issue.  The TPU kernels carry
// (acc, m, l) across a sequential grid axis; here blocks run in no order.
// Each block (split, kv head, request) walks a fixed run of SPLIT_TILES
// tiles with the running triple in registers and shared memory, and
// fd_merge_kernel merges the splits in a fixed order, so the result is
// deterministic.  Splits are fixed runs of tiles whatever n_tiles, S or
// pos: the flat and the paged call partition a request's live tiles the
// same way, and at tile = page they are bitwise equal.  A block issues the
// 16-byte cp.async copies of all its tiles' K and V codes at once (a ring
// of SPLIT_TILES stages), so its second tile is in flight while the first
// computes.  Rows past pos, and past S for a flat cache, are never read;
// their scales are never read either and enter as zeros, and every masked
// score or probability is a select, so trash and stale page-table entries
// (even with inf/NaN scales) never reach the result.  Scores: the threads
// of a row take 16 codes each (16 int8 bytes, or one word of 2-bit codes)
// against queries held in registers and reduce their G partial dots in
// log2(threads per row) shuffles; each row's scale is applied to its dot
// product.  P.V: each warp takes every fourth row and each lane 4 head
// dims, reading V codes from shared memory as words; the V scale is folded
// into P.  int8 codes convert by byte-permute and magic-number
// subtraction, 2-bit codes by a byte-permute lookup of the level's sign and
// exponent.  The merge gives each (request, kv head, query) a block that
// computes the split weights once.
//
// Extend.  L*G query rows of one KV head against n_past*page + L keys: a
// small flash-attention forward pass, bound by operations.  Q.K^T and P.V
// run on the tensor cores (mma.sync m16n8k8, TF32) with operands that keep
// the fp32 result:
//   - Q.K^T on exact operands: the query unscaled in its own dtype, the K
//     codes (int8, or the 2-bit levels +-0.25, +-1) and bf16 keys are exact
//     in TF32; dh^-0.5 (with log2(e): the softmax runs in the log2 domain)
//     and each key row's scale multiply the fp32 score after the product.
//     fp32 queries and keys are split into a TF32 hi and lo term (hi.hi +
//     lo.hi + hi.lo).
//   - P.V with P split: each past row's V scale is folded into P in fp32,
//     P is split into TF32 hi + lo (about 22 bits) and both terms multiply
//     the exact V codes (or bf16 values; fp32 values split again).
//   - Each tile's P.V starts from zero in the tensor core and is added to
//     the running accumulator with one fp32 FMA (acc * alpha + tile): the
//     tensor core's accumulation never runs over more than a tile.
// A block takes 64 query rows and walks 32-key tiles: past pages through
// tbl, then the chunk's own keys up to its last row's token.  Two sets of
// 4 warps (16 rows each) take alternate tiles, each set with its own fp32
// tile buffers, and merge their running states at the end: 128 blocks
// (llama3-8b, L 256) then keep 8 warps on each SM, not 4.  Tiles stream
// into a cp.async ring one step ahead of the compute (past codes, or the
// chunk's bf16 rows) and are widened (codes only, no scale) into fp32
// shared memory; page-table entries and scales are fetched into registers
// a step ahead.  The causal edge and ragged tails are masked by select.
// With head dims above 128 one set runs (shared memory).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_G = 16;        // query heads per KV head
constexpr int MAX_D = 256;       // head dim
constexpr int SPLIT_TILES = 2;   // decode: tiles a block walks (a constant)
constexpr int XT_ROWS = 64;      // extend: query rows per block
constexpr int XT_KEYS = 32;      // extend: keys per tile
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float bf2f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// ---------------------------------------------------------------- copies

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The widest copy unit (16 or 4 bytes, else 1) that a row of ``bytes``
// bytes starting at ``base`` allows: every row start stays aligned.
__device__ __forceinline__ int copy_unit(const void* base, int bytes) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(base);
  if (bytes % 16 == 0 && a % 16 == 0) return 16;
  if (bytes % 4 == 0 && a % 4 == 0) return 4;
  return 1;
}

// Stage rows [0, nrows) of one matrix into shared rows of ``pitch`` bytes:
// row r starts at src_row(r).  16- and 4-byte units go by cp.async, single
// bytes (a head dim no multiple of 4) by plain loads.  Threads tid of n.
template <typename RowFn>
__device__ __forceinline__ void stage_rows(char* dst, int pitch, int nrows,
                                           int bytes, int unit,
                                           RowFn src_row, int tid, int n) {
  if (unit > 1) {
    const int per = bytes / unit;  // units of a row
    if (n % per == 0) {  // a thread keeps its unit: one division per call
      const int u = tid % per, step = n / per;
      for (int r = tid / per; r < nrows; r += step) {
        if (unit == 16)
          cp_async16(dst + r * pitch + 16 * u, src_row(r) + 16 * u);
        else
          cp_async4(dst + r * pitch + 4 * u, src_row(r) + 4 * u);
      }
    } else {
      for (int i = tid; i < nrows * per; i += n) {
        const int r = i / per, u = i % per;
        if (unit == 16)
          cp_async16(dst + r * pitch + 16 * u, src_row(r) + 16 * u);
        else
          cp_async4(dst + r * pitch + 4 * u, src_row(r) + 4 * u);
      }
    }
  } else {
    for (int i = tid; i < nrows * bytes; i += n) {
      const int r = i / bytes, u = i % bytes;
      dst[r * pitch + u] = src_row(r)[u];
    }
  }
}

// ------------------------------------------------------------ conversion

// Four int8 codes of a word -> floats: byte ^ 0x80 is the code + 128;
// under exponent 2^23 it is a float's low mantissa bits.
__device__ __forceinline__ void i8x4(uint32_t w, float f[4]) {
  const uint32_t x = w ^ 0x80808080u;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    f[k] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7540 + k)) -
           8388736.f;
}

// A 2-bit code -> its level {-1, -0.25, +0.25, +1}: the level's top byte
// is looked up by byte-permute (0xBF, 0xBE, 0x3E, 0x3F), the next is 0x80.
__device__ __forceinline__ float lvl2(uint32_t c) {
  return __uint_as_float((__byte_perm(0x3F3EBEBFu, 0u, c) << 24) |
                         0x00800000u);
}

// Four 2-bit codes (a byte, code k at bits [2k, 2k+2)) -> levels.
__device__ __forceinline__ void lv2x4(uint32_t byte, float f[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) f[k] = lvl2((byte >> (2 * k)) & 3u);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ------------------------------------------------------------------ decode

// Grid (n_split, KV, B).  q: (B, KV, G, Dh) fp32, scale folded in.
// Flat (tbl == nullptr): codes (B, S, KV, w), scales (B, SR, KV).
// Paged: codes (n_pages, tile, KV, w), scales (n_pages, tile / chunk, KV),
// tbl (B, n_tiles).  pos: (B,) last valid row of each request.  Writes
// this split's raw (acc, m, l).  GC: the query-group capacity, 4 (queries
// in registers; at most 128 registers, so that 4 blocks share an SM) or 16
// (queries in shared memory).
template <int BITS, int GC>
__global__ void __launch_bounds__(THREADS, GC == 4 ? 4 : 1) fd_decode_kernel(
    const float* __restrict__ q, const char* __restrict__ kq,
    const __nv_bfloat16* __restrict__ ks, const char* __restrict__ vq,
    const __nv_bfloat16* __restrict__ vs, const int* __restrict__ pos,
    const int* __restrict__ tbl, float* __restrict__ part_acc,
    float* __restrict__ part_m, float* __restrict__ part_l, int KV, int G,
    int Dh, int Dv, int S, int SR, int n_tiles, int tile, int chunk,
    int n_split, int region0) {
  constexpr int DJ = MAX_D / 128;  // V: 4 dims per lane per 128
  const int kb = BITS == 8 ? Dh : 4 * ((Dh + 15) / 16);  // bytes per row
  const int vb = BITS == 8 ? Dv : 4 * ((Dv + 15) / 16);
  const int pk = (kb + 15) & ~15, pv = (vb + 15) & ~15;  // shared pitches
  const int nc = (Dh + 15) / 16;  // 16-code chunks of a K row
  int tpr = 1;                    // threads per row: a power of two >= nc
  while (tpr < nc) tpr <<= 1;
  const int rpp = THREADS / tpr;  // rows per pass

  extern __shared__ __align__(16) char smem[];
  char* kraw = smem;                             // SPLIT_TILES * tile * pk
  char* vraw = kraw + SPLIT_TILES * tile * pk;   // SPLIT_TILES * tile * pv
  float* red = reinterpret_cast<float*>(smem);   // after the tiles: WARPS*GC*Dv
  float* sk_s = reinterpret_cast<float*>(smem + region0);  // SPLIT_TILES*tile
  float* sv_s = sk_s + SPLIT_TILES * tile;
  float* p_s = sv_s + SPLIT_TILES * tile;  // tile * GC: scores, then P * sv
  float* m_s = p_s + tile * GC;            // GC
  float* l_s = m_s + GC;                   // GC
  float* a_s = l_s + GC;                   // GC: this tile's alpha
  float* q_s = a_s + GC;                   // GC * 16 * nc (GC > 4 only)

  const int split = blockIdx.x, kv = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p = pos[b];
  const int kk0 = split * SPLIT_TILES;
  const int nt = max(min(min(SPLIT_TILES, n_tiles - kk0), p / tile + 1 - kk0),
                     0);

  // each tile's first code row, first scale row and live rows
  long long crow0[SPLIT_TILES], srow0[SPLIT_TILES];
  int nval[SPLIT_TILES];
#pragma unroll
  for (int i = 0; i < SPLIT_TILES; ++i) {
    const int t0 = (kk0 + i) * tile;
    nval[i] = 0;
    crow0[i] = srow0[i] = 0;
    if (i < nt) {
      nval[i] = min(tile, p - t0 + 1);
      if (tbl) {
        const long long pid = tbl[(size_t)b * n_tiles + kk0 + i];
        crow0[i] = pid * tile;
        srow0[i] = pid * (tile / chunk);
      } else {
        nval[i] = min(nval[i], S - t0);
        crow0[i] = (long long)b * S + t0;
        srow0[i] = (long long)b * SR + t0 / chunk;
      }
    }
  }
  // every live code row of the split in flight at once, one group a tile
  const int ku = copy_unit(kq, kb), vu = copy_unit(vq, vb);
#pragma unroll
  for (int i = 0; i < SPLIT_TILES; ++i) {
    if (i < nt) {
      const long long c0 = crow0[i];
      stage_rows(kraw + i * tile * pk, pk, nval[i], kb, ku, [&](int r) {
        return kq + ((size_t)(c0 + r) * KV + kv) * kb;
      }, tid, THREADS);
      stage_rows(vraw + i * tile * pv, pv, nval[i], vb, vu, [&](int r) {
        return vq + ((size_t)(c0 + r) * KV + kv) * vb;
      }, tid, THREADS);
    }
    cp_async_commit();
  }
  // scales of live rows; a row past pos enters as 0 and is never read
  for (int idx = tid; idx < SPLIT_TILES * tile; idx += THREADS) {
    const int i = idx / tile, r = idx % tile;
    float sk = 0.f, sv = 0.f;
    if (r < nval[i]) {
      const size_t srow = (size_t)(srow0[i] + r / chunk) * KV + kv;
      sk = bf2f(ks[srow]);
      sv = bf2f(vs[srow]);
    }
    sk_s[idx] = sk;
    sv_s[idx] = sv;
  }

  // this thread's query chunk (dims 16c .. 16c + 15 of every group)
  const int c = tid & (tpr - 1), ro = tid / tpr;
  const float* qb = q + (size_t)(b * KV + kv) * G * Dh;
  float qr[4][16];  // GC == 4 only
  if constexpr (GC == 4) {
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int d = 16 * c + i;
        qr[g][i] = (g < G && c < nc && d < Dh) ? qb[g * Dh + d] : 0.f;
      }
  } else {
    for (int idx = tid; idx < GC * 16 * nc; idx += THREADS) {
      const int g = idx / (16 * nc), d = idx % (16 * nc);
      q_s[idx] = (g < G && d < Dh) ? qb[g * Dh + d] : 0.f;
    }
  }
  if (tid < GC) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[GC][DJ][4];
#pragma unroll
  for (int g = 0; g < GC; ++g)
#pragma unroll
    for (int j = 0; j < DJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[g][j][e] = 0.f;

  static_assert(SPLIT_TILES == 2, "the waits below count two groups");
  for (int i = 0; i < nt; ++i) {
    if (i == 0)
      cp_async_wait<SPLIT_TILES - 1>();
    else
      cp_async_wait<0>();
    __syncthreads();  // tile i's codes landed; tile i-1's P.V is done
    const char* kt = kraw + i * tile * pk;
    const char* vt = vraw + i * tile * pv;
    const float* sk = sk_s + i * tile;
    const float* sv = sv_s + i * tile;
    const int nv = nval[i];

    // scores: tpr threads a row, 16 codes each; rows past nv are masked
#pragma unroll 2
    for (int k = 0; k * rpp < tile; ++k) {
      const int r = ro + k * rpp;
      const bool live = r < nv;
      float s[GC];
#pragma unroll
      for (int g = 0; g < GC; ++g) s[g] = 0.f;
      if (live && c < nc) {
        float cf[16];
        if constexpr (BITS == 8) {
          const uint4 w = *reinterpret_cast<const uint4*>(kt + r * pk + 16 * c);
          i8x4(w.x, cf);
          i8x4(w.y, cf + 4);
          i8x4(w.z, cf + 8);
          i8x4(w.w, cf + 12);
        } else {
          const uint32_t w =
              *reinterpret_cast<const uint32_t*>(kt + r * pk + 4 * c);
#pragma unroll
          for (int j = 0; j < 16; ++j) cf[j] = lvl2((w >> (2 * j)) & 3u);
        }
#pragma unroll
        for (int g = 0; g < GC; ++g) {
          if (g < G) {
            const float* qg = q_s + g * 16 * nc + 16 * c;
#pragma unroll
            for (int j = 0; j < 16; ++j) {
              float qv;
              if constexpr (GC == 4)
                qv = qr[g][j];
              else
                qv = qg[j];
              s[g] = fmaf(qv, cf[j], s[g]);
            }
          }
        }
      }
      for (int o = 1; o < tpr; o <<= 1)
#pragma unroll
        for (int g = 0; g < GC; ++g)
          s[g] += __shfl_xor_sync(0xffffffffu, s[g], o);
      if (c == 0 && r < tile)
#pragma unroll
        for (int g = 0; g < GC; ++g)
          if (g < G) p_s[r * GC + g] = live ? s[g] * sk[r] : NEG_INF;
    }
    __syncthreads();
    // streaming softmax: one warp per query group; V's scale folded into P
    for (int g = warp; g < G; g += WARPS) {
      float mx = NEG_INF;
      for (int r = lane; r < nv; r += 32) mx = fmaxf(mx, p_s[r * GC + g]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int r = lane; r < nv; r += 32) {
        const float e = expf(p_s[r * GC + g] - m_new);
        p_s[r * GC + g] = e * sv[r];
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[g] = alpha;
        l_s[g] = alpha * l_s[g] + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    // acc = alpha * acc + P.V: warp w takes rows w, w + 4, ...; lane l dims
    // 4l .. 4l + 3 (+ 128 j)
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      const float al = g < G ? a_s[g] : 0.f;
#pragma unroll
      for (int j = 0; j < DJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[g][j][e] *= al;
    }
#pragma unroll 4
    for (int r = warp; r < nv; r += WARPS) {
      float pg[GC];
#pragma unroll
      for (int g4 = 0; g4 < GC; g4 += 4) {
        const float4 v4 = *reinterpret_cast<const float4*>(p_s + r * GC + g4);
        pg[g4] = v4.x;
        pg[g4 + 1] = v4.y;
        pg[g4 + 2] = v4.z;
        pg[g4 + 3] = v4.w;
      }
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        if (128 * j + 4 * lane < Dv) {
          float vf[4];
          if constexpr (BITS == 8)
            i8x4(*reinterpret_cast<const uint32_t*>(vt + r * pv + 128 * j +
                                                    4 * lane),
                 vf);
          else
            lv2x4(reinterpret_cast<const uint8_t*>(vt)[r * pv + 32 * j + lane],
                  vf);
#pragma unroll
          for (int g = 0; g < GC; ++g)
            if (g < G)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                acc[g][j][e] = fmaf(pg[g], vf[e], acc[g][j][e]);
        }
      }
    }
  }

  // the four warps' partial sums, added in a fixed order
  __syncthreads();  // every warp is done with the tiles (red aliases them)
#pragma unroll
  for (int g = 0; g < GC; ++g)
#pragma unroll
    for (int j = 0; j < DJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 128 * j + 4 * lane + e;
        if (g < G && d < Dv) red[(warp * GC + g) * Dv + d] = acc[g][j][e];
      }
  __syncthreads();
  const size_t part = (size_t)(b * KV + kv) * n_split + split;
  for (int idx = tid; idx < G * Dv; idx += THREADS) {
    const int g = idx / Dv, d = idx % Dv;
    float s = red[g * Dv + d];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) s += red[(w * GC + g) * Dv + d];
    part_acc[(part * G + g) * Dv + d] = s;
  }
  if (tid < G) {
    part_m[part * G + tid] = m_s[tid];
    part_l[part * G + tid] = l_s[tid];
  }
}

// Grid (B * KV * G).  Merges one query's splits in order: shift every split
// to the largest running max and normalize once (the distributed-softmax
// identity).  The split weights are computed once into shared memory and
// every sum runs over the splits in order, so empty splits (m = NEG_INF,
// l = 0, acc = 0) past the last live one add exact zeros: a wider paged
// table gives the flat result bitwise.
__global__ void __launch_bounds__(THREADS) fd_merge_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_m,
    const float* __restrict__ part_l, float* __restrict__ out, int G, int Dv,
    int n_split) {
  extern __shared__ float w_s[];  // n_split weights, then the denominator
  const size_t bk = blockIdx.x / G;
  const int g = blockIdx.x % G, tid = threadIdx.x;
  for (int s = tid; s < n_split; s += THREADS)
    w_s[s] = part_m[(bk * n_split + s) * G + g];
  __syncthreads();
  if (tid == 0) {
    float mg = NEG_INF;
    for (int s = 0; s < n_split; ++s) mg = fmaxf(mg, w_s[s]);
    float den = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float w = expf(w_s[s] - mg);
      w_s[s] = w;
      den += w * part_l[(bk * n_split + s) * G + g];
    }
    w_s[n_split] = fmaxf(den, 1e-30f);
  }
  __syncthreads();
  for (int d = tid; d < Dv; d += THREADS) {
    float num = 0.f;
#pragma unroll 8
    for (int s = 0; s < n_split; ++s)
      num += w_s[s] * part_acc[((bk * n_split + s) * G + g) * Dv + d];
    out[(bk * G + g) * Dv + d] = num / w_s[n_split];
  }
}

// ------------------------------------------------------------------ extend

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// d += a.b on the tensor cores: m16n8k8, A row-major, B column-major, TF32
// operands (fp32 registers; the unit reads their top 19 bits), fp32 sums.
__device__ __forceinline__ void mma_tf32(float d[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A ring row pitch (bytes) >= n: a multiple of 16 for cp.async, and not of
// 128, so that the rows of a warp's reads start on different banks.
__host__ __device__ __forceinline__ int ring_pitch(int n) {
  const int p = (n + 15) & ~15;
  return p % 128 ? p : p + 16;
}

// A shared-memory pitch (floats) >= n that is `rem` mod 32: the fragment
// reads of a warp then fall on 32 different banks.
__host__ __device__ __forceinline__ int bank_pitch(int n, int rem) {
  return n + ((rem - n % 32) + 32) % 32;
}

// 16 bytes of T (8 bf16 or 4 fp32) -> floats; bf16 widens exactly.
template <typename T>
__device__ __forceinline__ void to_f32x16b(uint4 w, float* f) {
  if constexpr (std::is_same<T, float>::value) {
    f[0] = __uint_as_float(w.x);
    f[1] = __uint_as_float(w.y);
    f[2] = __uint_as_float(w.z);
    f[3] = __uint_as_float(w.w);
  } else {
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(u[i] << 16);
      f[2 * i + 1] = __uint_as_float(u[i] & 0xFFFF0000u);
    }
  }
}

template <typename T>
__device__ __forceinline__ float to_f32(T x) {
  if constexpr (std::is_same<T, float>::value)
    return x;
  else
    return __bfloat162float(x);
}

// Rows [0, nrows) of D values of type T (row r at src_row(r)) -> fp32
// shared rows of ``pitch`` floats, zero past D up to Dpad and on rows
// [nrows, rows).  16-byte loads when every row start is aligned, unrolled
// so that a thread's loads are in flight together.  Threads tid of n.
template <typename T, typename RowFn>
__device__ __forceinline__ void load_rows_f32(float* dst, int pitch, int rows,
                                              int nrows, int D, int Dpad,
                                              RowFn src_row, int tid, int n) {
  constexpr int V = 16 / sizeof(T);
  if (D % V == 0 && Dpad % V == 0 &&
      reinterpret_cast<uintptr_t>(src_row(0)) % 16 == 0) {
    const int per = Dpad / V;
#pragma unroll 4
    for (int i = tid; i < rows * per; i += n) {
      const int r = i / per, d = V * (i % per);
      float f[V];
#pragma unroll
      for (int e = 0; e < V; ++e) f[e] = 0.f;
      if (r < nrows && d < D)
        to_f32x16b<T>(*reinterpret_cast<const uint4*>(src_row(r) + d), f);
#pragma unroll
      for (int e = 0; e < V; e += 4)
        *reinterpret_cast<float4*>(dst + r * pitch + d + e) =
            make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
    }
  } else {
#pragma unroll 4
    for (int i = tid; i < rows * Dpad; i += n) {
      const int r = i / Dpad, d = i % Dpad;
      dst[r * pitch + d] = (r < nrows && d < D) ? to_f32(src_row(r)[d]) : 0.f;
    }
  }
}

// Extend's shared memory, in floats from the start: q_s (XT_ROWS x pq),
// then per warp set k_s (XT_KEYS x pq) and v_s (XT_KEYS x pvf), and at
// least room for the end-of-run exchange of set 1's state; the byte
// regions (ring, scales, page ids) follow.
__host__ __device__ __forceinline__ int extend_floats(int pq, int pvf,
                                                      int sets, int dn) {
  const int tiles = XT_ROWS * pq + sets * XT_KEYS * (pq + pvf);
  const int xchg = sets > 1 ? (4 * dn + 4) * THREADS : 0;
  return ((tiles > xchg ? tiles : xchg) + 3) & ~3;
}

// Grid (ceil(L*G / XT_ROWS), KV).  q: (1, L, KV*G, Dh) unscaled; kf/vf:
// (1, L, KV, Dh|Dv), all of type T (bf16: exact in TF32; fp32: split into
// hi + lo); pools as in the paged decode; tbl: (n_past,) full past pages.
// Query row i of a KV head is chunk token i / G, head kv*G + i % G.  out:
// (1, L, KV*G, Dv) fp32, normalized.  DN: 8-wide V dim tiles (16 or 32).
// Tiles 0 .. n_pt-1 are past keys, the rest the chunk's own; both stream
// through the ring (codes, or bf16 rows), fp32 own rows load directly.
// SETS sets of 4 warps take the block's rows against alternate tiles (set
// s: tiles s, s + SETS, ...), each with its own buffers and ring slots,
// and set 1's running state is merged into set 0's at the end.
template <typename T, int DN, int SETS>
__global__ void __launch_bounds__(THREADS * SETS) fe_extend_kernel(
    const T* __restrict__ q, const T* __restrict__ kf,
    const T* __restrict__ vf, const char* __restrict__ kq,
    const __nv_bfloat16* __restrict__ ks, const char* __restrict__ vq,
    const __nv_bfloat16* __restrict__ vs, const int* __restrict__ tbl,
    int n_past, float* __restrict__ out, int KV, int G, int L, int Dh,
    int Dv, int page, int chunk, int kv_bits, float qscale) {
  constexpr bool SPLIT = std::is_same<T, float>::value;
  constexpr int NT = XT_KEYS / 8;      // 8-key n-tiles of the scores
  constexpr int SLOTS = 2 * SETS;      // ring slots: two steps of tiles
  static_assert(THREADS == 4 * XT_KEYS, "a tile row is 4 threads");
  // scores in the log2 domain: exp(x) = exp2(x * log2(e))
  const float qscale2 = qscale * 1.44269504088896341f;
  const int H = KV * G, R = L * G;
  const int kv = blockIdx.y, r0 = blockIdx.x * XT_ROWS;
  const int set = threadIdx.x / THREADS, tid = threadIdx.x % THREADS;
  const int lane = tid & 31, warp = tid >> 5;  // warp within the set
  const int gid = lane >> 2, tq = lane & 3;
  const int dhp = (Dh + 7) & ~7, dvp = (Dv + 7) & ~7;
  const int pq = bank_pitch(dhp, 8), pvf = bank_pitch(dvp, 4);
  const int kb = kv_bits == 8 ? Dh : 4 * ((Dh + 15) / 16);
  const int vb = kv_bits == 8 ? Dv : 4 * ((Dv + 15) / 16);
  // ring rows: codes, or the chunk's own bf16 rows
  const int rk = ring_pitch(max(kb, SPLIT ? 0 : 2 * Dh));
  const int rv = ring_pitch(max(vb, SPLIT ? 0 : 2 * Dv));

  extern __shared__ __align__(16) char smem[];
  float* q_s = reinterpret_cast<float*>(smem);       // XT_ROWS * pq
  float* k_s = q_s + XT_ROWS * pq + set * XT_KEYS * (pq + pvf);
  float* v_s = k_s + XT_KEYS * pq;                   // XT_KEYS * pvf
  float* xchg = reinterpret_cast<float*>(smem);      // after the last tile
  char* raw = smem + sizeof(float) * extend_floats(pq, pvf, SETS, DN);
  float* sc_s = reinterpret_cast<float*>(raw + SLOTS * XT_KEYS * (rk + rv));
  int* pid_s = reinterpret_cast<int*>(sc_s + SLOTS * 2 * XT_KEYS);

  const int np_keys = n_past * page;
  const int n_pt = (np_keys + XT_KEYS - 1) / XT_KEYS;
  const int tok_hi = (min(r0 + XT_ROWS, R) - 1) / G;  // the block's last
  const int n_t = n_pt + tok_hi / XT_KEYS + 1;

  // past tile t: key t * XT_KEYS + r lies on the tile's first page plus
  // pi, at offset off; slot t % SLOTS of pid_s holds those pages' ids
  auto pid_of = [&](int t) {  // this thread's page-table entry of tile t
    const int idx = t * XT_KEYS / page + tid;
    const int last = min((t * XT_KEYS + XT_KEYS - 1) / page, n_past - 1);
    return (tid < XT_KEYS && idx <= last) ? tbl[idx] : 0;
  };
  auto locate = [&](int t, int r, long long& pid, int& off) {
    off = (t * XT_KEYS) % page + r;
    int pi = 0;
    if (off >= page) {  // the tile crosses a page
      pi = off / page;
      off -= pi * page;
    }
    pid = pid_s[(t % SLOTS) * XT_KEYS + pi];
  };
  auto code_row = [&](int t, int r) {
    long long pid;
    int off;
    locate(t, r, pid, off);
    return (size_t)(pid * page + off) * KV + kv;
  };
  auto own_row = [&](const T* x, int t, int r, int D) {
    return x + ((size_t)((t - n_pt) * XT_KEYS + r) * KV + kv) * D;
  };
  const int ku = copy_unit(kq, kb), vu = copy_unit(vq, vb);
  const int fku = copy_unit(kf, 2 * Dh), fvu = copy_unit(vf, 2 * Dv);
  auto issue = [&](int t) {  // tile t -> ring slot t % SLOTS, by its set
    char* st = raw + (t % SLOTS) * XT_KEYS * (rk + rv);
    if (t < n_pt) {
      const int nr = min(XT_KEYS, np_keys - t * XT_KEYS);
      stage_rows(st, rk, nr, kb, ku,
                 [&](int r) { return kq + code_row(t, r) * kb; }, tid,
                 THREADS);
      stage_rows(st + XT_KEYS * rk, rv, nr, vb, vu,
                 [&](int r) { return vq + code_row(t, r) * vb; }, tid,
                 THREADS);
    } else if constexpr (!SPLIT) {
      const int nr = min(XT_KEYS, L - (t - n_pt) * XT_KEYS);
      stage_rows(st, rk, nr, 2 * Dh, fku, [&](int r) {
        return reinterpret_cast<const char*>(own_row(kf, t, r, Dh));
      }, tid, THREADS);
      stage_rows(st + XT_KEYS * rk, rv, nr, 2 * Dv, fvu, [&](int r) {
        return reinterpret_cast<const char*>(own_row(vf, t, r, Dv));
      }, tid, THREADS);
    }
  };
  auto scales_of = [&](int t, float& sk, float& sv) {  // row tid of tile t
    sk = sv = 0.f;
    if (tid < XT_KEYS && t * XT_KEYS + tid < np_keys) {
      long long pid;
      int off;
      locate(t, tid, pid, off);
      const size_t srow =
          (size_t)(pid * (page / chunk) + (chunk == 1 ? off : off / chunk)) *
              KV + kv;
      sk = bf2f(ks[srow]);
      sv = bf2f(vs[srow]);
    }
  };

  // page ids of the first two steps' tiles; this set's first tile in flight
  if (tid < XT_KEYS)
    for (int t = set; t < SLOTS; t += SETS)
      pid_s[t * XT_KEYS + tid] = t < n_pt ? pid_of(t) : 0;
  __syncthreads();
  if (set < n_t) issue(set);
  cp_async_commit();
  if (set < n_pt && tid < XT_KEYS)
    scales_of(set, sc_s[set * 2 * XT_KEYS + tid],
              sc_s[set * 2 * XT_KEYS + XT_KEYS + tid]);
  // queries -> shared fp32 (exact for bf16), zero past Dh and past R
  load_rows_f32<T>(q_s, pq, XT_ROWS, min(XT_ROWS, R - r0), Dh, dhp,
                   [&](int i) {
                     const int row = r0 + i;
                     return q + ((size_t)(row / G) * H + kv * G + row % G) *
                                    Dh;
                   }, threadIdx.x, THREADS * SETS);

  // this thread's rows (C fragment): A = warp row gid, B = gid + 8
  const int row_a = r0 + 16 * warp + gid, row_b = row_a + 8;
  const int tok_a = row_a / G, tok_b = row_b / G;
  // running max (log2 domain) and this thread's part of the denominator
  float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.f, l_b = 0.f;
  float acc[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int n_steps = (n_t + SETS - 1) / SETS;
  for (int k = 0; k < n_steps; ++k) {
    const int t = SETS * k + set;  // this set's tile
    const bool have = t < n_t, past = t < n_pt;
    cp_async_wait<0>();
    __syncthreads();  // this step's tiles and scales landed; the last done

    // tile t -> k_s, v_s in fp32: codes without their scales, or own keys
    const int j0 = past ? t * XT_KEYS : (t - n_pt) * XT_KEYS;
    const int n_live = min(XT_KEYS, (past ? np_keys : L) - j0);
    if (have && SPLIT && !past) {
      load_rows_f32<T>(k_s, pq, XT_KEYS, n_live, Dh, dhp,
                       [&](int r) { return own_row(kf, t, r, Dh); }, tid,
                       THREADS);
      load_rows_f32<T>(v_s, pvf, XT_KEYS, n_live, Dv, dvp,
                       [&](int r) { return own_row(vf, t, r, Dv); }, tid,
                       THREADS);
    } else if (have) {
      const int r = tid >> 2, d0 = 4 * (tid & 3);
      const bool rl = r < n_live;
      const char* st = raw + (t % SLOTS) * XT_KEYS * (rk + rv);
#pragma unroll
      for (int m = 0; m < 2; ++m) {  // K, then V
        const int D = m ? Dv : Dh, dp = m ? dvp : dhp;
        const char* row = st + (m ? XT_KEYS * rk + r * rv : r * rk);
        float* dst = m ? v_s + r * pvf : k_s + r * pq;
#pragma unroll
        for (int k16 = 0; k16 < DN / 2; ++k16) {
          const int d = d0 + 16 * k16;
          if (d >= dp) break;
          float f[4] = {0.f, 0.f, 0.f, 0.f};
          if (rl) {
            if (!past) {  // 4 bf16 values: 8 bytes inside the row's pitch
              const uint2 w = *reinterpret_cast<const uint2*>(row + 2 * d);
              f[0] = __uint_as_float(w.x << 16);
              f[1] = __uint_as_float(w.x & 0xFFFF0000u);
              f[2] = __uint_as_float(w.y << 16);
              f[3] = __uint_as_float(w.y & 0xFFFF0000u);
            } else if (kv_bits == 8) {  // d + 3 < the row's 16-byte pitch
              i8x4(*reinterpret_cast<const uint32_t*>(row + d), f);
            } else {
              lv2x4(reinterpret_cast<const uint8_t*>(row)[d / 4], f);
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) f[e] = d + e < D ? f[e] : 0.f;
          }
          *reinterpret_cast<float4*>(dst + d) =
              make_float4(f[0], f[1], f[2], f[3]);
        }
      }
    }
    __syncthreads();  // k_s, v_s filled; the ring slot of tile t - SETS read
    // the next step's tile in flight, its scales and the page ids of the
    // step after it fetched, all during this step's compute
    float nsk = 0.f, nsv = 0.f;
    int npid = 0;
    if (t + SETS < n_t) issue(t + SETS);
    if (t + SETS < n_pt) scales_of(t + SETS, nsk, nsv);
    cp_async_commit();
    if (t + SLOTS < n_pt) npid = pid_of(t + SLOTS);

    if (have) {
      // S = Q.K^T: k step s covers dims 8s + 2tq and 8s + 2tq + 1 (a
      // permutation of the k index that Q and K share)
      float s[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
      const float* qa = q_s + (16 * warp + gid) * pq + 2 * tq;
      for (int k8 = 0; k8 < dhp; k8 += 8) {
        const float2 xa = *reinterpret_cast<const float2*>(qa + k8);
        const float2 xb = *reinterpret_cast<const float2*>(qa + 8 * pq + k8);
        uint32_t ah[4], al[4];
        if constexpr (SPLIT) {
          ah[0] = tf32(xa.x); ah[1] = tf32(xb.x);
          ah[2] = tf32(xa.y); ah[3] = tf32(xb.y);
          al[0] = tf32(xa.x - __uint_as_float(ah[0]));
          al[1] = tf32(xb.x - __uint_as_float(ah[1]));
          al[2] = tf32(xa.y - __uint_as_float(ah[2]));
          al[3] = tf32(xb.y - __uint_as_float(ah[3]));
        } else {
          ah[0] = __float_as_uint(xa.x); ah[1] = __float_as_uint(xb.x);
          ah[2] = __float_as_uint(xa.y); ah[3] = __float_as_uint(xb.y);
        }
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const float2 y = *reinterpret_cast<const float2*>(
              k_s + (8 * n + gid) * pq + k8 + 2 * tq);
          if (SPLIT && !past) {  // fp32 keys: hi.hi + lo.hi + hi.lo
            const uint32_t h0 = tf32(y.x), h1 = tf32(y.y);
            mma_tf32(s[n], ah, h0, h1);
            mma_tf32(s[n], al, h0, h1);
            mma_tf32(s[n], ah, tf32(y.x - __uint_as_float(h0)),
                     tf32(y.y - __uint_as_float(h1)));
          } else {  // codes or bf16 keys: exact
            mma_tf32(s[n], ah, __float_as_uint(y.x), __float_as_uint(y.y));
            if constexpr (SPLIT) mma_tf32(s[n], al, __float_as_uint(y.x),
                                          __float_as_uint(y.y));
          }
        }
      }

      // scale, mask by select, streaming softmax over the tile
      const float* skt = sc_s + (t % SLOTS) * 2 * XT_KEYS;
      const float* svt = skt + XT_KEYS;
      bool live[NT][4];
      float mx_a = NEG_INF, mx_b = NEG_INF;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = 8 * n + 2 * tq + (e & 1);
          const int tok = e < 2 ? tok_a : tok_b;
          live[n][e] = key < n_live && (past || j0 + key <= tok);
          const float x = s[n][e] * qscale2 * (past ? skt[key] : 1.f);
          s[n][e] = live[n][e] ? x : NEG_INF;
          if (e < 2)
            mx_a = fmaxf(mx_a, s[n][e]);
          else
            mx_b = fmaxf(mx_b, s[n][e]);
        }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o));
      }
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      const float al_a = exp2f(m_a - mn_a), al_b = exp2f(m_b - mn_b);
      m_a = mn_a;
      m_b = mn_b;
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pe =
              live[n][e] ? exp2f(s[n][e] - (e < 2 ? mn_a : mn_b)) : 0.f;
          if (e < 2)
            sum_a += pe;
          else
            sum_b += pe;
          s[n][e] = pe * (past ? svt[8 * n + 2 * tq + (e & 1)] : 1.f);
        }
      l_a = al_a * l_a + sum_a;
      l_b = al_b * l_b + sum_b;

      // P (hi + lo) as A fragments: key step n holds keys 8n + 2tq (k
      // index tq) and 8n + 2tq + 1 (k index tq + 4), the C layout of S
      uint32_t ph[NT][4], pl[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float a4[4] = {s[n][0], s[n][2], s[n][1], s[n][3]};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ph[n][i] = tf32(a4[i]);
          pl[n][i] = tf32(a4[i] - __uint_as_float(ph[n][i]));
        }
      }
      // acc = alpha * acc + P.V, the tile's product summed from zero in
      // four independent chains (8-dim tiles dn0 .. dn0 + 3)
#pragma unroll
      for (int dn0 = 0; dn0 < DN; dn0 += 4) {
        if (8 * dn0 < dvp) {
          float o[4][4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            float y0[4], y1[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float* vc =
                  v_s + (8 * n + 2 * tq) * pvf + 8 * (dn0 + i) + gid;
              const bool in = 8 * (dn0 + i) < dvp;
              y0[i] = in ? vc[0] : 0.f;
              y1[i] = in ? vc[pvf] : 0.f;
            }
            if (SPLIT && !past) {  // fp32 values: hi.hi + lo.hi + hi.lo
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const uint32_t h0 = tf32(y0[i]), h1 = tf32(y1[i]);
                mma_tf32(o[i], pl[n], h0, h1);
                mma_tf32(o[i], ph[n], tf32(y0[i] - __uint_as_float(h0)),
                         tf32(y1[i] - __uint_as_float(h1)));
                mma_tf32(o[i], ph[n], h0, h1);
              }
            } else {  // codes or bf16 values: exact
#pragma unroll
              for (int i = 0; i < 4; ++i)
                mma_tf32(o[i], pl[n], __float_as_uint(y0[i]),
                         __float_as_uint(y1[i]));
#pragma unroll
              for (int i = 0; i < 4; ++i)
                mma_tf32(o[i], ph[n], __float_as_uint(y0[i]),
                         __float_as_uint(y1[i]));
            }
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[dn0 + i][0] = fmaf(acc[dn0 + i][0], al_a, o[i][0]);
            acc[dn0 + i][1] = fmaf(acc[dn0 + i][1], al_a, o[i][1]);
            acc[dn0 + i][2] = fmaf(acc[dn0 + i][2], al_b, o[i][2]);
            acc[dn0 + i][3] = fmaf(acc[dn0 + i][3], al_b, o[i][3]);
          }
        }
      }
    }

    // the next tiles' scales and page ids, fetched during this tile
    if (t + SETS < n_pt && tid < XT_KEYS) {
      float* sc = sc_s + ((t + SETS) % SLOTS) * 2 * XT_KEYS;
      sc[tid] = nsk;
      sc[XT_KEYS + tid] = nsv;
    }
    if (t + SLOTS < n_pt && tid < XT_KEYS)
      pid_s[(t % SLOTS) * XT_KEYS + tid] = npid;
  }

  if constexpr (SETS > 1) {  // set 1's running state -> set 0's
    __syncthreads();  // every set is done with its tiles (xchg aliases them)
    float* x = xchg + tid;  // element j of a thread at j * THREADS
    if (set == 1) {
      x[0] = m_a;
      x[THREADS] = m_b;
      x[2 * THREADS] = l_a;
      x[3 * THREADS] = l_b;
#pragma unroll
      for (int n = 0; n < DN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) x[(4 + 4 * n + e) * THREADS] = acc[n][e];
    }
    __syncthreads();
    if (set == 1) return;
    const float mo_a = x[0], mo_b = x[THREADS];
    const float mn_a = fmaxf(m_a, mo_a), mn_b = fmaxf(m_b, mo_b);
    const float c_a = exp2f(m_a - mn_a), o_a = exp2f(mo_a - mn_a);
    const float c_b = exp2f(m_b - mn_b), o_b = exp2f(mo_b - mn_b);
    l_a = l_a * c_a + x[2 * THREADS] * o_a;
    l_b = l_b * c_b + x[3 * THREADS] * o_b;
#pragma unroll
    for (int n = 0; n < DN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[n][e] = acc[n][e] * (e < 2 ? c_a : c_b) +
                    x[(4 + 4 * n + e) * THREADS] * (e < 2 ? o_a : o_b);
  }

#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, o);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, o);
  }
#pragma unroll
  for (int dn = 0; dn < DN; ++dn) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = e < 2 ? row_a : row_b;
      const int d = 8 * dn + 2 * tq + (e & 1);
      if (row < R && d < Dv) {
        const int g = row % G;
        out[((size_t)(row / G) * H + kv * G + g) * Dv + d] =
            acc[dn][e] / fmaxf(e < 2 ? l_a : l_b, 1e-30f);
      }
    }
  }
}

// Raise a kernel's dynamic shared-memory limit to what it needs, on the
// current device (set on every launch: the attribute is per device)
template <auto KERNEL>
int allow_smem(size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int BITS, int GC>
int launch_decode(dim3 grid, size_t smem, cudaStream_t st, const float* q,
                  const void* kq, const void* ks, const void* vq,
                  const void* vs, const int* pos, const int* tbl,
                  float* part_acc, float* part_m, float* part_l, int KV,
                  int G, int Dh, int Dv, int S, int SR, int n_tiles, int tile,
                  int chunk, int n_split, int region0) {
  const int err = allow_smem<fd_decode_kernel<BITS, GC>>(smem);
  if (err) return err;
  fd_decode_kernel<BITS, GC><<<grid, THREADS, smem, st>>>(
      q, (const char*)kq, (const __nv_bfloat16*)ks, (const char*)vq,
      (const __nv_bfloat16*)vs, pos, tbl, part_acc, part_m, part_l, KV, G,
      Dh, Dv, S, SR, n_tiles, tile, chunk, n_split, region0);
  return (int)cudaGetLastError();
}

template <typename T, int DN, int SETS>
int launch_extend(const void* q, const void* kf, const void* vf,
                  const void* kq, const void* ks, const void* vq,
                  const void* vs, const int* tbl, int n_past, float* out,
                  int KV, int G, int L, int Dh, int Dv, int page, int chunk,
                  int kv_bits, float qscale, cudaStream_t st) {
  constexpr bool SPLIT = std::is_same<T, float>::value;
  const int dhp = (Dh + 7) & ~7, dvp = (Dv + 7) & ~7;
  const int pq = bank_pitch(dhp, 8), pvf = bank_pitch(dvp, 4);
  const int kb = kv_bits == 8 ? Dh : 4 * ((Dh + 15) / 16);
  const int vb = kv_bits == 8 ? Dv : 4 * ((Dv + 15) / 16);
  const int rk = ring_pitch(kb > 2 * Dh || SPLIT ? kb : 2 * Dh);
  const int rv = ring_pitch(vb > 2 * Dv || SPLIT ? vb : 2 * Dv);
  const size_t smem = sizeof(float) * extend_floats(pq, pvf, SETS, DN) +
                      2 * SETS * XT_KEYS * (size_t)(rk + rv) +
                      (sizeof(float) * 2 + sizeof(int)) * 2 * SETS * XT_KEYS;
  const int err = allow_smem<fe_extend_kernel<T, DN, SETS>>(smem);
  if (err) return err;
  const dim3 grid((L * G + XT_ROWS - 1) / XT_ROWS, KV);
  fe_extend_kernel<T, DN, SETS><<<grid, THREADS * SETS, smem, st>>>(
      (const T*)q, (const T*)kf, (const T*)vf, (const char*)kq,
      (const __nv_bfloat16*)ks, (const char*)vq, (const __nv_bfloat16*)vs,
      tbl, n_past, out, KV, G, L, Dh, Dv, page, chunk, kv_bits, qscale);
  return (int)cudaGetLastError();
}

}  // namespace

// The tiles one decode block walks: callers size the split buffers with it
extern "C" int fd_split_tiles() { return SPLIT_TILES; }

// part_acc (B, KV, n_split, G, Dv), part_m / part_l (B, KV, n_split, G):
// n_split = ceil(n_tiles / fd_split_tiles())
extern "C" int fd_decode_launch(
    const float* q, const void* kq, const void* ks, const void* vq,
    const void* vs, const int* pos, const int* tbl, float* part_acc,
    float* part_m, float* part_l, float* out, int B, int KV, int G, int Dh,
    int Dv, int S, int SR, int n_tiles, int tile, int chunk, int kv_bits,
    int n_split, void* stream) {
  if (n_split != (n_tiles + SPLIT_TILES - 1) / SPLIT_TILES || G > MAX_G ||
      Dh > MAX_D || Dv > MAX_D || (kv_bits != 8 && kv_bits != 2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int gc = G <= 4 ? 4 : MAX_G;
  const int kb = kv_bits == 8 ? Dh : 4 * ((Dh + 15) / 16);
  const int vb = kv_bits == 8 ? Dv : 4 * ((Dv + 15) / 16);
  const size_t ring = (size_t)SPLIT_TILES * tile *
                      (((kb + 15) & ~15) + ((vb + 15) & ~15));
  const size_t red = sizeof(float) * WARPS * gc * Dv;
  const size_t region0 = ((ring > red ? ring : red) + 15) & ~(size_t)15;
  const int nc = (Dh + 15) / 16;
  const size_t smem = region0 + sizeof(float) *
      (2 * SPLIT_TILES * tile + tile * gc + 3 * gc +
       (gc > 4 ? gc * 16 * nc : 0));
  const dim3 grid(n_split, KV, B);
  int err;
  if (kv_bits == 8)
    err = gc == 4 ? launch_decode<8, 4>(grid, smem, st, q, kq, ks, vq, vs,
                                        pos, tbl, part_acc, part_m, part_l,
                                        KV, G, Dh, Dv, S, SR, n_tiles, tile,
                                        chunk, n_split, (int)region0)
                  : launch_decode<8, MAX_G>(grid, smem, st, q, kq, ks, vq, vs,
                                            pos, tbl, part_acc, part_m,
                                            part_l, KV, G, Dh, Dv, S, SR,
                                            n_tiles, tile, chunk, n_split,
                                            (int)region0);
  else
    err = gc == 4 ? launch_decode<2, 4>(grid, smem, st, q, kq, ks, vq, vs,
                                        pos, tbl, part_acc, part_m, part_l,
                                        KV, G, Dh, Dv, S, SR, n_tiles, tile,
                                        chunk, n_split, (int)region0)
                  : launch_decode<2, MAX_G>(grid, smem, st, q, kq, ks, vq, vs,
                                            pos, tbl, part_acc, part_m,
                                            part_l, KV, G, Dh, Dv, S, SR,
                                            n_tiles, tile, chunk, n_split,
                                            (int)region0);
  if (err) return err;
  fd_merge_kernel<<<B * KV * G, THREADS, sizeof(float) * (n_split + 1),
                   st>>>(part_acc, part_m, part_l, out, G, Dv, n_split);
  return (int)cudaGetLastError();
}

extern "C" int fe_extend_launch(
    const void* q, const void* kf, const void* vf, const void* kq,
    const void* ks, const void* vq, const void* vs, const int* tbl,
    int n_past, float* out, int KV, int G, int L, int Dh, int Dv, int page,
    int chunk, int kv_bits, int fp32_inputs, float qscale, void* stream) {
  if (G > MAX_G || Dh > MAX_D || Dv > MAX_D ||
      (kv_bits != 8 && kv_bits != 2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  // two warp sets up to 128 wide; one set (its shared memory) up to 256
  const bool wide = (Dh > Dv ? Dh : Dv) > 128;
  if (fp32_inputs)
    return wide ? launch_extend<float, 32, 1>(q, kf, vf, kq, ks, vq, vs, tbl,
                                              n_past, out, KV, G, L, Dh, Dv,
                                              page, chunk, kv_bits, qscale,
                                              st)
                : launch_extend<float, 16, 2>(q, kf, vf, kq, ks, vq, vs, tbl,
                                              n_past, out, KV, G, L, Dh, Dv,
                                              page, chunk, kv_bits, qscale,
                                              st);
  return wide ? launch_extend<__nv_bfloat16, 32, 1>(
                    q, kf, vf, kq, ks, vq, vs, tbl, n_past, out, KV, G, L,
                    Dh, Dv, page, chunk, kv_bits, qscale, st)
              : launch_extend<__nv_bfloat16, 16, 2>(
                    q, kf, vf, kq, ks, vq, vs, tbl, n_past, out, KV, G, L,
                    Dh, Dv, page, chunk, kv_bits, qscale, st);
}
