// MLA absorbed ("latent") attention on a quantized latent cache for Hopper
// (sm_90a): one-token decode over a flat or block-paged kv8/kv2 cache, and
// the chunked-prefill extend over paged past pages plus the chunk's own fp
// latents.
//
// Replaces the reference's Pallas kernels in
// src/repro/kernels/flash_decode/kernel.py:
//   mla_flash_decode_pallas        (:438) -> mla_decode_kernel, tbl == nullptr
//   paged_mla_flash_decode_pallas  (:520) -> mla_decode_kernel, tbl != nullptr
//   paged_mla_flash_extend_pallas  (:632) -> mla_extend_kernel
//
// What it computes.  One KV head in latent space for H query heads: the
// score of query row i against cache row j is ql_i·c_j + qr_i·r_j (c the
// dl-wide latent, r the dr-wide shared rope key, both dequantized, the
// attention scale already folded into ql and qr), the values are the
// latents themselves (v = c).  kv8: int8 codes x a per-token bf16 scale;
// kv2: 2-bit codes, 16 per uint32 word, -> {-1, -0.25, +0.25, +1} x a
// per-64-token bf16 scale.
//
// Bound.  Every cache row serves all H heads: at deepseek-v3's H 128, dl
// 512, dr 64 a row costs 128 x (576 + 512) multiply-adds and 576 codes, so
// both kernels are bound by operations, not bytes (decode at B 4, S 8192:
// ~9.1 GFLOP, 0.136 ms at the fp32 peak of 67 TFLOP/s, against 5.6 us for
// the kv8 codes; the extend at L 256 over 16 past pages ~82 GFLOP).
//
// Decode.  A block owns QR = 16 query rows (16 heads of one request) and
// walks the keys in sub-tiles of KT = 32 rows.  For each sub-tile it
// dequantizes the 32 rows of [c | r] once into shared memory, fp32, and all
// 16 query rows use them: a kernel that re-read the rows per head would
// move 128x the bytes.  The (16 rows x dl) fp32 accumulator stays in
// registers across the 16 warps, each thread owning one latent column for
// all 16 rows.  Shared-memory reads, not the FMA pipes, limit such a
// kernel, so the scores are tiled in registers: each warp takes a 1/16
// slice of the 576-wide dot product for all 16 x 32 (row, key) pairs,
// every thread a 4 x 4 tile of them (8 float4 reads per 64 FMAs), and the
// 16 partial sums of a score are added in a fixed order before warp r runs
// row r's streaming softmax.  Values: each thread reads its column of the
// 32 key rows and the 16 rows' probabilities (broadcast float4 reads).  A
// query row may see key j iff j <= pos: rows past pos are never read, so
// the trash page and stale table entries never reach the result.  Each
// request's tiles are split into fixed runs of TILES_PER_SPLIT blocks,
// merged by a second kernel in a fixed order (deterministic); the runs are
// fixed in tile units, so a flat and a paged call at tile = page split a
// request alike and agree bitwise.  Plain fp32 FMAs.
//
// Extend.  A block owns EX_ROWS = 32 query rows, 32 heads of one chunk
// token, so its rows share one causal limit and every key tile is loaded
// and widened once for all of them (L 256 x H 128: 1024 blocks).  Keys
// come in tiles of 32: the past pages through tbl, then the chunk's own
// keys up to the block's token.  Q.K^T and P.V run on the tensor cores
// (mma.sync m16n8k16, bf16 operands, fp32 sums) and keep the fp32 result:
//   - the codes (int8, or the 2-bit levels +-0.25, +-1) are exact in bf16
//     and are widened without their scales into one bf16 tile that serves
//     as K ([c | r]) and as V (its c columns);
//   - the fp32 queries are split once, at the start, into three bf16 terms
//     (hi + mid + lo, ~24 bits) kept in shared memory; each key's c and r
//     scales multiply the fp32 partial scores after the product, and the
//     softmax takes exp2((s - m) log2(e)), the difference rounded first;
//   - each past key's value scale is folded into P, and P is split into
//     three bf16 terms against the exact codes;
//   - the chunk's own fp32 latents are split too, once a launch, by a
//     first small kernel (mla_own_terms_kernel), and a tile takes the term
//     pairs whose product is not below 2^-24 of hi.hi (query or P term i
//     against key term j for i + j < 3), one key term at a time;
//   - each k16 step of the scores and each tile of P.V is summed from zero
//     in the tensor core and added in fp32: the unit's truncating
//     accumulation never runs over more than three MMAs (a step's query
//     terms) or six (a tile's P terms and two k16 steps).
// 12 warps.  The 8 computing warps take, for Q.K^T, two row groups of 16 x
// four quarters of the 576-wide dot product, whose partial scores meet in
// shared memory and are added in a fixed order; for the softmax the same
// row groups x four quarters of the 32 keys, each row's max and sum and
// P's terms meeting in shared memory; for P.V the same row groups x four
// quarters of the 512 value columns (a 16 x 128 fp32 accumulator a warp).  The 4 producer warps fill two key tiles in turn
// (full / empty mbarriers), so the next tile is widened while this one is
// computed: a past tile's codes arrive in a one-tile ring by bulk copies
// (the TMA unit, completing on an mbarrier; one copy of a page's run of c
// rows and one of r rows), with page ids and scales fetched a tile ahead;
// the own keys' terms go by one bulk copy straight into a key tile.  The
// causal edge and ragged tails are masked by select; pages not in tbl are
// never read.  Shared memory: the query terms (112 KB at dl 512, dr 64),
// two key tiles, the ring and the partial scores, ~228 KB: one block an
// SM, so the computing warps' phases of a tile (scores, their exchange,
// softmax, P.V) follow one another.  Shared memory, in bytes from the start
// (ex_layout): the query terms, the two key tiles, the ring, the partial
// scores (P's terms over them), the scales, the row maxima and sums, the
// mbarriers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int QR = 16;  // query rows per block (= one per warp in softmax)
constexpr int KT = 32;  // key rows per sub-tile (= one per lane)
constexpr int DCOL = 1;  // latent columns per thread: dl <= 512
constexpr float NEG_INF = -1e30f;

// One value of a cache row: kind 8 int8 code, kind 2 a 2-bit field of a
// uint32 word (code j at bits [2j, 2j+2)).
__device__ __forceinline__ float value_at(const char* row, int d, int kind) {
  if (kind == 8) return (float)reinterpret_cast<const int8_t*>(row)[d];
  const uint32_t w = reinterpret_cast<const uint32_t*>(row)[d >> 4];
  const uint32_t c = (w >> ((d & 15) * 2)) & 3u;
  const float mag = (c == 1u || c == 2u) ? 0.25f : 1.0f;
  return c >= 2u ? mag : -mag;
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

struct Smem {
  float* q;      // QR x ld: [ql | qr | 0]
  float* k;      // KT x ld: [c | r | 0], dequantized
  float* p;      // QR x KT probabilities
  float* part;   // WARPS x QR x KT partial scores
  float* m;      // QR running max
  float* l;      // QR running denominator
  float* a;      // QR this sub-tile's alpha
  float* sc;     // KT c-row scales
  float* sr;     // KT r-row scales
  int* lim;      // QR last visible key index of each row
  const char** crow;  // KT c-row pointers
  const char** rrow;  // KT r-row pointers
};

__host__ __device__ inline size_t smem_bytes(int ld) {
  return sizeof(float) * ((size_t)(QR + KT) * ld + (WARPS + 1) * QR * KT
                          + 3 * QR + 2 * KT)
         + sizeof(int) * QR + 2 * sizeof(const char*) * KT;
}

__device__ inline Smem carve(char* base, int ld) {
  Smem s;
  // pointers first: 8-byte aligned at the base
  s.crow = reinterpret_cast<const char**>(base);
  s.rrow = s.crow + KT;
  float* f = reinterpret_cast<float*>(s.rrow + KT);
  s.q = f;  // 16-byte aligned: 2 * KT pointers = 512 bytes
  s.k = s.q + (size_t)QR * ld;
  s.p = s.k + (size_t)KT * ld;
  s.part = s.p + QR * KT;
  s.m = s.part + WARPS * QR * KT;
  s.l = s.m + QR;
  s.a = s.l + QR;
  s.sc = s.a + QR;
  s.sr = s.sc + KT;
  s.lim = reinterpret_cast<int*>(s.sr + KT);
  return s;
}

// Rows are filled FB at a time: every global load of a batch is issued
// before the first shared-memory store, so the loads overlap instead of
// waiting on each other (the compiler cannot move a load across a store
// through a generic pointer).  A row of dw4 <= 2 * THREADS values is two
// values per thread.
constexpr int FB = 8;

// Load the block's QR query rows; rows >= n_rows are zero with lim = -1
// (never visible).  q row i: ql[i * dl .. ], qr[i * dr .. ].
__device__ inline void load_queries(const Smem& s, const float* ql,
                                    const float* qr, int n_rows, int dl,
                                    int dr, int dw4, int ld) {
  for (int r0 = 0; r0 < QR; r0 += FB) {
    float v[FB][2];
#pragma unroll
    for (int rr = 0; rr < FB; ++rr)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = r0 + rr, d = threadIdx.x + e * THREADS;
        float x = 0.f;
        if (r < n_rows) {
          if (d < dl) x = ql[(size_t)r * dl + d];
          else if (d < dl + dr) x = qr[(size_t)r * dr + d - dl];
        }
        v[rr][e] = x;
      }
#pragma unroll
    for (int rr = 0; rr < FB; ++rr)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = threadIdx.x + e * THREADS;
        if (d < dw4) s.q[(r0 + rr) * ld + d] = v[rr][e];
      }
  }
  if (threadIdx.x < QR) {
    s.m[threadIdx.x] = NEG_INF;
    s.l[threadIdx.x] = 0.f;
  }
}

// Dequantize the sub-tile's ncol rows (row pointers and scales staged in
// s.crow/s.rrow/s.sc/s.sr) into s.k; rows >= ncol are zero.
__device__ inline void fill_keys(const Smem& s, int ncol, int kind, int dl,
                                 int dr, int dw4, int ld) {
  for (int j0 = 0; j0 < KT; j0 += FB) {
    float v[FB][2];
#pragma unroll
    for (int jj = 0; jj < FB; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = j0 + jj, d = threadIdx.x + e * THREADS;
        float x = 0.f;
        if (j < ncol) {
          if (d < dl) x = value_at(s.crow[j], d, kind) * s.sc[j];
          else if (d < dl + dr)
            x = value_at(s.rrow[j], d - dl, kind) * s.sr[j];
        }
        v[jj][e] = x;
      }
#pragma unroll
    for (int jj = 0; jj < FB; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = threadIdx.x + e * THREADS;
        if (d < dw4) s.k[(j0 + jj) * ld + d] = v[jj][e];
      }
  }
}

// Scores, streaming softmax and p·c of one sub-tile whose row j is key
// kbase + j (rows >= ncol are absent).  acc[r][i]: row r, column
// threadIdx.x + i * THREADS.  Ends with a barrier-free value update; the
// caller syncs before s.k or s.p is rewritten.
__device__ inline void attend(const Smem& s, float (&acc)[QR][DCOL],
                              int kbase, int ncol, int dl, int dw4, int ld) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  {
    // partial scores over this warp's slice of [c | r]: a 4 x 4 tile of
    // (query row rg + 4i, key kg + 8j); the 8 lanes of a row group read 8
    // consecutive key rows, which the padded stride puts on distinct banks
    const int rg = lane >> 3, kg = lane & 7;
    const int slice = ((dw4 + WARPS - 1) / WARPS + 3) / 4 * 4;
    const int d0 = min(warp * slice, dw4), d1 = min(d0 + slice, dw4);
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int d = d0; d < d1; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(s.q + (rg + 4 * i) * ld + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(s.k + (kg + 8 * j) * ld + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[i][j] = fmaf(qv[i].x, kv[j].x, sc[i][j]);
          sc[i][j] = fmaf(qv[i].y, kv[j].y, sc[i][j]);
          sc[i][j] = fmaf(qv[i].z, kv[j].z, sc[i][j]);
          sc[i][j] = fmaf(qv[i].w, kv[j].w, sc[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        s.part[(warp * QR + rg + 4 * i) * KT + kg + 8 * j] = sc[i][j];
  }
  __syncthreads();
  {
    // warp r sums row r's partials over the slices in a fixed order, then
    // runs the row's streaming softmax with key = lane
    const int r = warp;
    float sc = 0.f;
#pragma unroll 4
    for (int w = 0; w < WARPS; ++w) sc += s.part[(w * QR + r) * KT + lane];
    const bool valid = lane < ncol && kbase + lane <= s.lim[r];
    const float sm = valid ? sc : NEG_INF;
    const float m_prev = s.m[r];
    const float m_new = fmaxf(m_prev, warp_max(sm));
    const float e = valid ? expf(sm - m_new) : 0.f;
    const float sum = warp_sum(e);
    s.p[r * KT + lane] = e;
    if (lane == 0) {
      const float alpha = expf(m_prev - m_new);
      s.a[r] = alpha;
      s.l[r] = alpha * s.l[r] + sum;
      s.m[r] = m_new;
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < DCOL; ++i) {
    const int d = threadIdx.x + i * THREADS;
    if (d < dl) {
#pragma unroll
      for (int r = 0; r < QR; ++r) acc[r][i] *= s.a[r];
#pragma unroll 2
      for (int j = 0; j < KT; j += 4) {
        const float c0 = s.k[(j + 0) * ld + d], c1 = s.k[(j + 1) * ld + d];
        const float c2 = s.k[(j + 2) * ld + d], c3 = s.k[(j + 3) * ld + d];
#pragma unroll
        for (int r = 0; r < QR; ++r) {
          const float4 pv = *reinterpret_cast<const float4*>(s.p + r * KT + j);
          acc[r][i] = fmaf(pv.x, c0, acc[r][i]);
          acc[r][i] = fmaf(pv.y, c1, acc[r][i]);
          acc[r][i] = fmaf(pv.z, c2, acc[r][i]);
          acc[r][i] = fmaf(pv.w, c3, acc[r][i]);
        }
      }
    }
  }
}

// Stage one sub-tile of a quantized page / flat run: rows row0 .. row0 +
// ncol - 1 of a code array (cq/rq rows `c_bytes`/`r_bytes` long) whose
// scales are one per `chunk` rows starting at scale row srow0 (rows
// counted from the page or request start `base_row`).
__device__ inline void stage_codes(const Smem& s, const char* cq,
                                   const char* rq,
                                   const __nv_bfloat16* cs,
                                   const __nv_bfloat16* rs, long long crow0,
                                   long long srow0, int sub0, int ncol,
                                   int chunk, size_t c_bytes,
                                   size_t r_bytes) {
  const int j = threadIdx.x;
  if (j < KT) {
    if (j < ncol) {
      const long long row = crow0 + sub0 + j;
      const long long srow = srow0 + (sub0 + j) / chunk;
      s.crow[j] = cq + (size_t)row * c_bytes;
      s.rrow[j] = rq + (size_t)row * r_bytes;
      s.sc[j] = __bfloat162float(cs[srow]);
      s.sr[j] = __bfloat162float(rs[srow]);
    } else {
      s.crow[j] = s.rrow[j] = nullptr;
      s.sc[j] = s.sr[j] = 0.f;
    }
  }
}

// Grid (n_split, ceil(H / QR), B).  ql (B, H, dl), qr (B, H, dr) fp32.
// Flat (tbl == nullptr): cq (B, S, wc), cs (B, SR), rq (B, S, wr), rs
// (B, SR).  Paged: cq (n_pages, tile, wc), cs (n_pages, tile / chunk), ...,
// tbl (B, n_tiles).  pos (B,).  Writes this split's raw (acc, m, l):
// part_acc (B, H, n_split, dl), part_m / part_l (B, H, n_split).
__global__ void __launch_bounds__(THREADS) mla_decode_kernel(
    const float* __restrict__ ql, const float* __restrict__ qr,
    const char* __restrict__ cq, const __nv_bfloat16* __restrict__ cs,
    const char* __restrict__ rq, const __nv_bfloat16* __restrict__ rs,
    const int* __restrict__ pos, const int* __restrict__ tbl,
    float* __restrict__ part_acc, float* __restrict__ part_m,
    float* __restrict__ part_l, int H, int dl, int dr, int S, int SR,
    int n_tiles, int tile, int chunk, int kv_bits, int wc, int wr,
    int tiles_per_split, int n_split, int dw4, int ld) {
  extern __shared__ __align__(16) char smem_raw[];
  const Smem s = carve(smem_raw, ld);
  const int split = blockIdx.x, h0 = blockIdx.y * QR, b = blockIdx.z;
  const int p = pos[b];
  const int n_rows = min(QR, H - h0);
  const size_t esz = kv_bits == 8 ? 1 : 4;
  const size_t c_bytes = (size_t)wc * esz, r_bytes = (size_t)wr * esz;

  load_queries(s, ql + ((size_t)b * H + h0) * dl,
               qr + ((size_t)b * H + h0) * dr, n_rows, dl, dr, dw4, ld);
  if (threadIdx.x < QR) s.lim[threadIdx.x] = threadIdx.x < n_rows ? p : -1;
  float acc[QR][DCOL];
#pragma unroll
  for (int r = 0; r < QR; ++r)
#pragma unroll
    for (int i = 0; i < DCOL; ++i) acc[r][i] = 0.f;

  const int kk0 = split * tiles_per_split;
  const int kk1 = min(min(kk0 + tiles_per_split, n_tiles), p / tile + 1);
  for (int kk = kk0; kk < kk1; ++kk) {
    const int t0 = kk * tile;
    int nvalid = min(tile, p - t0 + 1);
    long long crow0, srow0;
    if (tbl) {
      const long long pid = tbl[(size_t)b * n_tiles + kk];
      crow0 = pid * tile;
      srow0 = pid * (tile / chunk);
    } else {
      nvalid = min(nvalid, S - t0);
      crow0 = (long long)b * S + t0;
      srow0 = (long long)b * SR + t0 / chunk;
    }
    for (int sub0 = 0; sub0 < nvalid; sub0 += KT) {
      const int ncol = min(KT, nvalid - sub0);
      __syncthreads();  // the previous sub-tile is done with s.k and s.p
      stage_codes(s, cq, rq, cs, rs, crow0, srow0, sub0, ncol, chunk,
                  c_bytes, r_bytes);
      __syncthreads();
      fill_keys(s, ncol, kv_bits, dl, dr, dw4, ld);
      __syncthreads();
      attend(s, acc, t0 + sub0, ncol, dl, dw4, ld);
    }
  }
  __syncthreads();
  for (int r = 0; r < n_rows; ++r) {
    const size_t part = ((size_t)b * H + h0 + r) * n_split + split;
#pragma unroll
    for (int i = 0; i < DCOL; ++i) {
      const int d = threadIdx.x + i * THREADS;
      if (d < dl) part_acc[part * dl + d] = acc[r][i];
    }
    if (threadIdx.x == 0) {
      part_m[part] = s.m[r];
      part_l[part] = s.l[r];
    }
  }
}

// Grid (B * H).  Merges the splits in order: shift every split to the
// largest running max and normalize once.  Empty splits (m = NEG_INF,
// l = 0, acc = 0) add exact zeros.
__global__ void __launch_bounds__(THREADS) mla_merge_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_m,
    const float* __restrict__ part_l, float* __restrict__ out, int dl,
    int n_split) {
  const size_t bh = blockIdx.x;
  float mg = NEG_INF;
  for (int sp = 0; sp < n_split; ++sp)
    mg = fmaxf(mg, part_m[bh * n_split + sp]);
  for (int d = threadIdx.x; d < dl; d += THREADS) {
    float num = 0.f, den = 0.f;
    for (int sp = 0; sp < n_split; ++sp) {
      const size_t ps = bh * n_split + sp;
      const float w = expf(part_m[ps] - mg);
      num += w * part_acc[ps * dl + d];
      den += w * part_l[ps];
    }
    out[bh * dl + d] = num / fmaxf(den, 1e-30f);
  }
}

// ------------------------------------------------------------------ extend
//
// mla_extend_kernel: tensor cores, mma.sync m16n8k16 with bf16 operands and
// fp32 sums, held to the fp32 plain version (see the note at the top).

constexpr int EX_ROWS = 32;      // query rows a block: 32 heads of one token
constexpr int EX_KEYS = 32;      // keys a tile
constexpr int EX_THREADS = 256;  // 8 warps: 2 row groups x 4 quarters
constexpr int EX_PRODUCERS = 128;  // and four producer warps
constexpr int EX_BLOCK = EX_THREADS + EX_PRODUCERS;
constexpr int EX_TERMS = SPLIT_TERMS;  // bf16 terms of an fp32 operand
constexpr int EX_MAX_W = 576;    // padded latent + rope width
constexpr int EX_NQ = 16;        // 8-column value tiles a warp (128 columns)
constexpr int EX_SPP = 40;       // partial-score row pitch (floats)
constexpr int EX_PP = 80;        // P term row pitch (bytes): 32 keys + 16
constexpr float LOG2E = 1.44269504088896341f;

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Bulk copies (the TMA unit: one thread asks, the bytes land without
// registers) completing on an mbarrier of shared memory.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)), "r"(parity) : "memory");
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)), "l"(src), "r"(bytes),
      "r"(smem_u32(bar)) : "memory");
}
// Four 8x8 bf16 matrices from shared memory (lane l gives the address of
// row l % 8 of matrix l / 8), plain or transposed.
__device__ __forceinline__ void ldsm4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm4_t(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a.b: m16n8k16, A row-major, B column-major, bf16, fp32 sums.
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An int8 code word (4 codes) -> two bf16x2 words, exact: byte ^ 0x80 under
// exponent 2^23 is 2^23 + 128 + code; the difference has at most 8
// significant bits, so its top 16 bits are its bf16.  Codes at or past
// `valid` read as zero.
__device__ __forceinline__ uint2 i8x4_bf16(uint32_t w, int valid) {
  const uint32_t x = w ^ 0x80808080u;
  uint32_t u[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    u[k] = __float_as_uint(
        __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7540 + k)) -
        8388736.f);
  const uint2 b = make_uint2(__byte_perm(u[0], u[1], 0x7632),
                             __byte_perm(u[2], u[3], 0x7632));
  if (valid >= 4) return b;
  return make_uint2(valid >= 2 ? b.x : valid == 1 ? b.x & 0xFFFFu : 0u,
                    valid == 3 ? b.y & 0xFFFFu : 0u);
}

// Codes 2k and 2k + 1 of a word of 2-bit codes -> the bf16x2 bits of their
// levels {-1, -0.25, +0.25, +1}: one byte-permute picks each level's top
// byte (0xBF, 0xBE, 0x3E, 0x3F) and the low bytes 0x80.
__device__ __forceinline__ uint32_t lvl2x2_bf16(uint32_t w, int k) {
  const uint32_t t = w >> (4 * k);
  const uint32_t sel = 0x0404u | (t & 3u) << 4 | (t & 12u) << 10;
  return __byte_perm(0x3F3EBEBFu, 0x80808080u, sel);
}

// Shared-memory layout of the extend, in bytes from the start; the kernel
// and the launcher carve it with the same function.
struct ExLayout {
  int dlp, drp, dw, qp, cbp, rbp;
  int qs, kb, ring, spart, scl, rows, bar, total;
};

__host__ __device__ inline ExLayout ex_layout(int dl, int dr, int cb, int rb) {
  ExLayout g;
  g.dlp = (dl + 15) & ~15;
  g.drp = (dr + 15) & ~15;
  g.dw = g.dlp + g.drp;
  g.qp = 2 * g.dw + 16;  // an odd number of 16-byte units: ldmatrix rows
                         // fall on distinct banks
  g.cbp = (cb + 15) & ~15;  // the ring: a block of c rows, then of r rows
  g.rbp = (rb + 15) & ~15;
  g.qs = 0;
  g.kb = g.qs + EX_TERMS * EX_ROWS * g.qp;      // two key tiles
  g.ring = g.kb + 2 * EX_KEYS * g.qp;          // one tile of codes
  g.spart = g.ring + EX_KEYS * (g.cbp + g.rbp);
  g.scl = g.spart + 4 * EX_ROWS * EX_SPP * 4;  // a key tile's scales
  g.rows = g.scl + 2 * 3 * EX_KEYS * 4;        // row maxima, row sums
  g.bar = g.rows + 2 * 4 * EX_ROWS * 4;        // 8-byte aligned
  g.total = g.bar + 5 * 8;
  return g;
}

// Grid (Lp).  The chunk's own fp32 latents [c | r] -> their three bf16
// terms (split3), rows padded with zeros to the key tile's row of pw
// values (dl and dr each padded to 16, plus 8) and to Lp =
// EX_KEYS·ceil(L / EX_KEYS) rows: terms (3, Lp, pw), a tile of 32 rows one
// bulk copy into the extend's key tile.  nz (2, Lp / EX_KEYS), zeroed by
// the caller: 1 where terms 1 / 2 of a tile hold a non-zero value (never,
// for latents that are bf16 values, as the model's are: the extend then
// skips those terms, whose products are exact zeros).
__global__ void __launch_bounds__(128) mla_own_terms_kernel(
    const float* __restrict__ c_new, const float* __restrict__ r_new,
    __nv_bfloat16* __restrict__ terms, int* __restrict__ nz, int L, int Lp,
    int dl, int dr, int dlp, int pw) {
  const int key = blockIdx.x;
  bool nz1 = false, nz2 = false;
  for (int d = 2 * threadIdx.x; d < pw; d += 2 * blockDim.x) {
    float x0 = 0.f, x1 = 0.f;
    if (key < L) {
      if (d < dlp) {
        if (d < dl) x0 = c_new[(size_t)key * dl + d];
        if (d + 1 < dl) x1 = c_new[(size_t)key * dl + d + 1];
      } else {
        const int e = d - dlp;
        if (e < dr) x0 = r_new[(size_t)key * dr + e];
        if (e + 1 < dr) x1 = r_new[(size_t)key * dr + e + 1];
      }
    }
    uint32_t t3[EX_TERMS];
    split3(x0, x1, t3);
#pragma unroll
    for (int k = 0; k < EX_TERMS; ++k)
      *reinterpret_cast<uint32_t*>(terms + ((size_t)k * Lp + key) * pw + d) =
          t3[k];
    nz1 |= (t3[1] & 0x7FFF7FFFu) != 0;  // -0 is a zero term too
    nz2 |= (t3[2] & 0x7FFF7FFFu) != 0;
  }
  nz1 = __syncthreads_or(nz1);
  nz2 = __syncthreads_or(nz2);
  if (threadIdx.x == 0) {
    if (nz1) atomicOr(&nz[key / EX_KEYS], 1);
    if (nz2) atomicOr(&nz[Lp / EX_KEYS + key / EX_KEYS], 1);
  }
}

// Grid (ceil(H / EX_ROWS), L); block (hb, y) takes heads hb·32 .. +31 of
// chunk token L - 1 - y (the longest causal rows first).  ql (L, H, dl), qr
// (L, H, dr) fp32 scaled; c_new (L, dl), r_new (L, dr) fp32 and own, their
// terms from mla_own_terms_kernel; pools as in the paged decode (cb / rb
// code bytes a row), tbl (n_past,) full past pages; out (L, H, dl) fp32,
// normalized.  unit: 16 when every code row start allows bulk copies, else
// the cp.async size (4; 1 for plain byte copies).
//
// Warps 0-7 compute; warps 8-11 produce the key tiles the computing warps
// consume, in a fixed sequence of stages: one a past tile (its codes
// widened into a key tile, its scales beside it), 2n - 1 an own tile with
// n key terms that are not all zero (terms 0, 1, 2, then 1, 0 for P.V at
// n = 3; the last term serves the first P.V round too).  Stage s fills key
// tile s % 2; full[b] / empty[b] hand tile b over and back, so the
// producers widen the next tile while the others compute on this one.
__global__ void __launch_bounds__(EX_BLOCK, 1) mla_extend_kernel(
    const float* __restrict__ ql, const float* __restrict__ qr,
    const float* __restrict__ c_new, const float* __restrict__ r_new,
    const __nv_bfloat16* __restrict__ own, const int* __restrict__ own_nz,
    const char* __restrict__ cq, const __nv_bfloat16* __restrict__ cs,
    const char* __restrict__ rq, const __nv_bfloat16* __restrict__ rs,
    const int* __restrict__ tbl, int n_past, float* __restrict__ out, int H,
    int L, int dl, int dr, int page, int chunk, int kv_bits, int cb, int rb,
    int unit) {
  extern __shared__ __align__(16) char smem[];
  const ExLayout g = ex_layout(dl, dr, cb, rb);
  char* qs = smem + g.qs;      // [term][row][dw] bf16, pitch qp
  char* kbs = smem + g.kb;     // [tile][key][dw] bf16 (one term), pitch qp
  char* ring = smem + g.ring;  // [c rows | r rows], pitches cbp, rbp
  float* spart = reinterpret_cast<float*>(smem + g.spart);  // [q][row][key]
  float* scl = reinterpret_cast<float*>(smem + g.scl);  // [tile][3][key]
  // P's bf16 terms, [term][row][key] at a pitch of EX_PP bytes, over the
  // partial scores (read before P is written, written after P is read)
  char* ps = smem + g.spart;
  float* rmax = reinterpret_cast<float*>(smem + g.rows);  // [quarter][row]
  float* rsum = rmax + 4 * EX_ROWS;                       // [quarter][row]
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + g.bar);
  uint64_t* full = bars;       // [tile]: filled (producers' arrival, bytes)
  uint64_t* empty = bars + 2;  // [tile]: consumed (one arrival a warp)
  uint64_t* ring_bar = bars + 4;  // the codes of a past tile landed

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool producer = tid >= EX_THREADS;
  const int ptid = tid - EX_THREADS;  // producers: 0 .. EX_PRODUCERS - 1
  const int rg = warp & 1, qd = warp >> 1;  // row group, quarter
  const int gid = lane >> 2, tq = lane & 3;
  const int h0 = blockIdx.x * EX_ROWS;
  const int tok = L - 1 - blockIdx.y;
  const int np_keys = n_past * page;
  const int n_pt = (np_keys + EX_KEYS - 1) / EX_KEYS;
  const int n_t = n_pt + tok / EX_KEYS + 1;
  const int tile_bytes = EX_KEYS * g.qp;
  const int Lp = (L + EX_KEYS - 1) / EX_KEYS * EX_KEYS;
  // own tile o's key terms, in order (term 0 always; 1 and 2 where not all
  // zero): n of them, then its stages are those terms for Q.K^T and the
  // same but the last again in reverse for P.V, 2n - 1 in all
  auto own_terms = [&](int o, int (&term)[EX_TERMS]) {
    int n = 0;
    term[n++] = 0;
    if (own_nz[o]) term[n++] = 1;
    if (own_nz[Lp / EX_KEYS + o]) term[n++] = 2;
    return n;
  };

  if (tid == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(&full[b], 1);
      mbar_init(&empty[b], EX_THREADS / 32);
    }
    mbar_init(ring_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the last block-wide barrier: the roles part here

  if (producer) {
    const bool meta = ptid < 32;  // the first producer warp: lane = key row
    const bool bulk = unit == 16;
    // key row `lane` of a past tile: its page id and scales (bf16, widened
    // only when put), loaded a tile ahead of their use
    struct Meta {
      int pid;
      __nv_bfloat16 sc, sr;
    };
    auto load_meta = [&](int t) {
      const int key = t * EX_KEYS + lane;
      Meta m{0, __float2bfloat16(0.f), __float2bfloat16(0.f)};
      if (key < np_keys) {
        m.pid = tbl[key / page];
        const size_t srow =
            (size_t)m.pid * (page / chunk) + key % page / chunk;
        m.sc = cs[srow];
        m.sr = rs[srow];
      }
      return m;
    };
    Meta cur{0, __float2bfloat16(0.f), __float2bfloat16(0.f)}, nxt = cur;
    // past tile t's c and r code rows -> the ring (first producer warp;
    // pid: the page id of key row lane)
    auto issue = [&](int t, int pid) {
      const int k0 = t * EX_KEYS, n_live = min(EX_KEYS, np_keys - k0);
      if (bulk) {  // lane i: the tile's keys on its (i+1)-th page, a run of
                   // contiguous c rows and one of r rows (cbp = cb)
        const int p0 = k0 / page, runs = (k0 + n_live - 1) / page - p0 + 1;
        const int a = max(k0, (p0 + lane) * page);
        const int b = min(k0 + n_live, (p0 + lane + 1) * page);
        const int run_pid = __shfl_sync(0xffffffffu, pid, min(a - k0, 31));
        fence_proxy_async();
        if (lane == 0) mbar_expect(ring_bar, n_live * (cb + rb));
        __syncwarp();
        if (lane < runs) {
          const long long row = (long long)run_pid * page + a % page;
          bulk_copy(ring + (a - k0) * cb, cq + row * cb, (b - a) * cb,
                    ring_bar);
          bulk_copy(ring + EX_KEYS * cb + (a - k0) * rb, rq + row * rb,
                    (b - a) * rb, ring_bar);
        }
      } else if (lane < n_live) {  // lane r: key row r, unit by unit
        const long long row = (long long)pid * page + (k0 + lane) % page;
        const char* src[2] = {cq + row * cb, rq + row * rb};
        char* dst[2] = {ring + lane * g.cbp,
                        ring + EX_KEYS * g.cbp + lane * g.rbp};
        const int bytes[2] = {cb, rb};
        for (int m = 0; m < 2; ++m)
          for (int u = 0; u < bytes[m]; u += unit) {
            if (unit == 4)
              cp_async4(dst[m] + u, src[m] + u);
            else
              dst[m][u] = src[m][u];
          }
        cp_async_commit();
      }
    };
    // the ring -> key tile kbuf, exact, no scale; keys past the pages and
    // columns past dl / dr zero.  Producer thread ptid takes key row ptid / 4
    // and its 16-dim items ptid % 4 + 4k (a row has dw / 16 <= 36), five
    // ring loads in flight at a time
    const int nq16 = g.dw / 16, ncq16 = g.dlp / 16;
    auto widen = [&](int t, char* kbuf) {
      const int r = ptid >> 2, n_live = min(EX_KEYS, np_keys - t * EX_KEYS);
      const char* src_c = ring + r * g.cbp;
      const char* src_r = ring + EX_KEYS * g.cbp + r * g.rbp;
      char* dst = kbuf + r * g.qp;
#pragma unroll 1
      for (int k0 = 0; k0 < EX_MAX_W / 64; k0 += 5) {
        uint4 raw[5];
        int valid[5];
#pragma unroll
        for (int k = 0; k < 5; ++k) {
          const int q = (ptid & 3) + 4 * (k0 + k);
          const bool lat = q < ncq16;
          const int d = lat ? 16 * q : 16 * (q - ncq16);  // dim in c or r
          valid[k] = q < nq16 && r < n_live ? (lat ? dl : dr) - d : 0;
          raw[k] = make_uint4(0u, 0u, 0u, 0u);
          if (valid[k] > 0) {
            const char* src = lat ? src_c : src_r;
            if (kv_bits == 8)
              raw[k] = *reinterpret_cast<const uint4*>(src + d);
            else
              raw[k].x = *reinterpret_cast<const uint32_t*>(src + d / 4);
          }
        }
#pragma unroll
        for (int k = 0; k < 5; ++k) {
          const int q = (ptid & 3) + 4 * (k0 + k);
          if (q < nq16) {
            uint32_t u[8];
            if (kv_bits == 8) {
              const uint32_t w[4] = {raw[k].x, raw[k].y, raw[k].z, raw[k].w};
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const uint2 b = i8x4_bf16(w[i], valid[k] - 4 * i);
                u[2 * i] = b.x;
                u[2 * i + 1] = b.y;
              }
            } else {
#pragma unroll
              for (int i = 0; i < 8; ++i) {
                const uint32_t v = lvl2x2_bf16(raw[k].x, i);
                u[i] = 2 * i + 1 < valid[k] ? v
                       : 2 * i < valid[k]   ? v & 0xFFFFu : 0u;
              }
            }
            uint4* o = reinterpret_cast<uint4*>(dst + 32 * q);
            o[0] = make_uint4(u[0], u[1], u[2], u[3]);
            o[1] = make_uint4(u[4], u[5], u[6], u[7]);
          }
        }
      }
    };

    if (n_pt > 0 && meta) {
      cur = load_meta(0);
      issue(0, cur.pid);
      if (n_pt > 1) nxt = load_meta(1);
    }
    int s = 0;  // stage
    for (int t = 0; t < n_t; ++t) {
      if (t < n_pt) {
        const int b = s & 1;
        if (s >= 2) mbar_wait(&empty[b], ((s - 2) >> 1) & 1);
        if (bulk) {
          mbar_wait(ring_bar, t & 1);
        } else {
          if (meta) cp_async_wait_all();
          bar_sync(2, EX_PRODUCERS);
        }
        widen(t, kbs + b * tile_bytes);
        if (meta) {  // c and r for the scores, c again for the values
          float* st = scl + b * 3 * EX_KEYS;
          const float c = __bfloat162float(cur.sc);
          st[lane] = c;
          st[EX_KEYS + lane] = __bfloat162float(cur.sr);
          st[2 * EX_KEYS + lane] = c;
        }
        bar_sync(2, EX_PRODUCERS);  // the ring read, tile b written
        if (ptid == 0) mbar_arrive(&full[b]);
        if (t + 1 < n_pt && meta) {
          issue(t + 1, nxt.pid);
          cur = nxt;
          if (t + 2 < n_pt) nxt = load_meta(t + 2);
        }
        ++s;
      } else {  // own keys j0 .. j0 + 31: their terms, then back
        const int j0 = (t - n_pt) * EX_KEYS;
        int terms[EX_TERMS];
        const int n = own_terms(t - n_pt, terms);
        for (int i = 0; i < 2 * n - 1; ++i, ++s) {
          const int b = s & 1, term = terms[i < n ? i : 2 * n - 2 - i];
          if (ptid == 0) {
            if (s >= 2) mbar_wait(&empty[b], ((s - 2) >> 1) & 1);
            fence_proxy_async();
            mbar_expect(&full[b], tile_bytes);
            bulk_copy(kbs + b * tile_bytes,
                      own + ((size_t)term * Lp + j0) * (g.qp / 2),
                      tile_bytes, &full[b]);
          }
        }
      }
    }
    return;
  }

  // ---------------------------------------------------- computing warps
  const int nks = g.dw / 16, ncs = g.dlp / 16;  // k16 steps: all, latent
  const int kq = (nks + 3) / 4;                 // k16 steps a quarter
  const int s_lo = min(qd * kq, nks), s_hi = min(s_lo + kq, nks);
  const int ntv = g.dlp / 8;                    // 8-column value tiles
  const int nqv = 2 * ((ntv + 7) / 8);          // a quarter's, even
  const int v0 = qd * nqv;                      // this warp's first

  // four fp32 values of a [c | r] row padded to dlp + drp: dims 4q .. 4q + 3
  // (c_row dl wide, r_row dr wide), zero past dl / dr; one 16-byte load
  // when the widths and row starts allow (vec)
  const bool vec =
      dl % 4 == 0 && dr % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(ql) | reinterpret_cast<uintptr_t>(qr)) &
       15) == 0;
  auto load4 = [&](const float* c_row, const float* r_row, int q) {
    const bool lat = 4 * q < g.dlp;
    const int d = lat ? 4 * q : 4 * q - g.dlp, n = lat ? dl : dr;
    const float* p = lat ? c_row : r_row;
    if (vec)
      return d < n ? *reinterpret_cast<const float4*>(p + d)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    return make_float4(d < n ? p[d] : 0.f, d + 1 < n ? p[d + 1] : 0.f,
                       d + 2 < n ? p[d + 2] : 0.f, d + 3 < n ? p[d + 3] : 0.f);
  };
  // queries -> three bf16 terms; rows past H and columns past dl / dr zero.
  // Thread tid takes row tid / 8 and its 4-dim items tid % 8 + 8k, six
  // loads in flight at a time
  {
    const int r = tid >> 3, h = h0 + r;
    const bool ok = h < H;
    const size_t qrow = (size_t)tok * H + (ok ? h : 0);
    const float* c_row = ql + qrow * dl;
    const float* r_row = qr + qrow * dr;
    const int nq4 = g.dw / 4;
#pragma unroll 1
    for (int k0 = 0; k0 < EX_MAX_W / 32; k0 += 6) {
      float4 v[6];
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        const int q = (tid & 7) + 8 * (k0 + k);
        v[k] = ok && q < nq4 ? load4(c_row, r_row, q)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        const int q = (tid & 7) + 8 * (k0 + k);
        if (q < nq4) {
          uint32_t a[3], b[3];
          split3(v[k].x, v[k].y, a);
          split3(v[k].z, v[k].w, b);
#pragma unroll
          for (int i = 0; i < EX_TERMS; ++i)
            *reinterpret_cast<uint2*>(qs + (i * EX_ROWS + r) * g.qp + 8 * q) =
                make_uint2(a[i], b[i]);
        }
      }
    }
  }
  bar_sync(1, EX_THREADS);

  // ldmatrix lane offsets: A (query rows of this warp), B for the scores
  // (keys x dims of a key tile), B for the values (keys x columns, trans)
  const int lr = (lane & 7) + ((lane >> 3) & 1) * 8;  // row of matrix l / 8
  const char* qa_base = qs + (16 * rg + lr) * g.qp + (lane >> 4) * 16;
  const int kq_off =
      ((lane & 7) + (lane >> 4) * 8) * g.qp + ((lane >> 3) & 1) * 16;
  const int kv_off = lr * g.qp + (lane >> 4) * 16;

  // scores of this warp's k16 steps [s0, s1) against key tile kbuf for
  // query terms < nq added to ra (4 key tiles of 8): each step's products
  // summed from zero in the tensor core, then added in fp32
  auto qk = [&](float (&ra)[4][4], const char* kbuf, int s0, int s1,
                int nq) {
    const char* kb_qk = kbuf + kq_off;
#pragma unroll 1
    for (int s = s0; s < s1; ++s) {
      uint32_t b[2][4];
      ldsm4(b[0], kb_qk + 32 * s);
      ldsm4(b[1], kb_qk + 16 * g.qp + 32 * s);
      float st[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = 0.f;
#pragma unroll
      for (int k = EX_TERMS - 1; k >= 0; --k) {
        if (k < nq) {
          uint32_t a[4];
          ldsm4(a, qa_base + k * EX_ROWS * g.qp + 32 * s);
#pragma unroll
          for (int n = 0; n < 4; ++n)
            mma_bf16(st[n], a, b[n >> 1][2 * (n & 1)],
                     b[n >> 1][2 * (n & 1) + 1]);
        }
      }
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) ra[n][e] += st[n][e];
    }
  };

  // running state: rows gid (a) and gid + 8 (b) of this warp's 16: the max
  // and the denominator
  float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.f, l_b = 0.f;
  float acc[EX_NQ][4];
#pragma unroll
  for (int n = 0; n < EX_NQ; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  // P (three terms) . key tile kbuf's value columns for P terms < np,
  // summed from zero a 4-tile group at a time, then acc = acc * alpha +
  // tile (first) or acc + tile
  auto pv = [&](const uint32_t (&pa)[2][EX_TERMS][4], const char* kbuf,
                int np, bool first, float al_a, float al_b) {
    const char* kb_pv = kbuf + kv_off;
#pragma unroll
    for (int n0 = 0; n0 < EX_NQ; n0 += 4) {
      if (n0 < nqv && v0 + n0 < ntv) {
        float o[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
          for (int p2 = 0; p2 < 4; p2 += 2) {
            if (n0 + p2 < nqv && v0 + n0 + p2 < ntv) {
              uint32_t b[4];
              ldsm4_t(b, kb_pv + 16 * ks * g.qp + 16 * (v0 + n0 + p2));
#pragma unroll
              for (int k = EX_TERMS - 1; k >= 0; --k) {
                if (k < np) {
                  mma_bf16(o[p2], pa[ks][k], b[0], b[1]);
                  mma_bf16(o[p2 + 1], pa[ks][k], b[2], b[3]);
                }
              }
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float* a = acc[n0 + i];
          if (first) {
            a[0] = fmaf(a[0], al_a, o[i][0]);
            a[1] = fmaf(a[1], al_a, o[i][1]);
            a[2] = fmaf(a[2], al_b, o[i][2]);
            a[3] = fmaf(a[3], al_b, o[i][3]);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) a[e] += o[i][e];
          }
        }
      }
    }
  };
  // stage st's key tile: wait until filled; give it back when done
  auto tile_of = [&](int st) {
    mbar_wait(&full[st & 1], (st >> 1) & 1);
    return kbs + (st & 1) * tile_bytes;
  };
  auto release = [&](int st) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st & 1]);
  };

  int s = 0;  // stage
#pragma unroll 1
  for (int t = 0; t < n_t; ++t) {
    const bool past = t < n_pt;
    const int j0 = past ? t * EX_KEYS : (t - n_pt) * EX_KEYS;
    const int n_live = min(EX_KEYS, (past ? np_keys : L) - j0);
    // this warp's partial scores, c and r steps apart (their scales differ)
    float tc[4][4], tr[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) tc[n][e] = tr[n][e] = 0.f;
    auto qk_round = [&](const char* kbuf, int nq) {
      qk(tc, kbuf, s_lo, min(s_hi, ncs), nq);
      qk(tr, kbuf, max(s_lo, ncs), s_hi, nq);
    };

    const char* kt;  // the key tile P.V starts on
    int terms[EX_TERMS], n = 1;  // own: the key terms (past: the codes)
    if (past) {
      kt = tile_of(s);
      qk_round(kt, EX_TERMS);  // exact codes: every query term once
    } else {
      // fp32 own keys, split too: query term i x key term j for i + j < 3
      n = own_terms(t - n_pt, terms);
#pragma unroll 1
      for (int i = 0; i < n; ++i) {
        kt = tile_of(s + i);
        qk_round(kt, EX_TERMS - terms[i]);
        if (i < n - 1) release(s + i);
      }
    }

    // scale, publish this quarter's partial scores
    bar_sync(1, EX_THREADS);  // the last tile's partial scores are read
    const float* sct = scl + (s & 1) * 3 * EX_KEYS;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int key = 8 * n + 2 * tq;
      const float c0 = past ? sct[key] : 1.f;
      const float c1 = past ? sct[key + 1] : 1.f;
      const float r0 = past ? sct[EX_KEYS + key] : 1.f;
      const float r1 = past ? sct[EX_KEYS + key + 1] : 1.f;
      float* sp = spart + (qd * EX_ROWS + 16 * rg + gid) * EX_SPP + key;
      *reinterpret_cast<float2*>(sp) =
          make_float2(c0 * tc[n][0] + r0 * tr[n][0],
                      c1 * tc[n][1] + r1 * tr[n][1]);
      *reinterpret_cast<float2*>(sp + 8 * EX_SPP) =
          make_float2(c0 * tc[n][2] + r0 * tr[n][2],
                      c1 * tc[n][3] + r1 * tr[n][3]);
    }
    bar_sync(1, EX_THREADS);

    // streaming softmax, each warp over key tile qd (8 keys) of its 16
    // rows: the four quarters' partials in order, masked by select; each
    // row's max and sum meet through shared memory in a fixed order, P's
    // terms too, so the four warps of a row group agree
    const int key = 8 * qd + 2 * tq;  // this lane's two keys
    float sc4[4];  // rows a, a, b, b x keys key, key + 1
    bool live[4];
    {
      float2 xa = make_float2(0.f, 0.f), xb = make_float2(0.f, 0.f);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float* sp = spart + (q * EX_ROWS + 16 * rg + gid) * EX_SPP + key;
        const float2 ya = *reinterpret_cast<const float2*>(sp);
        const float2 yb = *reinterpret_cast<const float2*>(sp + 8 * EX_SPP);
        xa.x += ya.x;
        xa.y += ya.y;
        xb.x += yb.x;
        xb.y += yb.y;
      }
      live[0] = live[2] = key < n_live && (past || j0 + key <= tok);
      live[1] = live[3] = key + 1 < n_live && (past || j0 + key + 1 <= tok);
      sc4[0] = live[0] ? xa.x : NEG_INF;
      sc4[1] = live[1] ? xa.y : NEG_INF;
      sc4[2] = live[2] ? xb.x : NEG_INF;
      sc4[3] = live[3] ? xb.y : NEG_INF;
    }
    const int row_a = 16 * rg + gid, row_b = row_a + 8;
    float mx_a = fmaxf(sc4[0], sc4[1]), mx_b = fmaxf(sc4[2], sc4[3]);
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o));
    }
    if (tq == 0) {
      rmax[qd * EX_ROWS + row_a] = mx_a;
      rmax[qd * EX_ROWS + row_b] = mx_b;
    }
    bar_sync(1, EX_THREADS);  // every quarter's maxima; spart read
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      mx_a = fmaxf(mx_a, rmax[q * EX_ROWS + row_a]);
      mx_b = fmaxf(mx_b, rmax[q * EX_ROWS + row_b]);
    }
    // exp(x - m) as exp2((x - m) log2(e)): the difference first, so that
    // its rounding, not the score's, meets log2(e)
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float al_a = exp2f((m_a - mn_a) * LOG2E);
    const float al_b = exp2f((m_b - mn_b) * LOG2E);
    m_a = mn_a;
    m_b = mn_b;
    const float sv0 = past ? sct[2 * EX_KEYS + key] : 1.f;
    const float sv1 = past ? sct[2 * EX_KEYS + key + 1] : 1.f;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p =
          live[e] ? exp2f((sc4[e] - (e < 2 ? mn_a : mn_b)) * LOG2E) : 0.f;
      if (e < 2)
        sum_a += p;
      else
        sum_b += p;
      sc4[e] = p * ((e & 1) ? sv1 : sv0);  // the value scale folded in
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      sum_a += __shfl_xor_sync(0xffffffffu, sum_a, o);
      sum_b += __shfl_xor_sync(0xffffffffu, sum_b, o);
    }
    {
      uint32_t ta[3], tb[3];
      split3(sc4[0], sc4[1], ta);
      split3(sc4[2], sc4[3], tb);
#pragma unroll
      for (int k = 0; k < EX_TERMS; ++k) {
        *reinterpret_cast<uint32_t*>(
            ps + (k * EX_ROWS + row_a) * EX_PP + 2 * key) = ta[k];
        *reinterpret_cast<uint32_t*>(
            ps + (k * EX_ROWS + row_b) * EX_PP + 2 * key) = tb[k];
      }
    }
    if (tq == 0) {
      rsum[qd * EX_ROWS + row_a] = sum_a;
      rsum[qd * EX_ROWS + row_b] = sum_b;
    }
    bar_sync(1, EX_THREADS);  // P's terms and the row sums written
    l_a = al_a * l_a + (((rsum[row_a] + rsum[EX_ROWS + row_a]) +
                         rsum[2 * EX_ROWS + row_a]) +
                        rsum[3 * EX_ROWS + row_a]);
    l_b = al_b * l_b + (((rsum[row_b] + rsum[EX_ROWS + row_b]) +
                         rsum[2 * EX_ROWS + row_b]) +
                        rsum[3 * EX_ROWS + row_b]);
    // P as A fragments, three terms: k16 step ks holds keys 16ks .. +15
    uint32_t pa[2][EX_TERMS][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int k = 0; k < EX_TERMS; ++k)
        ldsm4(pa[ks][k], ps + (k * EX_ROWS + 16 * rg + lr) * EX_PP +
                             (16 * ks + (lane >> 4) * 8) * 2);

    if (past) {
      pv(pa, kt, EX_TERMS, true, al_a, al_b);
      release(s);
      ++s;
    } else {
      // the own keys' last term; then the others, each against the P terms
      // that keep the product's error below 2^-24
      pv(pa, kt, EX_TERMS - terms[n - 1], true, al_a, al_b);
      release(s + n - 1);
#pragma unroll 1
      for (int i = n; i < 2 * n - 1; ++i) {
        pv(pa, tile_of(s + i), EX_TERMS - terms[2 * n - 2 - i], false, 1.f,
           1.f);
        release(s + i);
      }
      s += 2 * n - 1;
    }
  }

#pragma unroll
  for (int n = 0; n < EX_NQ; ++n) {
    const int col = 8 * (v0 + n) + 2 * tq;
    if (n < nqv && col < dl) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = h0 + 16 * rg + gid + (e < 2 ? 0 : 8);
        const int c = col + (e & 1);
        if (h < H && c < dl)
          out[((size_t)tok * H + h) * dl + c] =
              acc[n][e] / fmaxf(e < 2 ? l_a : l_b, 1e-30f);
      }
    }
  }
}

// dot length and padded shared-memory row of [q|k] rows of dl + dr values:
// a row stride of 4 mod 32 floats puts 8 consecutive rows' float4 reads on
// distinct banks
void row_geometry(int dl, int dr, int* dw4, int* ld) {
  const int dw = dl + dr;
  *dw4 = (dw + 3) / 4 * 4;
  *ld = (dw + 31) / 32 * 32 + 4;
}

}  // namespace

extern "C" int mla_decode_launch(
    const float* ql, const float* qr, const void* cq, const void* cs,
    const void* rq, const void* rs, const int* pos, const int* tbl,
    float* part_acc, float* part_m, float* part_l, float* out, int B, int H,
    int dl, int dr, int S, int SR, int n_tiles, int tile, int chunk,
    int kv_bits, int wc, int wr, int tiles_per_split, int n_split,
    void* stream) {
  if (dl > DCOL * THREADS || dl + dr > 2 * THREADS ||
      (kv_bits != 8 && kv_bits != 2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  int dw4, ld;
  row_geometry(dl, dr, &dw4, &ld);
  const size_t smem = smem_bytes(ld);
  int err = allow_smem((const void*)mla_decode_kernel, smem);
  if (err) return err;
  const dim3 grid(n_split, (H + QR - 1) / QR, B);
  mla_decode_kernel<<<grid, THREADS, smem, st>>>(
      ql, qr, (const char*)cq, (const __nv_bfloat16*)cs, (const char*)rq,
      (const __nv_bfloat16*)rs, pos, tbl, part_acc, part_m, part_l, H, dl,
      dr, S, SR, n_tiles, tile, chunk, kv_bits, wc, wr, tiles_per_split,
      n_split, dw4, ld);
  err = (int)cudaGetLastError();
  if (err) return err;
  mla_merge_kernel<<<B * H, THREADS, 0, st>>>(part_acc, part_m, part_l, out,
                                               dl, n_split);
  return (int)cudaGetLastError();
}

// The extend's latent and rope widths: dl within the value tiles of four
// quarters, both (each padded to 16) within a key-tile row.
static bool ex_widths_ok(int dl, int dr) {
  return dl <= EX_NQ * 8 * 4 && ((dl + 15) & ~15) + ((dr + 15) & ~15) <= EX_MAX_W;
}

// The scratch that mla_extend_launch takes for an L-token chunk, in
// elements (its one owner; the caller allocates it): own, the chunk's own
// latents' bf16 terms, (3, 32·ceil(L / 32), the key tile's row of dl and
// dr each padded to 16, plus 8); own_nz, int32 (2, ceil(L / 32)), zeroed
// by the caller.  cudaErrorInvalidValue for widths the extend does not take.
extern "C" int mla_extend_scratch(int L, int dl, int dr, long long* own,
                                  long long* own_nz) {
  if (!ex_widths_ok(dl, dr)) return (int)cudaErrorInvalidValue;
  const long long tiles = (L + EX_KEYS - 1) / EX_KEYS;
  *own = EX_TERMS * tiles * EX_KEYS * (ex_layout(dl, dr, 0, 0).qp / 2);
  *own_nz = 2 * tiles;
  return 0;
}

// own, own_nz: scratch of the sizes mla_extend_scratch gives.
extern "C" int mla_extend_launch(
    const float* ql, const float* qr, const float* c_new, const float* r_new,
    void* own, int* own_nz, const void* cq, const void* cs, const void* rq,
    const void* rs, const int* tbl, int n_past, float* out, int H, int L,
    int dl, int dr, int page, int chunk, int kv_bits, int wc, int wr,
    void* stream) {
  if (!ex_widths_ok(dl, dr) || (kv_bits != 8 && kv_bits != 2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int esz = kv_bits == 8 ? 1 : 4;
  const int cb = wc * esz, rb = wr * esz;
  const uintptr_t a = reinterpret_cast<uintptr_t>(cq) |
                      reinterpret_cast<uintptr_t>(rq);
  const int unit = (cb % 16 == 0 && rb % 16 == 0 && a % 16 == 0) ? 16
                   : (cb % 4 == 0 && rb % 4 == 0 && a % 4 == 0)   ? 4
                                                                  : 1;
  const ExLayout g = ex_layout(dl, dr, cb, rb);
  int err = allow_smem((const void*)mla_extend_kernel, g.total);
  if (err) return err;
  const int Lp = (L + EX_KEYS - 1) / EX_KEYS * EX_KEYS;
  mla_own_terms_kernel<<<Lp, 128, 0, st>>>(c_new, r_new,
                                          (__nv_bfloat16*)own, own_nz, L, Lp,
                                          dl, dr, g.dlp, g.qp / 2);
  err = (int)cudaGetLastError();
  if (err) return err;
  const dim3 grid((H + EX_ROWS - 1) / EX_ROWS, L);
  mla_extend_kernel<<<grid, EX_BLOCK, g.total, st>>>(
      ql, qr, c_new, r_new, (const __nv_bfloat16*)own, own_nz,
      (const char*)cq, (const __nv_bfloat16*)cs, (const char*)rq,
      (const __nv_bfloat16*)rs, tbl, n_past, out, H, L, dl, dr, page, chunk,
      kv_bits, cb, rb, unit);
  return (int)cudaGetLastError();
}
