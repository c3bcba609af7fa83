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
// decode is bound by operations, not bytes (at B 4, S 8192: ~9.1 GFLOP,
// 0.136 ms at the fp32 peak of 67 TFLOP/s, against 5.6 us for the kv8
// codes).  The extend at L 256 over 16 past pages is ~82 GFLOP.
//
// Design.  A block owns QR = 16 query rows (decode: 16 heads of one
// request; extend: 16 consecutive (token, head) rows) and walks the keys in
// sub-tiles of KT = 32 rows.  For each sub-tile it dequantizes the 32 rows
// of [c | r] once into shared memory, fp32, and all 16 query rows use them:
// a kernel that re-read the rows per head would move 128x the bytes.  The
// (16 rows x dl) fp32 accumulator stays in registers across the 16 warps,
// each thread owning one latent column for all 16 rows.  Shared-memory
// reads, not the FMA pipes, limit such a kernel, so the scores are tiled
// in registers: each warp takes a 1/16 slice of the 576-wide dot product
// for all 16 x 32 (row, key) pairs, every thread a 4 x 4 tile of them (8
// float4 reads per 64 FMAs), and the 16 partial sums of a score are added
// in a fixed order before warp r runs row r's streaming softmax.  Values:
// each thread reads its column of the 32 key rows and the 16 rows'
// probabilities (broadcast float4 reads).  A query row i may see key j iff
// j <= lim_i: decode lim = pos (rows past pos are never read, so the trash
// page and stale table entries never reach the result); extend lim =
// n_past·page + token(i) (past pages all visible, the chunk causal).
// Decode splits each request's tiles into fixed runs of TILES_PER_SPLIT
// blocks and merges the splits in a second kernel in a fixed order
// (deterministic); the runs are fixed in tile units, so a flat and a paged
// call at tile = page split a request alike and agree bitwise.  Plain fp32
// FMAs: no tensor cores, no TMA yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int QR = 16;  // query rows per block (= one per warp in softmax)
constexpr int KT = 32;  // key rows per sub-tile (= one per lane)
constexpr int DCOL = 1;  // latent columns per thread: dl <= 512
constexpr float NEG_INF = -1e30f;

// One value of a cache row: kind 8 int8 code, kind 2 a 2-bit field of a
// uint32 word (code j at bits [2j, 2j+2)), kind 0 an fp32 value.
__device__ __forceinline__ float value_at(const char* row, int d, int kind) {
  if (kind == 8) return (float)reinterpret_cast<const int8_t*>(row)[d];
  if (kind == 0) return reinterpret_cast<const float*>(row)[d];
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

// Grid (ceil(L * H / QR)).  ql (L, H, dl), qr (L, H, dr) fp32 scaled,
// query row i is chunk token i / H; c_new (L, dl), r_new (L, dr) fp32;
// pools as in the paged decode, tbl (n_past,) full past pages.
// out (L, H, dl) fp32, normalized.
__global__ void __launch_bounds__(THREADS) mla_extend_kernel(
    const float* __restrict__ ql, const float* __restrict__ qr,
    const float* __restrict__ c_new, const float* __restrict__ r_new,
    const char* __restrict__ cq, const __nv_bfloat16* __restrict__ cs,
    const char* __restrict__ rq, const __nv_bfloat16* __restrict__ rs,
    const int* __restrict__ tbl, int n_past, float* __restrict__ out, int H,
    int L, int dl, int dr, int page, int chunk, int kv_bits, int wc, int wr,
    int dw4, int ld) {
  extern __shared__ __align__(16) char smem_raw[];
  const Smem s = carve(smem_raw, ld);
  const int r0 = blockIdx.x * QR, R = L * H;
  const int n_rows = min(QR, R - r0);
  const size_t esz = kv_bits == 8 ? 1 : 4;
  const size_t c_bytes = (size_t)wc * esz, r_bytes = (size_t)wr * esz;
  const int past_rows = n_past * page;

  load_queries(s, ql + (size_t)r0 * dl, qr + (size_t)r0 * dr, n_rows, dl, dr,
               dw4, ld);
  if (threadIdx.x < QR)
    s.lim[threadIdx.x] =
        threadIdx.x < n_rows ? past_rows + (r0 + threadIdx.x) / H : -1;
  float acc[QR][DCOL];
#pragma unroll
  for (int r = 0; r < QR; ++r)
#pragma unroll
    for (int i = 0; i < DCOL; ++i) acc[r][i] = 0.f;

  for (int t = 0; t < n_past; ++t) {
    const long long pid = tbl[t];
    for (int sub0 = 0; sub0 < page; sub0 += KT) {
      const int ncol = min(KT, page - sub0);
      __syncthreads();
      stage_codes(s, cq, rq, cs, rs, pid * page, pid * (page / chunk), sub0,
                  ncol, chunk, c_bytes, r_bytes);
      __syncthreads();
      fill_keys(s, ncol, kv_bits, dl, dr, dw4, ld);
      __syncthreads();
      attend(s, acc, t * page + sub0, ncol, dl, dw4, ld);
    }
  }
  // the chunk's own fp rows, causal; rows past the block's last token are
  // masked for every row of the block and skipped
  const int tok_hi = (r0 + n_rows - 1) / H;
  for (int j0 = 0; j0 <= tok_hi; j0 += KT) {
    const int ncol = min(KT, L - j0);
    __syncthreads();
    const int j = threadIdx.x;
    if (j < KT) {
      const bool ok = j < ncol;
      s.crow[j] = ok ? reinterpret_cast<const char*>(c_new + (size_t)(j0 + j) * dl)
                     : nullptr;
      s.rrow[j] = ok ? reinterpret_cast<const char*>(r_new + (size_t)(j0 + j) * dr)
                     : nullptr;
      s.sc[j] = s.sr[j] = ok ? 1.f : 0.f;  // x * 1.0f == x: values as given
    }
    __syncthreads();
    fill_keys(s, ncol, 0, dl, dr, dw4, ld);
    __syncthreads();
    attend(s, acc, past_rows + j0, ncol, dl, dw4, ld);
  }
  __syncthreads();
  for (int r = 0; r < n_rows; ++r) {
    const float inv_l = s.l[r];
#pragma unroll
    for (int i = 0; i < DCOL; ++i) {
      const int d = threadIdx.x + i * THREADS;
      if (d < dl)
        out[(size_t)(r0 + r) * dl + d] = acc[r][i] / fmaxf(inv_l, 1e-30f);
    }
  }
}

int set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
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
  int err = set_smem((const void*)mla_decode_kernel, smem);
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

extern "C" int mla_extend_launch(
    const float* ql, const float* qr, const float* c_new, const float* r_new,
    const void* cq, const void* cs, const void* rq, const void* rs,
    const int* tbl, int n_past, float* out, int H, int L, int dl, int dr,
    int page, int chunk, int kv_bits, int wc, int wr, void* stream) {
  if (dl > DCOL * THREADS || dl + dr > 2 * THREADS ||
      (kv_bits != 8 && kv_bits != 2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  int dw4, ld;
  row_geometry(dl, dr, &dw4, &ld);
  const size_t smem = smem_bytes(ld);
  int err = set_smem((const void*)mla_extend_kernel, smem);
  if (err) return err;
  const int blocks = (L * H + QR - 1) / QR;
  mla_extend_kernel<<<blocks, THREADS, smem, st>>>(
      ql, qr, c_new, r_new, (const char*)cq, (const __nv_bfloat16*)cs,
      (const char*)rq, (const __nv_bfloat16*)rs, tbl, n_past, out, H, L, dl,
      dr, page, chunk, kv_bits, wc, wr, dw4, ld);
  return (int)cudaGetLastError();
}
