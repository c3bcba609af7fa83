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
// Bound.  Decode reads every live code and scale of the cache once per
// token: bytes, not operations (4 FMAs per code at G = 4).  Extend does
// L*G query rows against n_past pages: at L = 256 it is bound by fp32
// operations.
//
// Design.  The TPU kernels carry (acc, m, l) across a sequential grid axis;
// here blocks run in no order.  Decode gives each block (split, kv head,
// request) a fixed run of TILES_PER_SPLIT tiles that it walks in order with
// the running triple in registers and shared memory; a second kernel merges
// the splits in a fixed order (as ops._merge_partials does), so the result
// is deterministic.  Splits are fixed runs of tiles, so the flat and the
// paged call partition a request's live tiles the same way whatever the
// allocated length: at tile = page they are bitwise equal.  Tiles wholly
// past pos are skipped (they are exact no-ops of the streaming update);
// rows past pos, and past S for a flat cache, are never read, so trash and
// stale page-table entries never reach the result.  Codes are dequantized
// in registers: int8 x per-(token, head) scale, or a 2-bit field of a
// uint32 word -> {-1, -0.25, +0.25, +1} x per-chunk scale; the scale is
// applied to each row's dot product.  Extend gives each block 16 query rows
// of one KV head; K and then V tiles are dequantized into shared memory.
// Plain fp32 FMAs throughout: no tensor cores, no TMA yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_G = 16;     // query heads per KV head
constexpr int MAX_DCOL = 2;   // head dims up to 2 * THREADS = 256
constexpr int QR = 16;        // extend: query rows per block
constexpr int TPR = THREADS / QR;  // extend: threads per query row
constexpr float NEG_INF = -1e30f;

// One code of a cache row, without its scale.  kv8: int8; kv2: 16 two-bit
// codes per uint32 word, code j at bits [2j, 2j+2).
__device__ __forceinline__ float code_at(const char* row, int d,
                                         int kv_bits) {
  if (kv_bits == 8) return (float)reinterpret_cast<const int8_t*>(row)[d];
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

// Grid (n_split, KV, B).  q: (B, KV, G, Dh) fp32, scale folded in.
// Flat (tbl == nullptr): codes (B, S, KV, w), scales (B, SR, KV).
// Paged: codes (n_pages, tile, KV, w), scales (n_pages, tile / chunk, KV),
// tbl (B, n_tiles).  pos: (B,) last valid row of each request.  Writes
// this split's raw (acc, m, l).
__global__ void __launch_bounds__(THREADS) fd_decode_kernel(
    const float* __restrict__ q, const char* __restrict__ kq,
    const __nv_bfloat16* __restrict__ ks, const char* __restrict__ vq,
    const __nv_bfloat16* __restrict__ vs, const int* __restrict__ pos,
    const int* __restrict__ tbl, float* __restrict__ part_acc,
    float* __restrict__ part_m, float* __restrict__ part_l, int KV, int G,
    int Dh, int Dv, int S, int SR, int n_tiles, int tile, int chunk,
    int kv_bits, int wk, int wv, int tiles_per_split, int n_split) {
  extern __shared__ float smem[];
  float* q_s = smem;             // G * Dh
  float* p_s = q_s + G * Dh;     // G * tile: scores, then probabilities
  float* sk_s = p_s + G * tile;  // tile: K row scales
  float* sv_s = sk_s + tile;     // tile: V row scales
  float* m_s = sv_s + tile;      // G
  float* l_s = m_s + G;          // G
  float* a_s = l_s + G;          // G: this tile's alpha

  const int split = blockIdx.x, kv = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p = pos[b];
  const int esz = kv_bits == 8 ? 1 : 4;
  const size_t kstride = (size_t)wk * esz, vstride = (size_t)wv * esz;

  const float* qb = q + (size_t)(b * KV + kv) * G * Dh;
  for (int i = tid; i < G * Dh; i += THREADS) q_s[i] = qb[i];
  if (tid < G) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[MAX_G][MAX_DCOL];
#pragma unroll
  for (int g = 0; g < MAX_G; ++g)
#pragma unroll
    for (int i = 0; i < MAX_DCOL; ++i) acc[g][i] = 0.f;
  __syncthreads();

  const int kk0 = split * tiles_per_split;
  const int kk1 = min(min(kk0 + tiles_per_split, n_tiles), p / tile + 1);
  for (int kk = kk0; kk < kk1; ++kk) {
    const int t0 = kk * tile;
    int nvalid = min(tile, p - t0 + 1);
    long long crow0, srow0;  // code row and scale row of the tile's row 0
    if (tbl) {
      const long long pid = tbl[(size_t)b * n_tiles + kk];
      crow0 = pid * tile;
      srow0 = pid * (tile / chunk);
    } else {
      nvalid = min(nvalid, S - t0);
      crow0 = (long long)b * S + t0;
      srow0 = (long long)b * SR + t0 / chunk;
    }
    // scores: one warp per row, lanes across the head dim
    for (int r = warp; r < tile; r += WARPS) {
      if (r < nvalid) {
        const size_t crow = (size_t)(crow0 + r) * KV + kv;
        const char* krow = kq + crow * kstride;
        float s[MAX_G];
#pragma unroll
        for (int g = 0; g < MAX_G; ++g) s[g] = 0.f;
        for (int d = lane; d < Dh; d += 32) {
          const float c = code_at(krow, d, kv_bits);
#pragma unroll
          for (int g = 0; g < MAX_G; ++g)
            if (g < G) s[g] += q_s[g * Dh + d] * c;
        }
#pragma unroll
        for (int g = 0; g < MAX_G; ++g)
          if (g < G) s[g] = warp_sum(s[g]);
        if (lane == 0) {
          const size_t srow = (size_t)(srow0 + r / chunk) * KV + kv;
          const float sk = __bfloat162float(ks[srow]);
          sk_s[r] = sk;
          sv_s[r] = __bfloat162float(vs[srow]);
#pragma unroll
          for (int g = 0; g < MAX_G; ++g)
            if (g < G) p_s[g * tile + r] = s[g] * sk;
        }
      }
    }
    __syncthreads();
    // streaming softmax: one warp per query row
    for (int g = warp; g < G; g += WARPS) {
      float mx = NEG_INF;
      for (int r = lane; r < nvalid; r += 32) mx = fmaxf(mx, p_s[g * tile + r]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int r = lane; r < nvalid; r += 32) {
        const float e = expf(p_s[g * tile + r] - m_new);
        p_s[g * tile + r] = e;
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
    // acc = alpha * acc + p @ v: each thread owns head-dim columns
#pragma unroll
    for (int i = 0; i < MAX_DCOL; ++i) {
      const int d = tid + i * THREADS;
      if (d < Dv) {
#pragma unroll
        for (int g = 0; g < MAX_G; ++g)
          if (g < G) acc[g][i] *= a_s[g];
        for (int r = 0; r < nvalid; ++r) {
          const size_t crow = (size_t)(crow0 + r) * KV + kv;
          const float v = code_at(vq + crow * vstride, d, kv_bits) * sv_s[r];
#pragma unroll
          for (int g = 0; g < MAX_G; ++g)
            if (g < G) acc[g][i] += p_s[g * tile + r] * v;
        }
      }
    }
    __syncthreads();  // p_s and the scales are rewritten by the next tile
  }

  const size_t part = (size_t)(b * KV + kv) * n_split + split;
#pragma unroll
  for (int i = 0; i < MAX_DCOL; ++i) {
    const int d = tid + i * THREADS;
    if (d < Dv) {
#pragma unroll
      for (int g = 0; g < MAX_G; ++g)
        if (g < G) part_acc[(part * G + g) * Dv + d] = acc[g][i];
    }
  }
  if (tid < G) {
    part_m[part * G + tid] = m_s[tid];
    part_l[part * G + tid] = l_s[tid];
  }
}

// Grid (B * KV).  Merges the splits in order: shift every split to the
// largest running max and normalize once (the distributed-softmax identity).
// Empty splits (m = NEG_INF, l = 0, acc = 0) add exact zeros.
__global__ void __launch_bounds__(THREADS) fd_merge_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_m,
    const float* __restrict__ part_l, float* __restrict__ out, int G, int Dv,
    int n_split) {
  const size_t bk = blockIdx.x;
  for (int i = threadIdx.x; i < G * Dv; i += THREADS) {
    const int g = i / Dv, d = i % Dv;
    float mg = NEG_INF;
    for (int s = 0; s < n_split; ++s)
      mg = fmaxf(mg, part_m[(bk * n_split + s) * G + g]);
    float num = 0.f, den = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const size_t ps = (bk * n_split + s) * G + g;
      const float w = expf(part_m[ps] - mg);
      num += w * part_acc[ps * Dv + d];
      den += w * part_l[ps];
    }
    out[(bk * G + g) * Dv + d] = num / fmaxf(den, 1e-30f);
  }
}

// Grid (ceil(L*G / QR), KV).  q: (KV, L*G, Dh) fp32 scaled, row i is chunk
// token i / G; kf/vf: (KV, L, Dh|Dv) fp32; pools as in the paged decode;
// tbl: (n_past,) full past pages.  out: (L, KV*G, Dv) fp32, normalized.
__global__ void __launch_bounds__(THREADS) fe_extend_kernel(
    const float* __restrict__ q, const float* __restrict__ kf,
    const float* __restrict__ vf, const char* __restrict__ kq,
    const __nv_bfloat16* __restrict__ ks, const char* __restrict__ vq,
    const __nv_bfloat16* __restrict__ vs, const int* __restrict__ tbl,
    int n_past, float* __restrict__ out, int KV, int G, int L, int Dh,
    int Dv, int page, int chunk, int kv_bits, int wk, int wv) {
  extern __shared__ float smem[];
  const int ldt = max(Dh, Dv) + 1;  // padded: no bank conflicts across rows
  const int ldq = Dh + 1;
  float* t_s = smem;                // page * ldt: the K, then the V tile
  float* q_s = t_s + page * ldt;    // QR * ldq
  float* p_s = q_s + QR * ldq;      // QR * page
  float* a_s = p_s + QR * page;     // QR: alpha of the tile
  float* l_s = a_s + QR;            // QR: final denominators

  const int kv = blockIdx.y, r0 = blockIdx.x * QR, R = L * G;
  const int tid = threadIdx.x, row = tid / TPR, sub = tid % TPR;
  const int esz = kv_bits == 8 ? 1 : 4;
  const size_t kstride = (size_t)wk * esz, vstride = (size_t)wv * esz;

  for (int i = tid; i < QR * Dh; i += THREADS) {
    const int rr = i / Dh, d = i % Dh;
    q_s[rr * ldq + d] =
        r0 + rr < R ? q[((size_t)kv * R + r0 + rr) * Dh + d] : 0.f;
  }
  float acc[QR][MAX_DCOL];
#pragma unroll
  for (int r = 0; r < QR; ++r)
#pragma unroll
    for (int i = 0; i < MAX_DCOL; ++i) acc[r][i] = 0.f;
  float m_run = NEG_INF, l_run = 0.f;  // this thread's query row
  const int qtok = (r0 + row) / G;
  // fp sub-tiles past the block's last token are wholly masked: skipped
  const int tok_hi = min((min(r0 + QR, R) - 1) / G, L - 1);
  const int n_fp = tok_hi / page + 1;
  __syncthreads();

  for (int t = 0; t < n_past + n_fp; ++t) {
    const bool past = t < n_past;
    const int j0 = past ? 0 : (t - n_past) * page;
    const int ncol = past ? page : min(page, L - j0);
    const long long pid = past ? tbl[t] : 0;
    // K tile -> shared, dequantized
    for (int i = tid; i < page * Dh; i += THREADS) {
      const int c = i / Dh, d = i % Dh;
      float k = 0.f;
      if (past) {
        const size_t crow = (size_t)(pid * page + c) * KV + kv;
        const size_t srow = (size_t)(pid * (page / chunk) + c / chunk) * KV + kv;
        k = code_at(kq + crow * kstride, d, kv_bits) *
            __bfloat162float(ks[srow]);
      } else if (c < ncol) {
        k = kf[((size_t)kv * L + j0 + c) * Dh + d];
      }
      t_s[c * ldt + d] = k;
    }
    __syncthreads();
    // scores and the streaming softmax of query row `row`
    float mx = NEG_INF;
    for (int c = sub; c < ncol; c += TPR) {
      float s = 0.f;
      for (int d = 0; d < Dh; ++d) s += q_s[row * ldq + d] * t_s[c * ldt + d];
      const bool valid = past || j0 + c <= qtok;
      s = valid ? s : NEG_INF;
      p_s[row * page + c] = s;
      mx = fmaxf(mx, s);
    }
#pragma unroll
    for (int o = TPR / 2; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float m_new = fmaxf(m_run, mx);
    float sum = 0.f;
    for (int c = sub; c < ncol; c += TPR) {
      const bool valid = past || j0 + c <= qtok;
      const float e = valid ? expf(p_s[row * page + c] - m_new) : 0.f;
      p_s[row * page + c] = e;
      sum += e;
    }
#pragma unroll
    for (int o = TPR / 2; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float alpha = expf(m_run - m_new);
    l_run = alpha * l_run + sum;
    m_run = m_new;
    if (sub == 0) a_s[row] = alpha;
    __syncthreads();  // every score has read the K tile
    // V tile -> shared, dequantized
    for (int i = tid; i < page * Dv; i += THREADS) {
      const int c = i / Dv, d = i % Dv;
      float v = 0.f;
      if (past) {
        const size_t crow = (size_t)(pid * page + c) * KV + kv;
        const size_t srow = (size_t)(pid * (page / chunk) + c / chunk) * KV + kv;
        v = code_at(vq + crow * vstride, d, kv_bits) *
            __bfloat162float(vs[srow]);
      } else if (c < ncol) {
        v = vf[((size_t)kv * L + j0 + c) * Dv + d];
      }
      t_s[c * ldt + d] = v;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < MAX_DCOL; ++i) {
      const int d = tid + i * THREADS;
      if (d < Dv) {
#pragma unroll
        for (int r = 0; r < QR; ++r) acc[r][i] *= a_s[r];
        for (int c = 0; c < ncol; ++c) {
          const float v = t_s[c * ldt + d];
#pragma unroll
          for (int r = 0; r < QR; ++r) acc[r][i] += p_s[r * page + c] * v;
        }
      }
    }
    __syncthreads();  // t_s, p_s and a_s are rewritten by the next tile
  }

  if (sub == 0) l_s[row] = l_run;
  __syncthreads();
  const int H = KV * G;
#pragma unroll
  for (int i = 0; i < MAX_DCOL; ++i) {
    const int d = tid + i * THREADS;
    if (d < Dv) {
#pragma unroll
      for (int r = 0; r < QR; ++r) {
        const int qi = r0 + r;
        if (qi < R) {
          const int tok = qi / G, g = qi % G;
          out[((size_t)tok * H + kv * G + g) * Dv + d] =
              acc[r][i] / fmaxf(l_s[r], 1e-30f);
        }
      }
    }
  }
}

int set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

extern "C" int fd_decode_launch(
    const float* q, const void* kq, const void* ks, const void* vq,
    const void* vs, const int* pos, const int* tbl, float* part_acc,
    float* part_m, float* part_l, float* out, int B, int KV, int G, int Dh,
    int Dv, int S, int SR, int n_tiles, int tile, int chunk, int kv_bits,
    int wk, int wv, int tiles_per_split, int n_split, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) * (G * Dh + G * tile + 2 * tile + 3 * G);
  int err = set_smem((const void*)fd_decode_kernel, smem);
  if (err) return err;
  fd_decode_kernel<<<dim3(n_split, KV, B), THREADS, smem, st>>>(
      q, (const char*)kq, (const __nv_bfloat16*)ks, (const char*)vq,
      (const __nv_bfloat16*)vs, pos, tbl, part_acc, part_m, part_l, KV, G,
      Dh, Dv, S, SR, n_tiles, tile, chunk, kv_bits, wk, wv, tiles_per_split,
      n_split);
  err = (int)cudaGetLastError();
  if (err) return err;
  fd_merge_kernel<<<B * KV, THREADS, 0, st>>>(part_acc, part_m, part_l, out,
                                               G, Dv, n_split);
  return (int)cudaGetLastError();
}

extern "C" int fe_extend_launch(
    const float* q, const float* kf, const float* vf, const void* kq,
    const void* ks, const void* vq, const void* vs, const int* tbl,
    int n_past, float* out, int KV, int G, int L, int Dh, int Dv, int page,
    int chunk, int kv_bits, int wk, int wv, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int ldt = (Dh > Dv ? Dh : Dv) + 1;
  const size_t smem = sizeof(float) *
      ((size_t)page * ldt + QR * (Dh + 1) + QR * page + 2 * QR);
  int err = set_smem((const void*)fe_extend_kernel, smem);
  if (err) return err;
  const int row_blocks = (L * G + QR - 1) / QR;
  fe_extend_kernel<<<dim3(row_blocks, KV), THREADS, smem, st>>>(
      q, kf, vf, (const char*)kq, (const __nv_bfloat16*)ks, (const char*)vq,
      (const __nv_bfloat16*)vs, tbl, n_past, out, KV, G, L, Dh, Dv, page,
      chunk, kv_bits, wk, wv);
  return (int)cudaGetLastError();
}
