// AttnCon column sums: col[b, h, j] = sum_i softmax(q k^T / sqrt(Dh))[i, j]
// per head, causal, without ever forming the T x T attention map.
//
// Replaces: attn_colsum_pallas in src/repro/kernels/attn_colsum/kernel.py
// (its two pallas_calls, _rowstats_kernel and _colsum_kernel).
//
// What bounds it on the H100: operations.  Each pass computes the causal
// half of q k^T, T²/2 · Dh multiply-adds per head, and an exp per score,
// on only 2·T·Dh input values per head: at T = 512, Dh = 128 that is about
// 130 operations per input byte, above the fp32 ~20 per byte of the card.
// The limit is the fp32 rate (the scores are computed outside the tensor
// cores in this first version).
//
// Design: the same two passes as the TPU kernel, each a CUDA kernel.
//   pass 1 (rowstats): one block per (head, 64-query tile) walks the key
//     tiles up to the diagonal with a running max m_i and denominator l_i
//     (streaming softmax) and writes (m, l) per query.
//   pass 2 (colsum): one block per (head, 64-key tile, split) walks the
//     query tiles at or below the diagonal, sums exp(s - m_i) / l_i down
//     each key column, reduces across its threads in shared memory and adds
//     its piece into col with fp32 atomics.  The query tiles of a key tile
//     are split across `splits` blocks so short key tiles near the end of
//     the sequence do not leave the card idle; with atomics the order of
//     the sum varies from run to run (last-bit differences).
// Scores are 64 x 64 tiles; each of the 256 threads holds 4 x 4 of them,
// rows ty + 16·a and columns tx + 16·b.  The head dimension is staged in
// 32-wide chunks through padded shared memory.  Row reductions use warp
// shuffles within the 16 lanes that share a row.  GQA: query head h reads
// key head h / n_rep straight from the (B, T, KV, Dh) layout, so the keys
// are never repeated in memory.  Ragged T and Dh are masked.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int TQ = 64;
constexpr int TK = 64;
constexpr int DC = 32;
constexpr int THREADS = 256;
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

struct Geo {
  int B, T, H, KV, Dh, n_rep;
};

// s[a][b] = q[qt*TQ + ty + 16a] . k[kt*TK + tx + 16b] (unscaled)
template <typename T>
__device__ __forceinline__ void score_tile(
    const T* __restrict__ q, const T* __restrict__ k, const Geo& g, int bh,
    int qt, int kt, float (*qs)[TQ + 1], float (*ks)[TK + 1],
    float s[4][4]) {
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int b = bh / g.H, h = bh % g.H, kvh = h / g.n_rep;
  const T* qb = q + ((size_t)b * g.T * g.H + h) * g.Dh;
  const T* kb = k + ((size_t)b * g.T * g.KV + kvh) * g.Dh;
  const size_t qstride = (size_t)g.H * g.Dh, kstride = (size_t)g.KV * g.Dh;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[a][c] = 0.f;
  for (int e0 = 0; e0 < g.Dh; e0 += DC) {
    for (int idx = tid; idx < TQ * DC; idx += THREADS) {
      const int row = idx / DC, e = idx % DC;
      const int t = qt * TQ + row;
      qs[e][row] = (t < g.T && e0 + e < g.Dh)
                       ? to_f(qb[(size_t)t * qstride + e0 + e]) : 0.f;
    }
    for (int idx = tid; idx < TK * DC; idx += THREADS) {
      const int row = idx / DC, e = idx % DC;
      const int t = kt * TK + row;
      ks[e][row] = (t < g.T && e0 + e < g.Dh)
                       ? to_f(kb[(size_t)t * kstride + e0 + e]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int e = 0; e < DC; ++e) {
      float qa[4], kc[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qa[a] = qs[e][ty + 16 * a];
#pragma unroll
      for (int c = 0; c < 4; ++c) kc[c] = ks[e][tx + 16 * c];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[a][c] = fmaf(qa[a], kc[c], s[a][c]);
    }
    __syncthreads();
  }
}

__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
rowstats_kernel(const T* __restrict__ q, const T* __restrict__ k,
                float* __restrict__ m_out, float* __restrict__ l_out, Geo g,
                float scale) {
  __shared__ float qs[DC][TQ + 1];
  __shared__ float ks[DC][TK + 1];
  const int qt = blockIdx.x, bh = blockIdx.y;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int last = qt;  // causal; TQ == TK, so the diagonal tile is qt
  float m[4], l[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) { m[a] = NEG; l[a] = 0.f; }
  for (int kt = 0; kt <= last; ++kt) {
    float s[4][4];
    score_tile(q, k, g, bh, qt, kt, qs, ks, s);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int qpos = qt * TQ + ty + 16 * a;
      float mx = NEG;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = kt * TK + tx + 16 * c;
        const bool ok = kpos < g.T && qpos >= kpos;
        s[a][c] = ok ? s[a][c] * scale : NEG;
        mx = fmaxf(mx, s[a][c]);
      }
      mx = row_max16(mx);
      const float m_new = fmaxf(m[a], mx);
      float ps = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) ps += expf(s[a][c] - m_new);
      ps = row_sum16(ps);
      l[a] = l[a] * expf(m[a] - m_new) + ps;
      m[a] = m_new;
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int qpos = qt * TQ + ty + 16 * a;
      if (qpos < g.T) {
        m_out[(size_t)bh * g.T + qpos] = m[a];
        l_out[(size_t)bh * g.T + qpos] = l[a];
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
colsum_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const float* __restrict__ m_in, const float* __restrict__ l_in,
              float* __restrict__ col, Geo g, float scale, int splits) {
  __shared__ float qs[DC][TQ + 1];
  __shared__ float ks[DC][TK + 1];
  __shared__ float red[16][TK];
  const int kt = blockIdx.x, bh = blockIdx.y, z = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int n_qt = (g.T + TQ - 1) / TQ;
  const int first = kt;  // causal: only query tiles at or below the diagonal
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int qt = first + z; qt < n_qt; qt += splits) {
    float s[4][4];
    score_tile(q, k, g, bh, qt, kt, qs, ks, s);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int qpos = qt * TQ + ty + 16 * a;
      if (qpos >= g.T) continue;
      const float mi = m_in[(size_t)bh * g.T + qpos];
      const float li = fmaxf(l_in[(size_t)bh * g.T + qpos], 1e-30f);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = kt * TK + tx + 16 * c;
        const bool ok = kpos < g.T && qpos >= kpos;
        if (ok) acc[c] += expf(s[a][c] * scale - mi) / li;
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) red[ty][tx + 16 * c] = acc[c];
  __syncthreads();
  if (tid < TK) {
    float v = 0.f;
#pragma unroll
    for (int r = 0; r < 16; ++r) v += red[r][tid];
    const int kpos = kt * TK + tid;
    if (kpos < g.T) atomicAdd(col + (size_t)bh * g.T + kpos, v);
  }
}

template <typename T>
int launch(const void* q, const void* k, float* m, float* l, float* col,
           const Geo& g, int splits, cudaStream_t s) {
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(g.Dh)));
  const int n_t = (g.T + TQ - 1) / TQ;
  const dim3 grid1(n_t, g.B * g.H);
  rowstats_kernel<T><<<grid1, THREADS, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), m, l, g, scale);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const dim3 grid2(n_t, g.B * g.H, splits);
  colsum_kernel<T><<<grid2, THREADS, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), m, l, col, g,
      scale, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (B, T, H, Dh), k: (B, T, KV, Dh), both fp32 (bf16 == 0) or bf16,
// contiguous.  m, l: (B*H, T) fp32 scratch; col: (B*H, T) fp32, zeroed by
// the caller and accumulated into.
extern "C" int attn_colsum_launch(const void* q, const void* k, int bf16,
                                  float* m, float* l, float* col, int B,
                                  int T, int H, int KV, int Dh, int splits,
                                  void* stream) {
  const Geo g{B, T, H, KV, Dh, H / KV};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return launch<__nv_bfloat16>(q, k, m, l, col, g, splits, s);
  return launch<float>(q, k, m, l, col, g, splits, s);
}
