// Packed weight-only quantized matmul: y = x @ (scale · (codes - zero)).
//
// Replaces: quant_matmul_pallas / _qmm_kernel / _dequant_tile in
// src/repro/kernels/quant_matmul/kernel.py.
//
// Layout (identical to the reference artifact): codes are packed
// 32/bits per uint32 word along d_in (word wi holds rows wi*vpw .. +vpw-1,
// code c in bits [c*bits, (c+1)*bits)), words are (ceil(k/vpw), n)
// row-major; 3-bit packs 10 codes per word and zero-pads the last word.
// scale and zero are fp32 (k/gs, n).  x is (m, k) fp32 or bf16; y is (m, n)
// in x's type, accumulated in fp32.
//
// What bounds it on the H100:
//   decode (m <= 4): bytes.  Every packed word is read once for a handful
//     of multiply-adds; at 3 bits the (14336, 4096) down projection is
//     ~23.5 MB of codes plus ~3.7 MB of scales and zeros, ~8 us at 3.35 TB/s.
//   prefill (m = B·T in the hundreds): operations, 2·m·n·k multiply-adds.
//     This first version runs them on the fp32 pipes, not the tensor cores.
//
// Design.  Codes are unpacked in registers with shift and mask and the
// per-group affine is applied before the multiply; the product is computed
// here, never handed to a library GEMM.
//   decode: one thread per output column, 128 columns per block, and the
//     packed words split along k into `splits` ranges (grid.y, about four
//     blocks per SM) so that even n = 1024 fills the card.  The block stages
//     its slice of x in shared memory as one float4 per k row (one broadcast
//     load feeds all four rows of x: scalar loads of x, not bytes, limited
//     the first version); each thread streams its column's words eight loads at a
//     time, tracks the current quant group incrementally (3-bit words
//     straddle group boundaries) and keeps four fp32 sums.  Larger m takes
//     the prefill shape.  Partial sums go to
//     a (splits, m, n) fp32 buffer and a second small kernel adds them in a
//     fixed order and casts to x's type (deterministic, no atomics).
//   prefill: 64 x 64 output tiles, 256 threads with 4 x 4 each.  Per k-step
//     the block unpacks BKW words per column (BK = BKW·vpw rows: 32 rows at
//     2/4/8 bits, 40 at 3 bits) into a dequantized fp32 tile in shared
//     memory next to the matching x tile, then accumulates.
// Ragged m, n and k (including the padded 3-bit word) are masked.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int DEC_COLS = 128;   // decode: threads (= columns) per block
constexpr int DEC_MAXM = 4;     // decode: largest m (one float4 of x)
constexpr int DEC_ROWS = 1024;  // decode: most k rows staged per block
constexpr int DEC_UNROLL = 8;   // decode: word loads in flight per thread
constexpr int TM = 64, TN = 64, THREADS = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <int BITS> struct Pack {
  static constexpr int VPW = 32 / BITS;
  static constexpr uint32_t MASK = (1u << BITS) - 1u;
  // words per prefill k-step: BK = 32 rows (40 at 3 bits)
  static constexpr int BKW = (BITS == 3) ? 4 : 32 / VPW;
  static constexpr int BK = BKW * VPW;
};

// One float4 holds the (up to 4) rows of x at one k; rows of x beyond m
// are staged as zeros so the inner loop needs no predicate.
template <typename T, int BITS>
__global__ void __launch_bounds__(DEC_COLS)
qmm_decode(const T* __restrict__ x, const uint32_t* __restrict__ w,
           const float* __restrict__ scale, const float* __restrict__ zero,
           float* __restrict__ partial, int m, int k, int n, int gs,
           int words_per_split) {
  using P = Pack<BITS>;
  constexpr int MP = DEC_MAXM;  // padded m
  __shared__ float4 xs[DEC_ROWS];
  const int n_words = (k + P::VPW - 1) / P::VPW;
  const int split = blockIdx.y;
  const int w0 = split * words_per_split;
  const int w1 = min(n_words, w0 + words_per_split);
  const int r0 = w0 * P::VPW;
  const int r1 = min(k, w1 * P::VPW);
  const int rows = r1 - r0;
  float* xsf = reinterpret_cast<float*>(xs);
  for (int idx = threadIdx.x; idx < MP * rows; idx += DEC_COLS) {
    const int mi = idx / rows, rr = idx % rows;  // rr fastest: coalesced
    xsf[rr * MP + mi] = (mi < m) ? to_f(x[(size_t)mi * k + r0 + rr]) : 0.f;
  }
  __syncthreads();
  const int col = blockIdx.x * DEC_COLS + threadIdx.x;
  if (col >= n) return;

  float acc[MP];
#pragma unroll
  for (int i = 0; i < MP; ++i) acc[i] = 0.f;
  int g = r0 / gs;
  int g_end = (g + 1) * gs;
  float sc = scale[(size_t)g * n + col];
  float zc = zero[(size_t)g * n + col];
  for (int wb = w0; wb < w1; wb += DEC_UNROLL) {
    // start DEC_UNROLL independent word loads before using any of them
    uint32_t words[DEC_UNROLL];
#pragma unroll
    for (int u = 0; u < DEC_UNROLL; ++u)
      words[u] = (wb + u < w1) ? w[(size_t)(wb + u) * n + col] : 0u;
#pragma unroll
    for (int u = 0; u < DEC_UNROLL; ++u) {
#pragma unroll
      for (int c = 0; c < P::VPW; ++c) {
        const int row = (wb + u) * P::VPW + c;
        if (row < r1) {
          if (row >= g_end) {  // uniform across the block: rows are shared
            g = row / gs;
            g_end = (g + 1) * gs;
            sc = scale[(size_t)g * n + col];
            zc = zero[(size_t)g * n + col];
          }
          const float wv =
              (static_cast<float>((words[u] >> (c * BITS)) & P::MASK) - zc)
              * sc;
          const float4 a = xs[row - r0];  // one broadcast load
          acc[0] = fmaf(a.x, wv, acc[0]);
          acc[1] = fmaf(a.y, wv, acc[1]);
          acc[2] = fmaf(a.z, wv, acc[2]);
          acc[3] = fmaf(a.w, wv, acc[3]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < MP; ++i)
    if (i < m) partial[((size_t)split * m + i) * n + col] = acc[i];
}

template <typename T>
__global__ void qmm_reduce(const float* __restrict__ partial,
                           T* __restrict__ out, int mn, int splits) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= mn) return;
  float v = 0.f;
  for (int s = 0; s < splits; ++s) v += partial[(size_t)s * mn + idx];
  store(out + idx, v);
}

template <typename T, int BITS>
__global__ void __launch_bounds__(THREADS)
qmm_tile(const T* __restrict__ x, const uint32_t* __restrict__ w,
         const float* __restrict__ scale, const float* __restrict__ zero,
         T* __restrict__ out, int m, int k, int n, int gs) {
  using P = Pack<BITS>;
  __shared__ float xs[P::BK][TM + 1];
  __shared__ float ws[P::BK][TN];
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int n_words = (k + P::VPW - 1) / P::VPW;
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;

  for (int kw0 = 0; kw0 < n_words; kw0 += P::BKW) {
    const int k0 = kw0 * P::VPW;
    for (int idx = tid; idx < TM * P::BK; idx += THREADS) {
      const int mm = idx / P::BK, kk = idx % P::BK;
      const int row = m0 + mm, kc = k0 + kk;
      xs[kk][mm] = (row < m && kc < k) ? to_f(x[(size_t)row * k + kc]) : 0.f;
    }
    for (int idx = tid; idx < P::BKW * TN; idx += THREADS) {
      const int wl = idx / TN, c = idx % TN;
      const int wi = kw0 + wl, col = n0 + c;
      const bool ok = wi < n_words && col < n;
      const uint32_t word = ok ? w[(size_t)wi * n + col] : 0u;
#pragma unroll
      for (int cc = 0; cc < P::VPW; ++cc) {
        const int row = wi * P::VPW + cc;
        float v = 0.f;
        if (ok && row < k) {
          const size_t gi = (size_t)(row / gs) * n + col;
          v = (static_cast<float>((word >> (cc * BITS)) & P::MASK) - zero[gi])
              * scale[gi];
        }
        ws[wl * P::VPW + cc][c] = v;
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < P::BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < n) store(out + (size_t)row * n + col, acc[i][j]);
    }
  }
}

template <typename T, int BITS>
int launch(const void* x, const uint32_t* w, const float* scale,
           const float* zero, void* out, float* partial, int m, int k, int n,
           int gs, int splits, int words_per_split, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (partial != nullptr) {
    const dim3 grid((n + DEC_COLS - 1) / DEC_COLS, splits);
    qmm_decode<T, BITS><<<grid, DEC_COLS, 0, s>>>(
        xt, w, scale, zero, partial, m, k, n, gs, words_per_split);
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
    const int mn = m * n;
    qmm_reduce<T><<<(mn + 255) / 256, 256, 0, s>>>(partial, ot, mn, splits);
  } else {
    const dim3 grid((n + TN - 1) / TN, (m + TM - 1) / TM);
    qmm_tile<T, BITS><<<grid, THREADS, 0, s>>>(xt, w, scale, zero, ot, m, k,
                                              n, gs);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bits(int bits, const void* x, const uint32_t* w, const float* sc,
                const float* zr, void* out, float* partial, int m, int k,
                int n, int gs, int splits, int wps, cudaStream_t s) {
  switch (bits) {
    case 2: return launch<T, 2>(x, w, sc, zr, out, partial, m, k, n, gs, splits, wps, s);
    case 3: return launch<T, 3>(x, w, sc, zr, out, partial, m, k, n, gs, splits, wps, s);
    case 4: return launch<T, 4>(x, w, sc, zr, out, partial, m, k, n, gs, splits, wps, s);
    case 8: return launch<T, 8>(x, w, sc, zr, out, partial, m, k, n, gs, splits, wps, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// partial != null selects the decode shape (m <= 4; partial is
// (splits, m, n) fp32 scratch, words_per_split * vpw <= 1024 rows);
// partial == null selects the tiled prefill shape.
extern "C" int qmm_launch(const void* x, int x_bf16, const void* w,
                          const float* scale, const float* zero, void* out,
                          float* partial, int m, int k, int n, int bits,
                          int gs, int splits, int words_per_split,
                          void* stream) {
  if (partial != nullptr && (m > DEC_MAXM || words_per_split * (32 / bits) > DEC_ROWS))
    return static_cast<int>(cudaErrorInvalidValue);
  const uint32_t* wu = static_cast<const uint32_t*>(w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return launch_bits<__nv_bfloat16>(bits, x, wu, scale, zero, out, partial,
                                      m, k, n, gs, splits, words_per_split, s);
  return launch_bits<float>(bits, x, wu, scale, zero, out, partial, m, k, n,
                            gs, splits, words_per_split, s);
}
