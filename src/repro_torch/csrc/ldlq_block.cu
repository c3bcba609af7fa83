// LDLQ's in-block row loop with the E8 rounder, for a stack of N
// independent matrices.
//
// Replaces: no Pallas kernel.  In the reference XLA compiles this loop:
// ldlq_quantize's row_step (src/repro/core/ldlq.py:70-80), a fori_loop
// over a block's rows inside the scan over 128-row blocks, vmapped over a
// stack of weights of one shape by ldlq_quantize_batched
// (src/repro/core/distributed.py:150).  Eager PyTorch would make about 40
// small launches a row (the rounder alone is two D8 roundings, two
// distance sums and a select); this is one launch a block for all N.
//
// What it computes, for each matrix n and each row i = 0 .. block-1 in
// order (w the block's rows, U the block's diagonal tile of the upper
// Cholesky factor of H^-1, s_i the row's scale):
//   x   = w_i - sum_{k < i} U_ki err_k      (subtracted in the order of k)
//   p   = E8 point nearest x / s_i, octet by octet (8 adjacent columns)
//   deq = p s_i;  err_i = (x - deq) / U_ii
// The E8 point: a = D8(y), b = D8(y - 1/2) + 1/2, a if |y - a|^2 <=
// |y - b|^2 else b; D8(y): f = rint(y) (half to even), parity = floor-mod
// of f's sum by 2, and where the parity is odd the coordinate of the
// largest |y - f| (the first on ties) moves one step towards y (+1 at
// y - f >= 0).
//
// Bitwise equal to the plain version (kernels/ldlq_block/ref.py) on the
// card: every operation rounds as the one PyTorch performs there
// (__fmul_rn / __fsub_rn / __fadd_rn, so nvcc contracts nothing into an
// FMA; __fdiv_rn for y = x / s and for the error's / U_ii), rintf rounds
// half to even as torch.round does, both 8-term squared distances and the
// parity's sum are added left to right as the plain version spells them,
// and each row takes its earlier rows' updates in the order of k.  The
// plain version updates later rows as each error is known (right-
// looking); here a row gathers them when its turn comes (left-looking):
// the same products, subtracted in the same order.
//
// Design: the recursion couples the 8 columns of an octet through the
// rounder and nothing else.
//   * One lane a column: lane l of a warp owns column 32 w + l of its
//     block's columns, and the 8 lanes of an octet gather their 8 values of
//     y with 8 shuffles, so that each of them runs the whole rounder on
//     the octet (the same operations, in the same order, in all 8 lanes)
//     and keeps its own coordinate.  The sums keep the plain version's
//     left-to-right order, which xor-shuffle trees would not.
//   * A lane keeps its column's errors err_k in shared memory (its own row
//     of a THREADS x PITCH table), and U's tile is staged once a block,
//     transposed (row i of the staged tile is U's column i), so the k loop
//     of row i reads 4 of U_ki (one broadcast) and 4 of err_k with two
//     16-byte loads (a first version with one 4-byte load of each a term,
//     and the parity through fmodf, cost ~3300 cycles a row, this one
//     ~2400: chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W).
//     Nothing in the row loop waits for another warp.
//   * A row's dependent chain: its last update (it needs err_{i-1}), the
//     division by s_i, the gather, the rounder (two D8 roundings, each
//     with its parity, argmax and flip, then two 8-term distances), the
//     division by U_ii.  Each warp runs one chain; the SM's other warps
//     fill its stalls.
//   * WARPS warps (32 WARPS columns) a block, N x ceil(d_out / (32 WARPS))
//     blocks: 4 (one block of 135 KB of shared memory an SM), or 8 (203
//     KB: 8 warps an SM) where 4 warps an SM could not hold every column
//     at once, so that the grid is one wave (at N 2 x 14336 it took two
//     at 4).  Any block of 1-128 rows, any d_out that is a multiple of 8
//     (a lane past d_out computes on zeros, which only its own octet's
//     lanes read, and stores nothing).
#include "hopper.cuh"

namespace {

constexpr int ROWS = 128;        // the largest block
constexpr int PITCH = ROWS + 4;  // a staged row's floats (16-byte aligned)
constexpr int ROOMY = 4;         // warps a block while all columns fit
constexpr unsigned FULL = 0xffffffffu;

// U's transposed tile, then one row of errors a thread
constexpr size_t smem_bytes(int warps) {
  return sizeof(float) * static_cast<size_t>(ROWS + 32 * warps) * PITCH;
}

struct Args {
  const float* w;  // the block's rows of N matrices (row stride d_out)
  long long w_sn;
  const float* u;  // the block's diagonal U tiles (row stride u_sr)
  long long u_sn, u_sr;
  const float* s;  // each row's scale (N, block), matrix stride s_sn
  long long s_sn;
  int block, d_out;
  float* deq;  // (N, block, d_out), contiguous
  float* err;
};

// v[0] + v[1] + ... + v[7], left to right
__device__ __forceinline__ float sum8(const float (&v)[8]) {
  float t = v[0];
#pragma unroll
  for (int j = 1; j < 8; ++j) t = __fadd_rn(t, v[j]);
  return t;
}

// (y - p)^2 summed left to right
__device__ __forceinline__ float dist8(const float (&y)[8],
                                       const float (&p)[8]) {
  float d[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float e = __fsub_rn(y[j], p[j]);
    d[j] = __fmul_rn(e, e);
  }
  return sum8(d);
}

// the nearest point of D8, as ref._nearest_d8: f + onehot(idx) sgn parity
__device__ __forceinline__ void nearest_d8(const float (&y)[8],
                                           float (&out)[8]) {
  float f[8], delta[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    f[j] = rintf(y[j]);
    delta[j] = __fsub_rn(y[j], f[j]);
  }
  // torch.remainder(t, 2) of the integer t (exact): t - 2 floor(t / 2),
  // a zero carrying t's sign as fmod's does
  const float t = sum8(f);
  float parity = __fsub_rn(t, __fmul_rn(2.f, floorf(__fmul_rn(t, .5f))));
  if (parity == 0.f) parity = copysignf(0.f, t);
  int idx = 0;
  float best = fabsf(delta[0]), dsel = delta[0];
#pragma unroll
  for (int j = 1; j < 8; ++j) {
    const float a = fabsf(delta[j]);
    if (a > best) {  // strict: the first index on ties
      best = a;
      idx = j;
      dsel = delta[j];
    }
  }
  const float sgn = dsel >= 0.f ? 1.f : -1.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float flip = __fmul_rn(j == idx ? 1.f : 0.f, sgn);
    out[j] = __fadd_rn(f[j], __fmul_rn(flip, parity));
  }
}

// the nearest point of E8 = D8 u (D8 + 1/2), as ref.e8_nearest
__device__ __forceinline__ void e8_nearest(const float (&y)[8],
                                           float (&p)[8]) {
  float a[8], ym[8], b[8];
  nearest_d8(y, a);
#pragma unroll
  for (int j = 0; j < 8; ++j) ym[j] = __fsub_rn(y[j], .5f);
  nearest_d8(ym, b);
#pragma unroll
  for (int j = 0; j < 8; ++j) b[j] = __fadd_rn(b[j], .5f);
  const bool keep_a = dist8(y, a) <= dist8(y, b);
#pragma unroll
  for (int j = 0; j < 8; ++j) p[j] = keep_a ? a[j] : b[j];
}

template <int WARPS>
__global__ void __launch_bounds__(32 * WARPS)
ldlq_block_kernel(const Args a) {
  constexpr int THREADS = 32 * WARPS;
  extern __shared__ float4 smem[];
  float* ut = reinterpret_cast<float*>(smem);  // ut[i * PITCH + k] = U_ki
  float* es = ut + ROWS * PITCH;               // es[t * PITCH + k] = err_k
  const int n = blockIdx.y;
  const int t = threadIdx.x;
  const int lane = t % 32;
  const int c = blockIdx.x * THREADS + t;
  const bool live = c < a.d_out;
  const float* un = a.u + n * a.u_sn;
  for (int idx = t; idx < a.block * a.block; idx += THREADS) {
    const int k = idx / a.block, i = idx % a.block;  // U_ki, read along i
    ut[i * PITCH + k] = un[k * a.u_sr + i];
  }
  __syncthreads();
  const float* wn = a.w + n * a.w_sn + c;
  const float* sn = a.s + n * a.s_sn;
  const long long o = static_cast<long long>(n) * a.block * a.d_out + c;
  const int base = lane & ~7, mine = lane & 7;
  float x_next = live ? wn[0] : 0.f;
  for (int i = 0; i < a.block; ++i) {
    float x = x_next;
    if (i + 1 < a.block) {
      x_next = live ? wn[static_cast<long long>(i + 1) * a.d_out] : 0.f;
    }
    const float* ur = ut + i * PITCH;
    const float* er = es + t * PITCH;
    int k = 0;
    for (; k + 4 <= i; k += 4) {
      const float4 u4 = *reinterpret_cast<const float4*>(ur + k);
      const float4 e4 = *reinterpret_cast<const float4*>(er + k);
      x = __fsub_rn(x, __fmul_rn(u4.x, e4.x));
      x = __fsub_rn(x, __fmul_rn(u4.y, e4.y));
      x = __fsub_rn(x, __fmul_rn(u4.z, e4.z));
      x = __fsub_rn(x, __fmul_rn(u4.w, e4.w));
    }
    for (; k < i; ++k) x = __fsub_rn(x, __fmul_rn(ur[k], er[k]));
    const float si = sn[i];
    const float y = __fdiv_rn(x, si);
    float yo[8], p[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) yo[j] = __shfl_sync(FULL, y, base + j);
    e8_nearest(yo, p);
    float pm = p[0];
#pragma unroll
    for (int j = 1; j < 8; ++j) pm = mine == j ? p[j] : pm;
    const float d = __fmul_rn(pm, si);
    const float e = __fdiv_rn(__fsub_rn(x, d), ur[i]);
    es[t * PITCH + i] = e;
    if (live) {
      const long long oi = o + static_cast<long long>(i) * a.d_out;
      a.deq[oi] = d;
      a.err[oi] = e;
    }
  }
}

}  // namespace

// w: the block's rows of N matrices, row stride d_out, matrix stride w_sn;
// u: the block's diagonal U tiles, row stride u_sr, matrix stride u_sn;
// s: each row's scale, matrix stride s_sn.  deq and err are contiguous
// (N, block, d_out).  d_out must be a multiple of 8 and block 1-128.
extern "C" int ldlq_block_launch(const float* w, long long w_sn,
                                 const float* u, long long u_sn,
                                 long long u_sr, const float* s,
                                 long long s_sn, int n, int block, int d_out,
                                 float* deq, float* err, void* stream) {
  if (block <= 0 || block > ROWS || d_out % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0 || d_out <= 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t ce = cudaGetDevice(&dev);
  if (ce == cudaSuccess) {
    ce = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (ce != cudaSuccess) return static_cast<int>(ce);
  // 8 warps a block (one block an SM) once the columns' warps outnumber
  // what ROOMY warps a block, one block an SM, hold in one wave
  const long long warps = static_cast<long long>(n) * ((d_out + 31) / 32);
  const bool wide = warps > static_cast<long long>(ROOMY) * sms;
  const int threads = 32 * (wide ? 2 * ROOMY : ROOMY);
  const void* fn = wide
      ? reinterpret_cast<const void*>(ldlq_block_kernel<2 * ROOMY>)
      : reinterpret_cast<const void*>(ldlq_block_kernel<ROOMY>);
  const size_t smem = smem_bytes(threads / 32);
  const int e = allow_smem(fn, smem);
  if (e != 0) return e;
  const Args a{w, w_sn, u, u_sn, u_sr, s, s_sn, block, d_out, deq, err};
  const dim3 grid((d_out + threads - 1) / threads, n);
  if (wide) {
    ldlq_block_kernel<2 * ROOMY><<<grid, threads, smem,
                                   static_cast<cudaStream_t>(stream)>>>(a);
  } else {
    ldlq_block_kernel<ROOMY><<<grid, threads, smem,
                               static_cast<cudaStream_t>(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
