// GPTQ's in-block row loop for a stack of N independent matrices.
//
// Replaces: no Pallas kernel.  In the reference XLA compiles this loop:
// gptq_quantize's row_step (src/repro/core/gptq.py:127), a fori_loop over
// a block's rows inside the scan over 128-row blocks, vmapped over a stack
// of weights of one shape by gptq_quantize_batched
// (src/repro/core/distributed.py:141).  Eager PyTorch would make about a
// dozen small launches per row; this is one launch per block for all N.
//
// What it computes, for each matrix n and output column c, over the block's
// rows i = 0 .. block-1 in order (w the block's rows, U the block's diagonal
// block of the upper Cholesky factor of H^-1):
//   at a group's first row (unless the caller fixed one global group):
//     sym:  scale = max(amax|w[i..i+rows)| * inv, 1e-9), zero = (maxq+1)/2
//     asym: lo = min(min w, 0), hi = max(max w, 0),
//           scale = max((hi - lo) * inv, 1e-9), zero = rint(-lo / scale)
//   q = clamp(rint(w_i / scale) + zero, 0, maxq)
//   deq = scale * (q - zero);  err = (w_i - deq) / U_ii
//   w_j -= U_ij * err  for the block's later rows j > i.
// inv is the fp32 reciprocal of maxq / 2 (sym) or maxq (asym), as the
// reference's compiled solver multiplies by it.
//
// Bitwise equal to the plain version (kernels/gptq_block/ref.py) on the
// card: every operation is the correctly rounded one PyTorch's eager loop
// performs, one at a time (__fmul_rn / __fsub_rn / __fadd_rn / __fdiv_rn,
// so nvcc contracts nothing into an FMA), rint rounds half to even as
// torch.round does, and the group's amax / min / max are exact.
//
// What bounds it on the H100: bytes, in principle (read block·d_out + block²
// fp32, write q, deq and err), a couple of microseconds at llama3-8b's
// widths.  In practice latency: the rows of a column run in series, each
// behind two correctly rounded divisions and its shared-memory updates
// (H100 80GB HBM3, 700 W: 0.23 ms a launch at 576-4096 columns, 92x the
// byte bound at d_out 4096; 40 registers, no spills).
//
// Design: the recursion is independent per column; the only value columns
// share is U's row i.  One thread per column, TILE columns a block, grid
// (column tiles, N).  The block stages U's block x block tile and its
// columns' block x TILE slab of w in shared memory (row-major, a thread's
// column at stride TILE: no bank conflicts; U's row is a broadcast), then
// each thread runs the block's rows in series.  Ragged d_out is masked: a
// thread past the last column helps stage U and stops.
#include "hopper.cuh"

namespace {

constexpr int TILE = 64;        // columns (threads) a block
constexpr int MAX_ROWS = 128;   // the largest block of rows

__global__ void __launch_bounds__(TILE)
gptq_block_kernel(const float* __restrict__ w, long long w_sn,
                  const float* __restrict__ u, long long u_sn,
                  long long u_sr, int block, int d_out, int maxq, int sym,
                  int rows_per_group, float inv,
                  const float* __restrict__ fscale,
                  const float* __restrict__ fzero, int* __restrict__ q,
                  float* __restrict__ deq, float* __restrict__ err,
                  float* __restrict__ scale, float* __restrict__ zero) {
  extern __shared__ float smem[];
  float* us = smem;                  // block x block
  float* ws = smem + block * block;  // block x TILE
  const int n = blockIdx.y;
  const int t = threadIdx.x;
  const int c = blockIdx.x * TILE + t;
  const float* un = u + n * u_sn;
  for (int idx = t; idx < block * block; idx += TILE) {
    us[idx] = un[(idx / block) * u_sr + idx % block];
  }
  const bool live = c < d_out;
  if (live) {
    const float* wn = w + n * w_sn + c;
    for (int r = 0; r < block; ++r) {
      ws[r * TILE + t] = wn[static_cast<long long>(r) * d_out];
    }
  }
  __syncthreads();
  if (!live) return;

  const float min_scale = static_cast<float>(1e-9);  // torch's clamp_min
  const float fmaxq = static_cast<float>(maxq);
  const long long o = static_cast<long long>(n) * block * d_out + c;
  float s = 0.f, z = 0.f;
  if (fscale != nullptr) {
    s = fscale[static_cast<long long>(n) * d_out + c];
    z = fzero[static_cast<long long>(n) * d_out + c];
  }
  const int groups = block / rows_per_group;
  for (int i = 0; i < block; ++i) {
    if (fscale == nullptr && i % rows_per_group == 0) {
      if (sym) {
        float amax = 0.f;
        for (int r = i; r < i + rows_per_group; ++r) {
          amax = fmaxf(amax, fabsf(ws[r * TILE + t]));
        }
        s = fmaxf(__fmul_rn(amax, inv), min_scale);
        z = static_cast<float>((maxq + 1) / 2);
      } else {
        float lo = ws[i * TILE + t], hi = lo;
        for (int r = i + 1; r < i + rows_per_group; ++r) {
          lo = fminf(lo, ws[r * TILE + t]);
          hi = fmaxf(hi, ws[r * TILE + t]);
        }
        lo = fminf(lo, 0.f);
        hi = fmaxf(hi, 0.f);
        s = fmaxf(__fmul_rn(__fsub_rn(hi, lo), inv), min_scale);
        z = rintf(__fdiv_rn(-lo, s));
      }
      const long long g =
          (static_cast<long long>(n) * groups + i / rows_per_group) * d_out +
          c;
      scale[g] = s;
      zero[g] = z;
    }
    const float x = ws[i * TILE + t];
    const float qf =
        fminf(fmaxf(__fadd_rn(rintf(__fdiv_rn(x, s)), z), 0.f), fmaxq);
    const float d = __fmul_rn(s, __fsub_rn(qf, z));
    const float e = __fdiv_rn(__fsub_rn(x, d), us[i * block + i]);
    const float* ui = us + i * block;
#pragma unroll 4
    for (int j = i + 1; j < block; ++j) {
      ws[j * TILE + t] = __fsub_rn(ws[j * TILE + t], __fmul_rn(ui[j], e));
    }
    const long long oi = o + static_cast<long long>(i) * d_out;
    q[oi] = static_cast<int>(qf);
    deq[oi] = d;
    err[oi] = e;
  }
}

}  // namespace

// w: the block's rows of N matrices, row stride d_out, matrix stride w_sn;
// u: the block's diagonal U tiles, row stride u_sr, matrix stride u_sn.
// Outputs are contiguous: q, deq, err (N, block, d_out); scale and zero
// (N, block / rows_per_group, d_out), unless fscale / fzero (N, d_out) fix
// one global group, in which case they are not written.
extern "C" int gptq_block_launch(const float* w, long long w_sn,
                                 const float* u, long long u_sn,
                                 long long u_sr, int n, int block, int d_out,
                                 int bits, int sym, int rows_per_group,
                                 float inv, const float* fscale,
                                 const float* fzero, int* q, float* deq,
                                 float* err, float* scale, float* zero,
                                 void* stream) {
  if (block <= 0 || block > MAX_ROWS || rows_per_group <= 0 ||
      block % rows_per_group != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0 || d_out <= 0) return 0;
  const size_t smem = sizeof(float) * (block * block + block * TILE);
  const int e = allow_smem(reinterpret_cast<const void*>(gptq_block_kernel),
                           smem);
  if (e != 0) return e;
  dim3 grid((d_out + TILE - 1) / TILE, n);
  gptq_block_kernel<<<grid, TILE, smem, static_cast<cudaStream_t>(stream)>>>(
      w, w_sn, u, u_sn, u_sr, block, d_out, (1 << bits) - 1, sym,
      rows_per_group, inv, fscale, fzero, q, deq, err, scale, zero);
  return static_cast<int>(cudaGetLastError());
}
