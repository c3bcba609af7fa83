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
// card: every operation rounds as the one PyTorch's eager loop performs
// (__fmul_rn / __fsub_rn / __fadd_rn, so nvcc contracts nothing into an
// FMA; __fdiv_rn, IEEE division, subnormal quotients included), rint
// rounds half to even as torch.round does, each w_j takes its updates in
// the order of i, and the group's amax / min / max are exact in any order.
//
// What bounds it on the H100: not bytes (a block's rows and U tile read
// once, q, deq and err written once: 0.0025 ms at d_out 4096) but the
// rows' dependent chain: row i+1 can start only once row i's error has
// updated it, and each row puts two divisions, a rint and a shuffle on
// that chain.  On an NVIDIA H100 80GB HBM3 (700 W) the kernel takes
// 0.045-0.053 ms at 576-8192 columns and 0.062 at 32768 (one lane a
// column); a row costs 660-830 cycles, 1150 at one lane a column (the
// slope from 64 rows to 128, measured by chip_smoke.py).  Each __fdiv_rn
// puts a check and a branch around its slow path on the chain, about 230
// cycles a division: the same kernel with a branch-free product by the
// fp64 reciprocal took 0.021 ms at d_out 4096, but that rounds some
// subnormal quotients the other way (ref.subnormal_tie_inputs builds
// them).
//
// Design: the recursion is independent per column; the only value columns
// share is U's row i.
//   * A column's rows live in registers.  R = 1, 2, 4 or 8 lanes of a warp
//     share a column, lane r owning its rows in chunks of 4 (rows 4 (q R
//     + r) + t).  The rows run in rounds of 4 R rows, unrolled, each lane
//     quantizing its own row in turn and broadcasting its error with a
//     shuffle; every lane updates all its slots, row i + 1's first.  After
//     a round the slots move down one chunk (fused into the round's last
//     update), so every register index is a constant, and the number of
//     slots a round updates halves as rows run out (down to 16 rows of
//     capacity, or one chunk a lane: 1.33x the triangle's updates).  A row
//     loop unrolled whole (an instance per padded row count) took nvcc 11
//     minutes.
//   * No branch inside a round but the divisions' own: each branch ends
//     the region ptxas can schedule, so one row's chain could not overlap
//     the other rows' updates.  Rows past the block run on zeros (U_ii
//     read as 1 from a table built once a block) and store nothing; q, deq
//     and err of a lane's rows are kept to the round's end and stored
//     then; a group starts at a round's first row, or at any row in the
//     EVERY_ROW instance (R = 1, for group sizes that are not a multiple
//     of 4).
//   * U's tile is staged once a block with 16-byte cp.async copies, zero-
//     filled past the block (4-byte copies where its rows are not 16-byte
//     aligned), row-major: a lane's chunk of U's row i is one conflict-free
//     16-byte shared load.  128 threads a block; R is picked from N x d_out
//     so that the grid holds at most eight warps an SM (R 8 at 4224 columns
//     or fewer, R 4 at 8448, R 2 at 16896).  Any block of 1-128 rows, any
//     group size.
#include "hopper.cuh"

namespace {

constexpr int ROWS = 128;         // the largest block: U's tile is ROWS x ROWS
constexpr int CHUNK = 4;          // a lane owns its rows 4 at a time
constexpr int THREADS = 128;      // a block
constexpr int WARPS_PER_SM = 8;   // what the choice of R aims at
constexpr unsigned FULL = 0xffffffffu;
// U's tile row-major, then one zero row (a lane's last 16-byte loads of a
// row may run past its ROWS entries, into the next row or the zero row,
// only ever for rows it no longer needs), then U_ii (1 past the block)
constexpr size_t TILE_BYTES = sizeof(float) * (ROWS + 1) * ROWS;
constexpr size_t SMEM = TILE_BYTES + sizeof(float) * ROWS;

struct Args {
  const float* w;  // the block's rows of N matrices (row stride d_out)
  long long w_sn;
  const float* u;  // the block's diagonal U tiles (row stride u_sr)
  long long u_sn, u_sr;
  int block, d_out, maxq, sym, rows_per_group;
  float inv;
  const float* fscale;  // (N, d_out) of one fixed global group, or null
  const float* fzero;
  int* q;
  float* deq;
  float* err;
  float* scale;
  float* zero;
};

// 16 (or 4) bytes from global to shared memory; bytes past `keep` are
// zero-filled and not read
__device__ __forceinline__ void stage16(uint32_t dst, const void* src,
                                        int keep) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(keep));
}
__device__ __forceinline__ void stage4(uint32_t dst, const void* src,
                                       int keep) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(keep));
}
__device__ __forceinline__ void staged() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// the R lanes of a column reduce over their rows (exact in any order)
template <int R>
__device__ __forceinline__ float lanes_max(float v) {
#pragma unroll
  for (int m = R / 2; m > 0; m /= 2) v = fmaxf(v, __shfl_xor_sync(FULL, v, m));
  return v;
}
template <int R>
__device__ __forceinline__ float lanes_min(float v) {
#pragma unroll
  for (int m = R / 2; m > 0; m /= 2) v = fminf(v, __shfl_xor_sync(FULL, v, m));
  return v;
}

// One lane's share of one column, R lanes a column.  The rows run in
// rounds of CHUNK R rows, chunk p of a round owned by lane p.  Lane r's
// slot CHUNK q + t holds row b + CHUNK (q R + r) + t of the round that
// starts at row b; after each round the slots move down one chunk, so
// every index into wr is a constant.  A round updates its first S slots;
// S halves as the rows run out (a phase each), as the rows left always
// fit in S R.  Rows past the block run too, on zeros (their U_ii is 1),
// and store nothing.  A group may start at any row when EVERY_ROW,
// else only at a round's first row.
template <int R, bool EVERY_ROW>
struct Column {
  static constexpr int K = ROWS / R;  // slots a lane
  static constexpr int ROUND = CHUNK * R;
  static constexpr int SMIN = K / 8 > CHUNK ? K / 8 : CHUNK;  // last phase

  const Args& a;
  const float* us;    // U's tile, row-major, row stride ROWS
  const float* ud;    // U_ii
  long long o;        // q / deq / err offset of this column's row 0
  int n, r, c;
  bool live;          // c < d_out (else: compute on zeros, store nothing)
  int next;           // the row where the next group starts
  float s, z;         // the current group's scale and zero
  float wr[K];

  // group parameters from the rows [i, i + rows_per_group) of the column
  template <int S>
  __device__ __forceinline__ void group(int b, int off, int i) {
    const int end = i + a.rows_per_group;
    next = end;
    // amax |w|, min(min w, 0), max(max w, 0): a slot outside the group
    // counts as 0, which moves none of them
    float amax = 0.f, lo = 0.f, hi = 0.f;
#pragma unroll
    for (int q = 0; q < S / CHUNK; ++q) {
#pragma unroll
      for (int t = 0; t < CHUNK; ++t) {
        if (CHUNK * (q * R + R - 1) + t < off) continue;  // no lane's row >= i
        const int j = b + CHUNK * (q * R + r) + t;
        const float v = (j >= i && j < end) ? wr[CHUNK * q + t] : 0.f;
        amax = fmaxf(amax, fabsf(v));
        lo = fminf(lo, v);
        hi = fmaxf(hi, v);
      }
    }
    if (a.sym) {
      amax = lanes_max<R>(amax);
      s = fmaxf(__fmul_rn(amax, a.inv), static_cast<float>(1e-9));
      z = static_cast<float>((a.maxq + 1) / 2);
    } else {
      lo = lanes_min<R>(lo);
      hi = lanes_max<R>(hi);
      s = fmaxf(__fmul_rn(__fsub_rn(hi, lo), a.inv),
                static_cast<float>(1e-9));
      z = rintf(__fdiv_rn(-lo, s));
    }
    if (r == 0 && live) {
      const long long g = (static_cast<long long>(n) *
                               (a.block / a.rows_per_group) +
                           i / a.rows_per_group) *
                              a.d_out +
                          c;
      a.scale[g] = s;
      a.zero[g] = z;
    }
  }

  // rows b .. b + ROUND - 1
  template <int S>
  __device__ __forceinline__ void round(int b) {
    // this lane's rows of the round, b + CHUNK r + t: stored at its end
    float mq[CHUNK] = {}, md[CHUNK] = {}, me[CHUNK] = {};
#pragma unroll
    for (int p = 0; p < R; ++p) {
#pragma unroll
      for (int t = 0; t < CHUNK; ++t) {
        const int off = CHUNK * p + t;
        const int i = b + off;
        if ((EVERY_ROW || off == 0) && a.fscale == nullptr && i == next &&
            i < a.block) {
          group<S>(b, off, i);
        }
        // every lane quantizes its slot t; only lane p's is row i
        const float uii = ud[i];
        const float x = wr[t];
        const float qf =
            fminf(fmaxf(__fadd_rn(rintf(__fdiv_rn(x, s)), z), 0.f),
                  static_cast<float>(a.maxq));
        const float d = __fmul_rn(s, __fsub_rn(qf, z));
        float e = __fdiv_rn(__fsub_rn(x, d), uii);
        if constexpr (R > 1) e = __shfl_sync(FULL, e, p, R);
        mq[t] = r == p ? qf : mq[t];
        md[t] = r == p ? d : md[t];
        me[t] = r == p ? e : me[t];
        // every slot takes row i's update, row i + 1's first; the slots of
        // rows <= i are done and never read again.  The round's last row
        // also moves the slots down a chunk (its first chunk is done).
        const bool last = off == ROUND - 1;
        const float* ur = us + i * ROWS + b + CHUNK * r;
#pragma unroll
        for (int q = 0; q < S / CHUNK; ++q) {
          if (last && q == 0) continue;
          const float4 v = *reinterpret_cast<const float4*>(ur + ROUND * q);
          const float uv[CHUNK] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int u = 0; u < CHUNK; ++u) {
            const int sl = CHUNK * q + u;
            const float w_new = __fsub_rn(wr[sl], __fmul_rn(uv[u], e));
            if (last) {
              wr[sl - CHUNK] = w_new;
            } else {
              wr[sl] = w_new;
            }
          }
        }
      }
    }
    if (live) {
#pragma unroll
      for (int t = 0; t < CHUNK; ++t) {
        const int i = b + CHUNK * r + t;
        if (i < a.block) {
          const long long oi = o + static_cast<long long>(i) * a.d_out;
          a.q[oi] = static_cast<int>(mq[t]);
          a.deq[oi] = md[t];
          a.err[oi] = me[t];
        }
      }
    }
  }

  // rounds with S slots while the rows left need more than S / 2 (the
  // smallest phase runs to the end), then the next phase
  template <int S>
  __device__ __forceinline__ void phases(int& b) {
    while (b < a.block && (S == SMIN || a.block - b > S * R / 2)) {
      round<S>(b);
      b += ROUND;
    }
    if constexpr (S > SMIN) phases<S / 2>(b);
  }

  __device__ __forceinline__ void run() {
    int b = 0;
    phases<K>(b);
  }
};

template <int R, bool EVERY_ROW>
__global__ void __launch_bounds__(THREADS)
gptq_block_kernel(const Args a) {
  using C = Column<R, EVERY_ROW>;
  extern __shared__ float4 smem[];
  float* us = reinterpret_cast<float*>(smem);
  float* ud = us + TILE_BYTES / sizeof(float);
  const int n = blockIdx.y;
  const int r = threadIdx.x % R;
  const int c = blockIdx.x * (blockDim.x / R) + threadIdx.x / R;
  C col{a, us, ud, static_cast<long long>(n) * a.block * a.d_out + c,
        n, r,  c,  c < a.d_out, 0, 1.f, 0.f, {}};
  // U's tile, zero past the block: 16-byte copies where its rows are
  // 16-byte aligned, else 4-byte ones
  const float* un = a.u + n * a.u_sn;
  const uint32_t base = smem_u32(us);
  if (((reinterpret_cast<uintptr_t>(un) | (a.u_sr * sizeof(float))) & 15) ==
      0) {
    for (int idx = threadIdx.x; idx < (ROWS + 1) * ROWS / 4;
         idx += blockDim.x) {
      const int i = idx / (ROWS / 4), j = idx % (ROWS / 4) * 4;
      const int keep = i < a.block ? max(0, min(4, a.block - j)) : 0;
      stage16(base + idx * 16, keep ? un + i * a.u_sr + j : un, keep * 4);
    }
  } else {
    for (int idx = threadIdx.x; idx < (ROWS + 1) * ROWS; idx += blockDim.x) {
      const int i = idx / ROWS, j = idx % ROWS;
      const bool keep = i < a.block && j < a.block;
      stage4(base + idx * 4, keep ? un + i * a.u_sr + j : un, keep ? 4 : 0);
    }
  }
  // this lane's rows of its column while the copies are in flight
  const float* wn = a.w + n * a.w_sn + c;
#pragma unroll
  for (int q = 0; q < C::K / CHUNK; ++q) {
#pragma unroll
    for (int t = 0; t < CHUNK; ++t) {
      const int row = CHUNK * (q * R + r) + t;
      col.wr[CHUNK * q + t] = (col.live && row < a.block)
                                  ? wn[static_cast<long long>(row) * a.d_out]
                                  : 0.f;
    }
  }
  if (a.fscale != nullptr && col.live) {
    col.s = a.fscale[static_cast<long long>(n) * a.d_out + c];
    col.z = a.fzero[static_cast<long long>(n) * a.d_out + c];
  }
  staged();
  __syncthreads();
  for (int i = threadIdx.x; i < ROWS; i += blockDim.x) {
    ud[i] = i < a.block ? us[i * ROWS + i] : 1.f;
  }
  __syncthreads();
  col.run();
}

using KernelFn = void (*)(Args);

struct Plan {
  int lanes, threads, grid_x, every_row;
};

// R: the most lanes a column (up to 8) that keep N x d_out x R within
// WARPS_PER_SM warps an SM of the current device, and whose rounds (4 R
// rows) groups start on; a group size that is not a multiple of 4 takes
// R = 1 with a group check at every row.  Returns a CUDA error, or 0.
int make_plan(int n, int block, int d_out, int rows_per_group, bool fixed,
              Plan* out) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long cols = static_cast<long long>(n) * d_out;
  const long long target = static_cast<long long>(WARPS_PER_SM) * 32 * sms;
  const auto on_rounds = [&](int lanes) {
    return fixed || rows_per_group >= block ||
           rows_per_group % (CHUNK * lanes) == 0;
  };
  Plan p{1, THREADS, 0, 0};
  for (int lanes = 8; lanes > 1; lanes /= 2) {
    if (cols * lanes <= target && on_rounds(lanes)) {
      p.lanes = lanes;
      break;
    }
  }
  p.every_row = !on_rounds(p.lanes);
  p.grid_x = (d_out + THREADS / p.lanes - 1) / (THREADS / p.lanes);
  *out = p;
  return 0;
}

KernelFn pick(const Plan& p) {
  if (p.every_row) return gptq_block_kernel<1, true>;
  switch (p.lanes) {
    case 8:
      return gptq_block_kernel<8, false>;
    case 4:
      return gptq_block_kernel<4, false>;
    case 2:
      return gptq_block_kernel<2, false>;
    default:
      return gptq_block_kernel<1, false>;
  }
}

bool valid(int block, int rows_per_group) {
  return block > 0 && block <= ROWS && rows_per_group > 0 &&
         block % rows_per_group == 0;
}

}  // namespace

// The instance and launch shape a call takes: out = {lanes a column (R),
// threads a block, blocks along d_out, 1 if a group may start at any row}.
extern "C" int gptq_block_plan(int n, int block, int d_out, int rows_per_group,
                               int fixed, int* out) {
  if (!valid(block, rows_per_group) || n <= 0 || d_out <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Plan p;
  const int e = make_plan(n, block, d_out, rows_per_group, fixed != 0, &p);
  if (e != 0) return e;
  out[0] = p.lanes;
  out[1] = p.threads;
  out[2] = p.grid_x;
  out[3] = p.every_row;
  return 0;
}

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
  if (!valid(block, rows_per_group)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0 || d_out <= 0) return 0;
  Plan p;
  int e = make_plan(n, block, d_out, rows_per_group, fscale != nullptr, &p);
  if (e != 0) return e;
  const KernelFn fn = pick(p);
  e = allow_smem(reinterpret_cast<const void*>(fn), SMEM);
  if (e != 0) return e;
  const Args a{w,     w_sn,         u,     u_sn,   u_sr, block,
               d_out, (1 << bits) - 1, sym, rows_per_group, inv, fscale,
               fzero, q,            deq,   err,    scale, zero};
  fn<<<dim3(p.grid_x, n), p.threads, SMEM,
       static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
