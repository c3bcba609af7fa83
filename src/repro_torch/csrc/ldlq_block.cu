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
//   p   = E8 point nearest w_i / s_i, octet by octet (8 adjacent columns)
//   deq = p s_i;  err_i = (w_i - deq) / U_ii
//   w_j -= U_ij err_i  for the block's later rows j > i.
// The E8 point: a = D8(y), b = D8(y - 1/2) + 1/2, a if |y - a|^2 <=
// |y - b|^2 else b; D8(y): f = rint(y) (half to even), parity = floor-mod
// of f's sum by 2, and where the parity is odd the coordinate of the
// largest |y - f| (the first on ties) moves one step towards y (+1 at
// y - f >= 0).
//
// Bitwise equal to the plain version (kernels/ldlq_block/ref.py) on the
// card, ties included: every operation rounds as the one PyTorch performs
// there (__fmul_rn / __fsub_rn / __fadd_rn, so nvcc contracts nothing into
// an FMA), rintf rounds half to even as torch.round does, both 8-term
// squared distances and the parity's sum are added left to right as the
// plain version spells them, and each later row takes its updates in the
// order of i, as the plain loop does (it is right-looking too).  A tree
// takes the argmax of |y - f| with the left operand kept on ties, which
// is the first index, as torch.argmax's (an inf or NaN y makes the whole
// octet's deq and err NaN either way).
//
// What bounds it on the H100: not bytes (a block's rows, U tile and
// scales read once, deq and err written once: 0.0019 ms at d_out 4096)
// but the rows' dependent chain: row i + 1 is rounded only once row i's
// error has updated it, and each row puts on that chain two divisions,
// the gather of its octet and the rounder.
//
// Design (the recipe of gptq_block.cu; the first version kept one lane a
// column and gathered each row's earlier errors left-looking from shared
// memory: i ordered products a row on the chain, ~2400 cycles a row):
//   * A column's rows live in registers, right-looking.  R = 1, 2 or 4
//     lanes of a warp share a column, lane r owning its rows in chunks of
//     4 (rows 4 (q R + r) + t).  The rows run in rounds of 4 R rows; in a
//     round lane p's chunk is quantized row by row, and every lane then
//     updates all its slots, row i + 1's first, so that the other rows'
//     updates fill the next row's stalls.  After a round the slots move
//     down one chunk, so every register index is a constant, and the
//     number of slots a round updates halves as rows run out.  The R
//     owners of a round's chunks take turns in a loop (its body one chunk
//     of 4 rows, unrolled), which keeps the code of an instance to 4 rows
//     a phase: the rounder is ~300 instructions a row.
//   * E8 couples 8 adjacent columns, whose 8 R lanes lie in one warp (R <=
//     4).  Every lane of the octet divides its own slot by s_i, gathers
//     the octet's 8 values of y from row i's owners with 8 shuffles, runs
//     the whole rounder and forms its own column's error; so the R lanes
//     of a column hold the same error with no second broadcast, and the
//     sums keep the plain version's left-to-right order, which xor-shuffle
//     trees would not.  A lane's own coordinate comes from its own y
//     (rint, and the tree's index), not from a select among the eight.
//   * No branch in a round but the divisions' own: each branch ends the
//     region ptxas can schedule.  Both divisions are __fdiv_rn, IEEE
//     division (ref.subnormal_tie_inputs holds them to ties between fp32
//     subnormals, where a product by the fp64 reciprocal rounds the other
//     way).  A branch-free form, the product by the fp64 reciprocal with one
//     Markstein correction (equal to __fdiv_rn, from a table built once a
//     block), did not save 3% of a launch at each of llama3-8b's four
//     shape groups (chip_smoke.py --compare): too little for its tables and
//     its own checks.
//   * U's tile is staged once a block with 16-byte cp.async copies,
//     zero-filled past the block (4-byte copies where its rows are not
//     16-byte aligned), row-major: a lane's chunk of U's row i is one
//     conflict-free 16-byte shared load.  Rows past the block run on zeros
//     (U_ii and s_i read as 1) and store nothing; deq and err of a lane's
//     rows are kept to the round's end and stored then.
//   * 128 threads a block; R is picked from N x d_out: R 4 or 2 where the
//     grid then holds at most four warps an SM, one a scheduler (R 4 at
//     4224 columns or fewer, R 2 at 8448 on 132 SMs), else R 1, which has
//     no such limit: every lane of the octet runs the rounder, so R lanes
//     a column cost R times its instructions, and a second warp on a
//     scheduler doubles them where the first warp's chain already keeps it
//     busy.  R 1 takes any larger grid (28672 columns, llama3-8b's wi+wu,
//     are ~6.8 warps an SM), and a grid of more blocks than its registers
//     let the SMs hold at once runs in more than one wave (at two blocks
//     an SM, N 3 x 14336's 336 blocks on 132 SMs).  Any block of 1-128
//     rows, any d_out that is a multiple of 8 (an octet lies wholly inside
//     or wholly past d_out).
#include "hopper.cuh"

namespace {

constexpr int ROWS = 128;        // the largest block: U's tile is ROWS x ROWS
constexpr int CHUNK = 4;         // a lane owns its rows 4 at a time
constexpr int THREADS = 128;     // a block
constexpr int WARPS_PER_SM = 4;  // what the choice of R aims at
constexpr unsigned FULL = 0xffffffffu;
// U's tile row-major, then one zero row (a lane's last 16-byte loads of a
// row may run past its ROWS entries, into the next row or the zero row,
// only ever for rows it no longer needs); then each row's s_i and U_ii (1
// past the block)
constexpr size_t TILE_BYTES = sizeof(float) * (ROWS + 1) * ROWS;
constexpr size_t SMEM = TILE_BYTES + 2 * sizeof(float) * ROWS;

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

// The nearest point of D8, as ref._nearest_d8: out = f + flip parity, flip
// = onehot(idx) sgn.  Coordinate j adds zs = sgn parity where j == idx and
// z0 = (0 sgn) parity elsewhere: the same products, a signed zero
// included.  Returns idx, zs and z0 for the lane's own coordinate.
__device__ __forceinline__ void nearest_d8(const float (&y)[8],
                                           float (&out)[8], int& idx,
                                           float& zs, float& z0) {
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
  // the first index of the largest |delta|: a tree whose right operand
  // takes over only when strictly larger
  int i4[4];
  float d4[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const bool right = fabsf(delta[2 * k + 1]) > fabsf(delta[2 * k]);
    i4[k] = right ? 2 * k + 1 : 2 * k;
    d4[k] = right ? delta[2 * k + 1] : delta[2 * k];
  }
  int i2[2];
  float d2[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const bool right = fabsf(d4[2 * k + 1]) > fabsf(d4[2 * k]);
    i2[k] = right ? i4[2 * k + 1] : i4[2 * k];
    d2[k] = right ? d4[2 * k + 1] : d4[2 * k];
  }
  const bool right = fabsf(d2[1]) > fabsf(d2[0]);
  idx = right ? i2[1] : i2[0];
  const float sgn = (right ? d2[1] : d2[0]) >= 0.f ? 1.f : -1.f;
  zs = __fmul_rn(sgn, parity);
  z0 = __fmul_rn(__fmul_rn(0.f, sgn), parity);
#pragma unroll
  for (int j = 0; j < 8; ++j) out[j] = __fadd_rn(f[j], j == idx ? zs : z0);
}

// One lane's share of one column, R lanes a column.  The rows run in
// rounds of CHUNK R rows, chunk p of a round owned by lane p.  Lane r's
// slot CHUNK q + t holds row b + CHUNK (q R + r) + t of the round that
// starts at row b; after each round the slots move down one chunk, so
// every index into wr is a constant.  A round updates its first S slots;
// S halves as the rows run out (a phase each), as the rows left always
// fit in S R.  Rows past the block run too, on zeros, and store nothing.
template <int R>
struct Column {
  static constexpr int K = ROWS / R;  // slots a lane
  static constexpr int ROUND = CHUNK * R;
  static constexpr int SMIN = K / 8 > CHUNK ? K / 8 : CHUNK;  // last phase

  const Args& a;
  const float* us;  // U's tile, row-major, row stride ROWS
  const float* ss;  // s_i, U_ii
  const float* ud;
  long long o;       // deq / err offset of this column's row 0
  int r, lane;
  int base;          // the octet's first lane; column j's lanes follow
  int jc;            // this lane's column in its octet
  bool live;         // c < d_out (else: compute on zeros, store nothing)
  float wr[K];

  // rows b .. b + ROUND - 1
  template <int S>
  __device__ __forceinline__ void round(int b) {
    // this lane's rows of the round, b + CHUNK r + t: stored at its end
    float md[CHUNK] = {}, me[CHUNK] = {};
#pragma unroll 1
    for (int p = 0; p < R; ++p) {
      const bool mine = r == p;
      const int own = lane - r + p;  // row i's lane of this column
#pragma unroll
      for (int t = 0; t < CHUNK; ++t) {
        const int i = b + CHUNK * p + t;
        const float si = ss[i];
        // every lane divides its slot t; only lane p's is row i
        const float yl = __fdiv_rn(wr[t], si);
        float y[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          y[j] = __shfl_sync(FULL, yl, base + R * j + p);
        }
        float x = wr[t], yo = yl;
        if constexpr (R > 1) {
          x = __shfl_sync(FULL, x, own);
          yo = __shfl_sync(FULL, yl, own);
        }
        float pa[8], pb[8], ym[8];
        int ia, ib;
        float za, zb, oa, ob;
        nearest_d8(y, pa, ia, za, oa);
#pragma unroll
        for (int j = 0; j < 8; ++j) ym[j] = __fsub_rn(y[j], .5f);
        nearest_d8(ym, pb, ib, zb, ob);
#pragma unroll
        for (int j = 0; j < 8; ++j) pb[j] = __fadd_rn(pb[j], .5f);
        const bool keep_a = dist8(y, pa) <= dist8(y, pb);
        // this lane's coordinate of a and b, from its own y
        const float own_a = __fadd_rn(rintf(yo), jc == ia ? za : oa);
        const float own_b = __fadd_rn(
            __fadd_rn(rintf(__fsub_rn(yo, .5f)), jc == ib ? zb : ob), .5f);
        const float d = __fmul_rn(keep_a ? own_a : own_b, si);
        const float e = __fdiv_rn(__fsub_rn(x, d), ud[i]);
        md[t] = mine ? d : md[t];
        me[t] = mine ? e : me[t];
        // every slot takes row i's update, row i + 1's first; the slots of
        // rows <= i are done and never read again
        const float* ur = us + i * ROWS + b + CHUNK * r;
#pragma unroll
        for (int q = 0; q < S / CHUNK; ++q) {
          const float4 v = *reinterpret_cast<const float4*>(ur + ROUND * q);
          const float uv[CHUNK] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int u = 0; u < CHUNK; ++u) {
            const int sl = CHUNK * q + u;
            wr[sl] = __fsub_rn(wr[sl], __fmul_rn(uv[u], e));
          }
        }
      }
    }
    // the round's first chunk is done: the slots move down one chunk
#pragma unroll
    for (int sl = CHUNK; sl < S; ++sl) wr[sl - CHUNK] = wr[sl];
    if (live) {
#pragma unroll
      for (int t = 0; t < CHUNK; ++t) {
        const int i = b + CHUNK * r + t;
        if (i < a.block) {
          const long long oi = o + static_cast<long long>(i) * a.d_out;
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

template <int R>
__global__ void __launch_bounds__(THREADS) ldlq_block_kernel(const Args a) {
  using C = Column<R>;
  extern __shared__ float4 smem[];
  float* us = reinterpret_cast<float*>(smem);
  float* ss = us + TILE_BYTES / sizeof(float);
  float* ud = ss + ROWS;
  const int n = blockIdx.y;
  const int lane = threadIdx.x % 32;
  const int r = threadIdx.x % R;
  const int c = blockIdx.x * (THREADS / R) + threadIdx.x / R;
  C col{a,    us,   ss, ud, static_cast<long long>(n) * a.block * a.d_out + c,
        r,    lane, lane & ~(8 * R - 1), (lane / R) % 8, c < a.d_out, {}};
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
  const float* sn = a.s + n * a.s_sn;
  for (int i = threadIdx.x; i < ROWS; i += blockDim.x) {
    ss[i] = i < a.block ? sn[i] : 1.f;
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
  int lanes, threads, grid_x;
};

// R: the most lanes a column (up to 4, so that an octet's lanes lie in one
// warp) that keep N x d_out x R within WARPS_PER_SM warps an SM of the
// current device, or 1 where none does (then with no limit on the warps
// an SM, in more than one wave where the blocks outnumber what the SMs
// hold at once).  Returns a CUDA error, or 0.
int make_plan(int n, int d_out, Plan* out) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long cols = static_cast<long long>(n) * d_out;
  const long long target = static_cast<long long>(WARPS_PER_SM) * 32 * sms;
  Plan p{1, THREADS, 0};
  for (int lanes = 4; lanes > 1; lanes /= 2) {
    if (cols * lanes <= target) {
      p.lanes = lanes;
      break;
    }
  }
  p.grid_x = (d_out + THREADS / p.lanes - 1) / (THREADS / p.lanes);
  *out = p;
  return 0;
}

KernelFn pick(int lanes) {
  switch (lanes) {
    case 4:
      return ldlq_block_kernel<4>;
    case 2:
      return ldlq_block_kernel<2>;
    default:
      return ldlq_block_kernel<1>;
  }
}

}  // namespace

// The launch shape a call takes: out = {lanes a column (R), threads a
// block, blocks along d_out}.
extern "C" int ldlq_block_plan(int n, int d_out, int* out) {
  if (n <= 0 || d_out <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  const int e = make_plan(n, d_out, &p);
  if (e != 0) return e;
  out[0] = p.lanes;
  out[1] = p.threads;
  out[2] = p.grid_x;
  return 0;
}

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
  Plan p;
  int e = make_plan(n, d_out, &p);
  if (e != 0) return e;
  const KernelFn fn = pick(p.lanes);
  e = allow_smem(reinterpret_cast<const void*>(fn), SMEM);
  if (e != 0) return e;
  const Args a{w, w_sn, u, u_sn, u_sr, s, s_sn, block, d_out, deq, err};
  fn<<<dim3(p.grid_x, n), p.threads, SMEM,
       static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
