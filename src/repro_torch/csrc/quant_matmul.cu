// Packed weight-only quantized matmuls: y = x @ W and y = x @ Wᵀ with
// W = scale · (codes - zero).
//
// Replaces, in src/repro/kernels/quant_matmul/kernel.py:
//   quant_matmul_pallas / _qmm_kernel / _dequant_tile -> qmm_decode
//     (m <= 4), qmm_tc (m > 4; a bf16 form for bf16 x and an fp32 form,
//     qmm_tc_f32 in the launch counts, for fp32 x) (qmm_launch)
//   quant_matmul_t_pallas / _qmm_t_kernel -> qmm_t_decode (m <= 4),
//     qmm_t_tile (m > 4) (qmm_t_launch)
//
// Heads.  Every kernel takes a head count H (grid.z) and the strides of a
// head-batched weight: MLA's absorbed attention multiplies each of its 128
// heads by its own slice of one packed wkv_b in a single launch.  The
// per-head weights are strided views of the parent's codes, scale and zero
// (models/attention mla_latent_weights: columns h·(dn+dv) + [0, dn) for
// W_k, + [dn, dn+dv) for W_v), so the kernels read the parent's row stride
// (w_ld, s_ld) and a per-head column offset (w_hs, s_hs) and nothing is
// copied per step.  x is (H, m, k) and y (H, m, n), contiguous.  A plain
// 2-D weight is H = 1 with w_ld = s_ld = n.
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
//   prefill (m = B·T in the hundreds): operations, 2·m·n·k multiply-adds,
//     ~30 us for that projection at m 256 at the bf16 tensor-core rate.
//     fp32 x (MLA's head-batched expand of a prefill chunk, held to 1e-5)
//     costs three times the products (three bf16 terms of x), and at MLA's
//     shape (H 128, m 128, k 512, n 128) its bytes bound it instead: x, the
//     weight's views and the fp32 y, ~46 MB, 0.0137 ms at 3.35 TB/s.
//
// Design.  Codes are unpacked in registers with shift and mask and the
// per-group affine is applied in the kernel; the product is computed here,
// never handed to a library GEMM.
//   decode (qmm_decode): one launch, no scratch.  A block takes 128 output
//     columns (4 a lane) over one split of the packed words along k; the
//     splits of a column block are one thread-block cluster (at most 8),
//     whose blocks add their sums through distributed shared memory in rank
//     order (no second kernel, no float atomics).  The launcher alone plans
//     the splits (dec_plan): the fewest waves of the clusters the card holds
//     at once (cudaOccupancyMaxActiveClusters, asked once), each wave as
//     long as a split's words plus a fixed cost.  Each of the block's 8
//     warps walks its own contiguous run of word rows: a lane copies the 16
//     bytes of its 4 columns of each word row into its slots of the warp's
//     cp.async ring (5 slots of 2 word rows, 4 in flight) and reads back
//     only what it copied, so no barrier guards the ring.  Before the loop
//     the block stages its rows of x (one float4 of the 4 rows of x a k
//     row: one broadcast load feeds all of them) and the scale and
//     -(2^23 + zero) rows of its quant groups, every load of a thread in
//     flight at once and after the ring's first copies.  A code is
//     dequantized by magic number (OR-ed into 2^23's mantissa, plus
//     -(2^23 + zero): code - zero exactly, no I2F; check_zero keeps zeros
//     integers), its products with x are summed per quant group in fp32,
//     and the group's sum is scaled into the result when the group closes.
//     m is a template parameter (1, 2 and 4; m 3 runs the 4: a row's sums
//     do not depend on the others), and neither the plan nor any sum order
//     depends on m, so a row of y is the same bits at any m and any call.
//     Measured (chip_smoke.py on an H100 80GB HBM3 at 700 W, wd, 3 bits,
//     m 4): 0.034 ms against cuBLAS's 0.042 on the bf16 weight and 0.0082
//     of bytes; MLA's expand 0.0093-0.0100 against `bmm`'s 0.0080.  What
//     holds it back: instruction issue.  Each code costs a shift, a LOP3
//     and an add per column, then one FFMA per row of x (~29 a code at m
//     4); without its loads the kernel took 0.031 ms, without its
//     arithmetic 0.018, against 0.037 whole before the LOP3 change.  A
//     launch's fixed cost (~0.005 ms: staging, the cluster's sums) loses
//     the narrow projections to cuBLAS.  A tensor-core form (mma.sync
//     m16n8k16, A = code - zero as exact bf16 pairs, B = x) was built and
//     timed slower: 0.078 ms at 3 bits (a word of 10 codes fills 10 of a
//     k16 step's 16 slots, the code pairs need two shifts, and 8 tiles a
//     warp spill at 128 registers), 0.042 at 4 bits.
//   qmm_tc (prefill, m > 4): 64 x 128 output tiles (wgmma's 64 rows: at m 256
//     and n 4096 that is 128 blocks on 132 SMs; no split-k), warp
//     specialized, 512 threads:
//       - two producer warpgroups copy each 128-row k-tile global -> shared
//         by cp.async (x 64 x 128 bf16, the tile's packed words, and the
//         zero and scale rows of its quant groups), into a ring of 5 stages
//         (4 at 8 bits), 3 (2) tiles ahead; a 3-bit tile reads the one word
//         it shares with its neighbour (128 rows = 12.8 words).  They then
//         dequantize each packed word once, from registers by shift and
//         mask, into a bf16 B tile (128 x 128, two buffers);
//       - two consumer warpgroups (64 columns each) issue the tile's 8
//         wgmma.mma_async m64n64k16 (A = x, B = their columns, both from
//         shared memory, fp32 accumulators in registers) without waiting,
//         while the producers fill the other B buffer;
//       - named barriers hand B buffers over (filled / its wgmmas done).
//     x and B lie K-major in the 128-byte swizzle (conflict-free 16-byte
//     stores and cp.async, coalesced 128-byte rows of x).
//     B is (code - zero) in bf16, exact: codes and zeros are integers in
//     [0, 2^bits) (RTN and GPTQ round the zero; kernels/quant_matmul/ops
//     check_zero enforces it wherever a weight is packed or loaded, and
//     both dequantize paths below round 128 + zero or 2^23 + zero to an
//     integer, so they rely on it), so every product is exact and the
//     tensor core sums it in fp32.  The scale is not folded into
//     the weight: each quant group's partial sum (its own accumulator, reset
//     by the first wgmma of the group) is multiplied by its fp32 scale in
//     registers when the group closes, acc += s · acc_g; a group of 128
//     rows is one k-tile, and it closes at the start of the next tile.  A
//     16-row step that a group boundary crosses (gs % 16 != 0) is issued
//     once per group from registers (ldmatrix), with the other group's rows
//     of x zeroed.  Each row's sum runs over k in a fixed order whatever m
//     is, so a row of y does not depend on m or on the other rows.
//     What holds it back (chip_smoke.py on the H100: wd, 3 bits, m 256,
//     10x its 0.030 ms bound): loading, dequantizing and the wgmmas each
//     cost about the same, and they overlap far less than the warp roles
//     allow.  Each weight is dequantized by every 64-row block (4 at
//     m 256) and x is read by every column block (32): sharing them across
//     a cluster of blocks (distributed shared memory, TMA multicast) is the
//     next step.
//   qmm_tc, fp32 form (T = float, launch count qmm_tc_f32): the same
//     kernel, ring and protocol, with x through registers instead of the
//     ring: each producer loads its 4 chunks of 8 fp32 values of tile t
//     (two 16-byte loads each, 512 coalesced bytes a row) before it waits
//     for the tile's buffers, and after dequantizing B splits them exactly
//     into hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid), three
//     swizzled A tiles in two buffers (96 KB; the ring keeps only words,
//     zeros and scales, 5 slots, 3 at 8 bits: 211-218 KB in all).  Each
//     16-row step issues three wgmmas, hi, mid, lo, into the group's
//     accumulator: each term times code - zero is exact and the tensor core
//     sums in fp32, but its sums truncate, and a long run of them does not
//     stay within 1e-5 (gram measured 1.6e-5 over 768 wgmmas into one
//     accumulator).  So no tensor-core sum spans more than one k-tile (8
//     steps, 24 wgmmas): a group that runs on into the next tile (gs > 128,
//     or gs -1, one group for the whole row) is closed there, acc +=
//     s · acc_g, and acc_g starts again; the close points depend on k
//     alone.  (The bf16 form keeps one accumulator a group: its output is
//     rounded to bf16, 2^-9, far above that.)  A step that a group
//     boundary crosses loads the three terms by ldmatrix and masks them as
//     above.
//     The fp32 products of the plain version are replaced, not repeated:
//     hi + mid + lo is x within ~2^-24.  Rows stay independent of m.  The
//     split could sit with the consumers instead (fp32 x through the ring,
//     three register fragments a step, wgmma with A in registers): on the
//     H100 that measured the same at MLA's expand (0.0463 against 0.0472
//     ms) and 7% slower at wd, m 256 (0.547 against 0.513 ms), so the
//     producers split.  What holds it back (chip_smoke.py on the H100,
//     MLA's expand: 0.047 ms, 3.4x its byte bound): one block per SM, so
//     256 blocks run in two waves of four 128-row tiles each, the tile's
//     loads, dequantization, split and wgmmas following one another as in
//     the bf16 form.
// Ragged m, n and k (including the padded 3-bit word) are masked.
//
// qmm_t (y = x @ Wᵀ, the packed axis is the output): x (H, m, d) fp32, W
// (k/vpw words, d) per head; y (H, m, k) fp32.  Absorbing W_k into MLA's
// queries is H 128, d = dn 128, k = kv_lora_rank 512, m = the batch in
// decode (1-4) and the chunk (128) in the chunked prefill.
//   decode (m <= 4, qmm_t_decode): bound by the bytes of the codes, ~3.9 MB
//     at 3 bits (~1.2 us at 3.35 TB/s), and close to it by instruction
//     issue (each code's dequantization and m FMAs).  A warp takes four
//     word-rows at once, eight lanes each, every lane 16 columns of d as
//     four 16-byte loads issued together; a block holds 16 word-rows (8 KB
//     of codes in flight) and a 3-bit head takes 4 blocks, so 512 blocks
//     keep ~30 KB a SM in flight.  x (m x d) and the scale and zero rows of
//     the block's quant groups are staged once in shared memory, so each
//     (group, column) is read from global memory once per block.  m is a
//     template parameter: no FMA touches a padding row.  A code is
//     dequantized exactly as the plain version does ((code - zero) ·
//     scale, code - zero by magic-number subtraction; a word whose rows
//     straddle two groups takes each code's group) and the 8 lanes' sums
//     meet in a fixed butterfly, so a row's result does not depend on m.
//   prefill (m > 4, qmm_t_tile): operations, 2·H·m·d·k (~2.1 GFLOP at m
//     128), on the fp32 pipes.  128 x 128 output tiles: per 32-column chunk
//     of d the block dequantizes the words of its 128 output rows once for
//     all of its 128 rows of x, and each of 256 threads adds an 8 x 8 tile
//     of products; sums run over d in order, whatever m.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>
#include <cooperative_groups.h>
#include <type_traits>

#include "hopper.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int DEC_MAXM = 4;  // decode: largest m

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
};

// ---- qmm_tc: the prefill on the tensor cores (see the note at the top) ----
constexpr int TC_BM = 64, TC_BN = 128, TC_BK = 128;
// warps 0-7: two consumer warpgroups (wgmma, 64 output columns each);
// warps 8-15: producers (cp.async and dequantization)
constexpr int TC_CONSUMERS = 256, TC_PRODUCERS = 256;
constexpr int TC_THREADS = TC_CONSUMERS + TC_PRODUCERS;
constexpr int TC_GROUPS = 3;  // quant groups staged per tile (all if gs >= 64)
constexpr int TC_TERMS = SPLIT_TERMS;  // fp32 x: hi, mid, lo bf16 terms
// x (A) and the dequantized weight (B) lie K-major in shared memory in the
// 128-byte swizzle: a row (of x, or a column of W) holds 64 k values in 128
// bytes, its 16-byte chunk c stored at chunk c ^ (row % 8); 8 rows make a
// 1024-byte atom, and the tile's second 64 k follow the first's rows
constexpr int TC_X_BYTES = TC_BM * TC_BK * 2;
constexpr int TC_X_HALF = TC_BM * 128;  // the k 64 .. 127 half of an x tile
constexpr int TC_B_HALF = TC_BN * 128;
constexpr int TC_B_BYTES = TC_BN * TC_BK * 2;
constexpr int TC_Z_BYTES = TC_GROUPS * 2 * TC_BN * 4;  // zero, scale rows
// fp32 x: 8-value chunks of a tile each producer loads and splits
constexpr int TC_XCH = TC_BM * TC_BK / 8 / TC_PRODUCERS;
// named barriers (0 is __syncthreads'): the producers among themselves;
// B buffer b (and its x tile) filled; B buffer b's wgmmas done
constexpr int BAR_PROD = 1, BAR_FULL = 2, BAR_EMPTY = 4;

template <int BITS, bool F32> struct TcPack {
  static constexpr int VPW = 32 / BITS;
  // ring of (x (bf16 x only), words, zeros, scales) tiles, AHEAD of them in
  // flight ahead of the one being dequantized (fewer at 8 bits, for shared
  // memory)
  static constexpr int STAGES = BITS == 8 ? (F32 ? 3 : 4) : 5;
  static constexpr int AHEAD = STAGES - 2;
  // words a 128-row tile touches (3 bits: 12.8 words, so up to 14)
  static constexpr int WROWS =
      TC_BK % VPW == 0 ? TC_BK / VPW : TC_BK / VPW + 2;
  static constexpr int W_BYTES = WROWS * TC_BN * 4;
  // bf16 x: an x tile in every ring slot; fp32 x: the three terms of a
  // tile, in two buffers (as the B tiles)
  static constexpr int X_ALL =
      F32 ? 2 * TC_TERMS * TC_X_BYTES : STAGES * TC_X_BYTES;
  // + 1024: the swizzle atoms start 1024-byte aligned
  static constexpr int SMEM = X_ALL + STAGES * (W_BYTES + TC_Z_BYTES)
                              + 2 * TC_B_BYTES + 1024;
};

// 16 (or 4) bytes global -> shared; bytes past src_bytes are zero-filled
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- qmm_decode: m <= 4 (see the note at the top) ----
constexpr int DEC_THREADS = 256;  // 8 warps, each its own run of word rows
constexpr int DEC_WARPS = DEC_THREADS / 32;
constexpr int DEC_BN = 128;       // columns a block: 4 a lane, 16 bytes
constexpr int DEC_RW = 2;         // word rows a ring slot
constexpr int DEC_STAGES = 5;     // ring slots a warp: 4 in flight
constexpr int DEC_XROWS = 2304;   // most rows of x a pass stages
constexpr int DEC_GROUPS = 20;    // most quant groups a pass stages
constexpr int DEC_MAX_SPLITS = 8; // blocks of a cluster along k (portable)
constexpr int DEC_BLOCKS_PER_SM = 2;
constexpr int DEC_FIXED_WORDS = 16;  // a block's fixed cost in the plan
constexpr int DEC_RING_BYTES = DEC_WARPS * DEC_STAGES * DEC_RW * 32 * 16;
constexpr int DEC_X_BYTES = DEC_XROWS * 16;
constexpr int DEC_G_BYTES = DEC_GROUPS * 2 * DEC_BN * 4;
constexpr int DEC_SMEM = DEC_RING_BYTES + DEC_X_BYTES + DEC_G_BYTES;  // 96 KB
// staging: rows of x and (group, column) entries a thread loads
constexpr int DEC_XPT = (DEC_XROWS + DEC_THREADS - 1) / DEC_THREADS;
constexpr int DEC_GPT = (DEC_GROUPS * DEC_BN + DEC_THREADS - 1) / DEC_THREADS;

// accg[i][e] += x[i] · (code c of word wd[e] - zero), for the lane's 4
// columns e; nz = -(2^23 + zero): the code OR-ed into the mantissa of 2^23
// (magic, kept in a register so that mask and OR are one LOP3) is 2^23 +
// code, so one add gives code - zero exactly (no I2F)
template <int BITS, int M>
__device__ __forceinline__ void dec_code(float (&accg)[M][4],
                                         const uint32_t (&wd)[4], int c,
                                         float4 xv, const float (&nz)[4],
                                         uint32_t magic) {
  const float xi[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    uint32_t u;
    asm("lop3.b32 %0, %1, %2, %3, 0xEA;"  // (a & b) | c
        : "=r"(u)
        : "r"(wd[e] >> (c * BITS)), "n"(Pack<BITS>::MASK), "r"(magic));
    const float v = __uint_as_float(u) + nz[e];
#pragma unroll
    for (int i = 0; i < M; ++i) accg[i][e] = fmaf(xi[i], v, accg[i][e]);
  }
}

// Grid (ceil(n / DEC_BN), splits, H), clusters of (1, splits, 1): block
// (cb, split, head) takes columns cb·128 .. +127 (4 a lane) over words
// [split·wps, +wps), in passes of wpp words.  A pass stages its rows of x
// (one float4 of the M rows per k row, zero past m and past k) and the
// scale and -(2^23 + zero) rows of its quant groups, then each warp walks a
// contiguous run of the pass's words: its lanes stream their own 16 bytes
// of each word row through their slots of a cp.async ring (no barrier: a
// lane reads only what it copied), sum x · (code - zero) per quant group
// and add scale · that sum when the group closes.  The warps' sums meet in
// shared memory in warp order, then the cluster's blocks in rank order
// through distributed shared memory, each rank storing a slice of y.  The
// split plan depends on k, n, H and the card, never on m: a row of y is the
// same whatever m is, and the same from call to call.  w_vec: rows of words
// allow 16-byte copies (else four 4-byte ones).
template <typename T, int BITS, int M>
__global__ void __launch_bounds__(DEC_THREADS, DEC_BLOCKS_PER_SM)
qmm_decode(const T* __restrict__ x, const uint32_t* __restrict__ w,
           const float* __restrict__ scale, const float* __restrict__ zero,
           T* __restrict__ out, int m, int k, int n, int gs, int wps, int wpp,
           int w_ld, int w_hs, int s_ld, int s_hs, int w_vec) {
  using P = Pack<BITS>;
  extern __shared__ __align__(16) unsigned char dec_smem[];
  float4* xs = reinterpret_cast<float4*>(dec_smem + DEC_RING_BYTES);
  float* scs =
      reinterpret_cast<float*>(dec_smem + DEC_RING_BYTES + DEC_X_BYTES);
  float* nzs = scs + DEC_GROUPS * DEC_BN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.y, head = blockIdx.z;
  const int col0 = blockIdx.x * DEC_BN, cl = 4 * lane, col = col0 + cl;
  x += (size_t)head * m * k;
  out += (size_t)head * m * n;
  w += (size_t)head * w_hs;
  scale += (size_t)head * s_hs;
  zero += (size_t)head * s_hs;
  const int n_words = (k + P::VPW - 1) / P::VPW;
  const int w0 = split * wps, w1 = min(n_words, w0 + wps);
  // this lane's ring: slot s, word row j at ring[(s * DEC_RW + j) * 32]
  const uint4* ring = reinterpret_cast<const uint4*>(dec_smem) +
                      warp * DEC_STAGES * DEC_RW * 32 + lane;
  const uint32_t ring_s = smem_u32(ring);

  float acc[M][4];
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  for (int p0 = w0; p0 < w1; p0 += wpp) {
    const int p1 = min(w1, p0 + wpp);
    const int r_lo = p0 * P::VPW, r_hi = min(k, p1 * P::VPW);
    const int g0 = r_lo / gs, ng = (r_hi - 1) / gs - g0 + 1;
    // this warp's run of words [a, b); its first copies go out before the
    // staging below
    const int per = (p1 - p0 + DEC_WARPS - 1) / DEC_WARPS;
    const int a = p0 + warp * per, b = min(p1, a + per);
    const int nst = (b - a + DEC_RW - 1) / DEC_RW;
    auto issue = [&](int st) {
      asm volatile("" ::: "memory");  // after this lane's reads of the slot
      const int slot = st % DEC_STAGES;
#pragma unroll
      for (int j = 0; j < DEC_RW; ++j) {
        const int wr = a + st * DEC_RW + j;
        const uint32_t dst = ring_s + (slot * DEC_RW + j) * 32 * 16;
        const uint32_t* src = w + (size_t)wr * w_ld + col;
        if (w_vec) {
          const bool ok = wr < b && col < n;
          cp_async16(dst, ok ? src : w, ok ? 16 : 0);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool ok = wr < b && col + e < n;
            cp_async4(dst + 4 * e, ok ? src + e : w, ok ? 4 : 0);
          }
        }
      }
      cp_async_commit();
    };
    if (a < b) {
#pragma unroll
      for (int st = 0; st < DEC_STAGES - 1; ++st) issue(st);
    }

    // stage the pass's x and group rows: every load of a thread issued
    // before any store, so the block waits one load latency, not several
    __syncthreads();  // the last pass's reads of xs, scs and nzs are done
    {
      const int xrows = (p1 - p0) * P::VPW;
      float v[DEC_XPT][4];
#pragma unroll
      for (int u = 0; u < DEC_XPT; ++u) {
        const int row = r_lo + tid + u * DEC_THREADS;
        const bool ok = tid + u * DEC_THREADS < xrows && row < k;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          v[u][i] = i < M && i < m && ok ? to_f(x[(size_t)i * k + row]) : 0.f;
      }
      float sv[DEC_GPT], zv[DEC_GPT];
#pragma unroll
      for (int u = 0; u < DEC_GPT; ++u) {
        const int idx = tid + u * DEC_THREADS;
        const int cc = col0 + idx % DEC_BN;
        const size_t src = (size_t)(g0 + idx / DEC_BN) * s_ld + cc;
        const bool ok = idx < ng * DEC_BN && cc < n;
        sv[u] = ok ? scale[src] : 0.f;
        zv[u] = ok ? zero[src] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < DEC_XPT; ++u) {
        const int r = tid + u * DEC_THREADS;
        if (r < xrows) xs[r] = make_float4(v[u][0], v[u][1], v[u][2], v[u][3]);
      }
#pragma unroll
      for (int u = 0; u < DEC_GPT; ++u) {
        const int idx = tid + u * DEC_THREADS;
        if (idx < ng * DEC_BN) {
          scs[idx] = sv[u];
          nzs[idx] = -(8388608.f + zv[u]);
        }
      }
    }
    __syncthreads();
    if (a >= b) continue;

    int g = (a * P::VPW) / gs;
    int g_end = (g + 1) * gs;
    float nz[4], accg[M][4];
    auto load_nz = [&]() {
      const float4 z4 =
          *reinterpret_cast<const float4*>(nzs + (g - g0) * DEC_BN + cl);
      nz[0] = z4.x; nz[1] = z4.y; nz[2] = z4.z; nz[3] = z4.w;
    };
    auto close = [&]() {  // acc += scale · the group's sum
      const float4 s4 =
          *reinterpret_cast<const float4*>(scs + (g - g0) * DEC_BN + cl);
      const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
      for (int i = 0; i < M; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[i][e] = fmaf(sv[e], accg[i][e], acc[i][e]);
          accg[i][e] = 0.f;
        }
    };
    load_nz();
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) accg[i][e] = 0.f;
    uint32_t magic;  // 2^23's bits, in a register
    asm volatile("mov.b32 %0, 0x4B000000;" : "=r"(magic));
    for (int t = 0; t < nst; ++t) {
      issue(t + DEC_STAGES - 1);
      cp_async_wait<DEC_STAGES - 1>();  // my copies of stage t landed
      const uint4* slot = ring + (t % DEC_STAGES) * DEC_RW * 32;
#pragma unroll
      for (int j = 0; j < DEC_RW; ++j) {
        const int wr = a + t * DEC_RW + j;
        if (wr >= b) break;
        const uint4 wv = slot[j * 32];
        const uint32_t wd[4] = {wv.x, wv.y, wv.z, wv.w};
        const int row0 = wr * P::VPW;
        const float4* xr = xs + (row0 - r_lo);
        if (row0 + P::VPW <= g_end) {  // the word lies in one group
#pragma unroll
          for (int c = 0; c < P::VPW; ++c)
            dec_code<BITS, M>(accg, wd, c, xr[c], nz, magic);
        } else {  // it crosses into the next group(s), or past k
#pragma unroll
          for (int c = 0; c < P::VPW; ++c) {
            const int row = row0 + c;
            if (row >= k) break;  // the zero-padded codes of the last word
            if (row == g_end) {
              close();
              ++g;
              g_end += gs;
              load_nz();
            }
            dec_code<BITS, M>(accg, wd, c, xr[c], nz, magic);
          }
        }
      }
    }
    cp_async_wait<0>();
    close();
  }

  // the warps' sums in warp order, over the ring; then the block's in xs
  __syncthreads();
  float* red = reinterpret_cast<float*>(dec_smem);
#pragma unroll
  for (int i = 0; i < M; ++i)
    *reinterpret_cast<float4*>(red + (warp * M + i) * DEC_BN + cl) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  __syncthreads();
  float* part = reinterpret_cast<float*>(dec_smem + DEC_RING_BYTES);
  for (int idx = tid; idx < M * DEC_BN; idx += DEC_THREADS) {
    float v = 0.f;
#pragma unroll
    for (int wi = 0; wi < DEC_WARPS; ++wi) v += red[wi * M * DEC_BN + idx];
    part[idx] = v;
  }
  // the splits' sums in rank order; rank r stores outputs [r·per, +per)
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int per = (M * DEC_BN + splits - 1) / splits;
  const int hi = min(M * DEC_BN, (rank + 1) * per);
  for (int idx = rank * per + tid; idx < hi; idx += DEC_THREADS) {
    float v = 0.f;
    for (int r = 0; r < splits; ++r) v += cluster.map_shared_rank(part, r)[idx];
    const int i = idx / DEC_BN, c = col0 + idx % DEC_BN;
    if (i < m && c < n) store(out + (size_t)i * n + c, v);
  }
  cluster.sync();  // no block leaves while the others read its sums
}
// byte offset of 16-byte chunk c (k 8c .. 8c+7) of row r, in a tile whose
// k 64 .. 127 half starts `half` bytes on
__device__ __forceinline__ int swz(int r, int c, int half) {
  return (c / 8) * half + swz128(r, c % 8);
}
// the descriptor's start for k step j (16 k) of such a tile
__device__ __forceinline__ uint32_t kstep(uint32_t base, int j, int half) {
  return base + (j / 4) * half + (j % 4) * 32;
}

// d (64 x 64, fp32) = A · B (+ d when scale_d), A and B from shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// the same with A from registers (the m16n8k16 A fragment of each warp)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// T = __nv_bfloat16: x and y bf16; T = float: x and y fp32, x split into
// three bf16 terms (the note at the top)
template <typename T, int BITS>
__global__ void __launch_bounds__(TC_THREADS, 1)
qmm_tc(const T* __restrict__ x, const uint32_t* __restrict__ w,
       const float* __restrict__ scale, const float* __restrict__ zero,
       T* __restrict__ out, int m, int k, int n, int gs,
       int w_ld, int w_hs, int s_ld, int s_hs, int x_vec, int w_vec,
       int s_vec) {
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr int TERMS = F32 ? TC_TERMS : 1;  // A terms a 16-row step issues
  using P = TcPack<BITS, F32>;
  constexpr uint32_t MASK = (1u << BITS) - 1u;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  uint8_t* const xs =                                   // x tiles or terms
      smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  uint8_t* const bs = xs + P::X_ALL;                    // two B tiles
  uint8_t* const ws = bs + 2 * TC_B_BYTES;              // word tiles
  uint8_t* const zs = ws + P::STAGES * P::W_BYTES;      // zero, scale rows
  const int head = blockIdx.z;
  x += (size_t)head * m * k;
  out += (size_t)head * m * n;
  w += (size_t)head * w_hs;
  scale += (size_t)head * s_hs;
  zero += (size_t)head * s_hs;
  const int m0 = blockIdx.y * TC_BM, n0 = blockIdx.x * TC_BN;
  const int tid = threadIdx.x;
  const int n_words = (k + P::VPW - 1) / P::VPW;
  const int n_groups = k / gs;
  const int n_tiles = (k + TC_BK - 1) / TC_BK;

  // zero (which 0) or scale (1) of quant group g, tile column c, as k-tile
  // t staged it (groups t·BK/gs .. + TC_GROUPS - 1), else from global
  // memory (gs < 64 only)
  auto group_param = [&](int t, int g, int which, int c) -> float {
    const int i = g - t * TC_BK / gs;
    if (i < TC_GROUPS)
      return reinterpret_cast<const float*>(
          zs + (t % P::STAGES) * TC_Z_BYTES)[(2 * i + which) * TC_BN + c];
    return n0 + c < n ? __ldg((which ? scale : zero) + (size_t)g * s_ld +
                              n0 + c)
                      : 0.f;
  };

  if (tid >= TC_CONSUMERS) {
    // ---------------- producers: loads and dequantization ----------------
    const int ptid = tid - TC_CONSUMERS;
    // global -> shared for k-tile u (nothing past the last tile; the commit
    // keeps one cp.async group per tile either way)
    auto load_tile = [&](int u) {
      if (u < n_tiles) {
        const int k0 = u * TC_BK, slot = u % P::STAGES;
        if constexpr (F32) {
          // fp32 x goes through registers (load_x, split_x)
        } else if (x_vec) {  // 16-byte chunks; 8 lanes fill one 128-byte row
          const uint32_t xd = smem_u32(xs + slot * TC_X_BYTES);
          for (int idx = ptid; idx < TC_BM * (TC_BK / 8);
               idx += TC_PRODUCERS) {
            const int c = idx % 8 + idx / (8 * TC_BM) * 8;
            const int r = idx / 8 % TC_BM;
            const int row = m0 + r, kc = k0 + 8 * c;
            const bool ok = row < m && kc < k;
            cp_async16(xd + swz(r, c, TC_X_HALF),
                       ok ? x + (size_t)row * k + kc : x, ok ? 16 : 0);
          }
        } else {  // rows not 16-byte aligned (k % 8 != 0): element-wise
          __nv_bfloat16* xp =
              reinterpret_cast<__nv_bfloat16*>(xs + slot * TC_X_BYTES);
          for (int idx = ptid; idx < TC_BM * TC_BK; idx += TC_PRODUCERS) {
            const int r = idx / TC_BK, kk = idx % TC_BK;
            const int row = m0 + r, kc = k0 + kk;
            xp[swz(r, kk / 8, TC_X_HALF) / 2 + kk % 8] =
                (row < m && kc < k) ? x[(size_t)row * k + kc]
                                    : __float2bfloat16(0.f);
          }
        }
        const int wlo = k0 / P::VPW;
        const uint32_t wd = smem_u32(ws + slot * P::W_BYTES);
        if (w_vec) {
          for (int idx = ptid; idx < P::WROWS * (TC_BN / 4);
               idx += TC_PRODUCERS) {
            const int wr = idx / (TC_BN / 4), cc = idx % (TC_BN / 4);
            const int wi = wlo + wr, col = n0 + 4 * cc;
            const int nb =
                (wi < n_words && col < n) ? min(16, (n - col) * 4) : 0;
            cp_async16(wd + wr * TC_BN * 4 + cc * 16,
                       nb ? w + (size_t)wi * w_ld + col : w, nb);
          }
        } else {
          for (int idx = ptid; idx < P::WROWS * TC_BN; idx += TC_PRODUCERS) {
            const int wr = idx / TC_BN, c = idx % TC_BN;
            const int wi = wlo + wr, col = n0 + c;
            const bool ok = wi < n_words && col < n;
            cp_async4(wd + wr * TC_BN * 4 + c * 4,
                      ok ? w + (size_t)wi * w_ld + col : w, ok ? 4 : 0);
          }
        }
        // rows 2i (zero) and 2i + 1 (scale) of group k0/gs + i
        const int glo = k0 / gs;
        const uint32_t zd = smem_u32(zs + slot * TC_Z_BYTES);
        for (int idx = ptid; idx < TC_GROUPS * 2 * (TC_BN / 4);
             idx += TC_PRODUCERS) {
          const int zr = idx / (TC_BN / 4), cc = idx % (TC_BN / 4);
          const int g = glo + zr / 2;
          const float* src = (zr % 2 ? scale : zero) + (size_t)g * s_ld;
          for (int e = 0; e < (s_vec ? 1 : 4); ++e) {
            const int col = n0 + 4 * cc + e;
            if (s_vec) {
              const int nb =
                  (g < n_groups && col < n) ? min(16, (n - col) * 4) : 0;
              cp_async16(zd + zr * TC_BN * 4 + cc * 16,
                         nb ? src + col : zero, nb);
            } else {
              const bool ok = g < n_groups && col < n;
              cp_async4(zd + zr * TC_BN * 4 + (4 * cc + e) * 4,
                        ok ? src + col : zero, ok ? 4 : 0);
            }
          }
        }
      }
      cp_async_commit();
    };


    // thread (column dc, half dh) dequantizes rows 64·dh .. +63 of every
    // k-tile: its rows only increase, so it follows its quant group
    // incrementally
    const int dc = ptid % TC_BN, dh = ptid / TC_BN;
    const bool dcol_ok = n0 + dc < n;
    int zg_end = 0;
    float zc = 0.f;
    auto dequant = [&](int t) {
      const int k0 = t * TC_BK, slot = t % P::STAGES;
      const uint32_t* wsl =
          reinterpret_cast<const uint32_t*>(ws + slot * P::W_BYTES);
      const int wlo = k0 / P::VPW;
      uint8_t* bb = bs + (t & 1) * TC_B_BYTES;
      const int r_first = k0 + 64 * dh;
      const int g_first = r_first / gs;
      if (r_first + 63 < k && (r_first + 63) / gs == g_first) {
        // my 64 rows lie inside k and in one quant group: straight-line
        // (a column past n reads zero-filled words and zero: it stores 0)
        const float z = group_param(t, g_first, 0, dc);
        const int b0 = r_first - wlo * P::VPW;  // my first row, in words
        // 2-4 bits: bf16 0x4300 | c is 128 + c exactly, and one bf16x2
        // subtract of (128 + zero) gives two exact values.  8 bits: 2^23 + c
        // as a float minus (2^23 + zero), exact, then rounded to bf16 exactly
        const __nv_bfloat162 zz = __float2bfloat162_rn(128.f + z);
        const float zf = 8388608.f + z;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int rr = b0 + 8 * q;
          const int lw = rr / P::VPW, j0 = rr - lw * P::VPW;
          uint64_t v = wsl[lw * TC_BN + dc];
          if constexpr (BITS == 3 || BITS == 8) {  // 8 rows span two words
            const uint64_t w1 = wsl[(lw + 1) * TC_BN + dc];
            v = BITS == 3 ? (v & 0x3FFFFFFFull) | (w1 << 30)
                          : v | (w1 << 32);
          }
          v >>= j0 * BITS;
          uint4 o;
          if constexpr (BITS <= 4) {
            // codes 4..7 moved 16 bits above codes 0..3: shift and mask k
            // gives codes k and k + 4 as the two halves of a bf16x2
            constexpr uint32_t LO = (1u << (4 * BITS)) - 1u;
            const uint32_t v32 = static_cast<uint32_t>(v);
            const uint32_t t4 = (v32 & LO) | ((v32 & (LO << (4 * BITS)))
                                              << (16 - 4 * BITS));
            uint32_t d[4];
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const uint32_t b16 =
                  ((t4 >> (kk * BITS)) & (MASK | (MASK << 16))) | 0x43004300u;
              const __nv_bfloat162 e =
                  __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&b16), zz);
              d[kk] = *reinterpret_cast<const uint32_t*>(&e);
            }
            // (c0, c4) (c1, c5) (c2, c6) (c3, c7) -> (c0, c1) .. (c6, c7)
            o = make_uint4(__byte_perm(d[0], d[1], 0x5410),
                           __byte_perm(d[2], d[3], 0x5410),
                           __byte_perm(d[0], d[1], 0x7632),
                           __byte_perm(d[2], d[3], 0x7632));
          } else {
            float f[8];
#pragma unroll
            for (int i = 0; i < 8; ++i)
              f[i] = __uint_as_float(
                         0x4B000000u |
                         (static_cast<uint32_t>(v >> (i * BITS)) & MASK)) -
                     zf;
            o = make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]),
                           pack_bf16(f[4], f[5]), pack_bf16(f[6], f[7]));
          }
          *reinterpret_cast<uint4*>(bb + swz(dc, 8 * dh + q, TC_B_HALF)) = o;
        }
        return;
      }
#pragma unroll 1
      for (int q = 0; q < 8; ++q) {
        const int r0 = r_first + q * 8;  // 8 rows: one 16-byte chunk
        uint4 o = make_uint4(0u, 0u, 0u, 0u);
        if (r0 < k && dcol_ok) {
          const int wi0 = r0 / P::VPW, j0 = r0 - wi0 * P::VPW;
          const int lw = wi0 - wlo;
          uint64_t v = wsl[lw * TC_BN + dc];
          if constexpr (BITS == 3 || BITS == 8) {
            const uint64_t w1 =
                lw + 1 < P::WROWS ? wsl[(lw + 1) * TC_BN + dc] : 0u;
            v = BITS == 3 ? (v & 0x3FFFFFFFull) | (w1 << 30)
                          : v | (w1 << 32);
          }
          v >>= j0 * BITS;
          float f[8];
          // a group boundary or the end of k may fall inside these rows
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            f[i] = 0.f;
            if (r0 + i < k) {
              if (r0 + i >= zg_end) {
                const int g = (r0 + i) / gs;
                zc = group_param(t, g, 0, dc);
                zg_end = (g + 1) * gs;
              }
              f[i] = __uint_as_float(
                         0x4B000000u |
                         (static_cast<uint32_t>(v >> (i * BITS)) & MASK)) -
                     (8388608.f + zc);
            }
          }
          o = make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]),
                         pack_bf16(f[4], f[5]), pack_bf16(f[6], f[7]));
        }
        *reinterpret_cast<uint4*>(bb + swz(dc, 8 * dh + q, TC_B_HALF)) = o;
      }
    };

    // fp32 x: chunk idx = ptid + TC_PRODUCERS·i of a tile is row idx / 16,
    // k values 8·(idx % 16) .. + 7 (16 lanes read one row's 512 bytes); it
    // is loaded into registers before the wait for its buffer and split
    // into the tile's three terms after the dequantization
    float xv[TC_XCH][8];
    auto load_x = [&](int t) {
      const int k0 = t * TC_BK;
#pragma unroll
      for (int i = 0; i < TC_XCH; ++i) {
        const int idx = ptid + TC_PRODUCERS * i;
        const int row = m0 + idx / (TC_BK / 8);
        const int kc = k0 + 8 * (idx % (TC_BK / 8));
        const float* src = reinterpret_cast<const float*>(x) +
                           (size_t)row * k + kc;
        if (x_vec) {  // k % 4 == 0: a chunk is two aligned float4 or none
          float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
          if (row < m && kc < k) {
            a = __ldg(reinterpret_cast<const float4*>(src));
            if (kc + 4 < k) b = __ldg(reinterpret_cast<const float4*>(src) + 1);
          }
          xv[i][0] = a.x; xv[i][1] = a.y; xv[i][2] = a.z; xv[i][3] = a.w;
          xv[i][4] = b.x; xv[i][5] = b.y; xv[i][6] = b.z; xv[i][7] = b.w;
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            xv[i][e] = row < m && kc + e < k ? __ldg(src + e) : 0.f;
        }
      }
    };
    auto split_x = [&](int t) {
      uint8_t* const ab = xs + (t & 1) * TC_TERMS * TC_X_BYTES;
#pragma unroll
      for (int i = 0; i < TC_XCH; ++i) {
        const int idx = ptid + TC_PRODUCERS * i;
        const int off = swz(idx / (TC_BK / 8), idx % (TC_BK / 8), TC_X_HALF);
        uint32_t t3[4][TC_TERMS];
#pragma unroll
        for (int e = 0; e < 4; ++e) split3(xv[i][2 * e], xv[i][2 * e + 1], t3[e]);
#pragma unroll
        for (int q = 0; q < TC_TERMS; ++q)
          *reinterpret_cast<uint4*>(ab + q * TC_X_BYTES + off) =
              make_uint4(t3[0][q], t3[1][q], t3[2][q], t3[3][q]);
      }
    };

    for (int u = 0; u < P::AHEAD; ++u) load_tile(u);
    for (int t = 0; t < n_tiles; ++t) {
      if constexpr (F32) load_x(t);  // in flight during what follows
      // B buffer t % 2 (and fp32 x's terms) and the ring slot that tile
      // t + AHEAD fills held tile t - 2, whose wgmmas are done
      if (t >= 2) bar_sync(BAR_EMPTY + t % 2, TC_THREADS);
      load_tile(t + P::AHEAD);
      cp_async_wait<P::AHEAD>();          // my copies of tile t landed
      bar_sync(BAR_PROD, TC_PRODUCERS);   // everyone's did
      dequant(t);
      if constexpr (F32) split_x(t);
      fence_proxy_async();  // the B tile (and x) -> visible to wgmma
      bar_arrive(BAR_FULL + t % 2, TC_THREADS);
    }
    return;
  }

  // ---------------- consumers: the product on the tensor cores ----------
  // warpgroup wg owns columns 64·wg .. +63 of the tile
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  float acc[32], accg[32], sreg[16];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = accg[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) sreg[i] = 0.f;
  int cur_g = -1, g_hi = 0, scale_d = 0;
  // accumulator element 4j + 2h + e: row 16·warp + lane/4 + 8h, column
  // 8j + 2·(lane % 4) + e of the warpgroup's 64
  const int ccol = wg * 64 + 2 * (lane % 4);  // in the tile
  auto close_group = [&]() {  // acc += s_g · acc_g
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(accg);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          acc[4 * j + 2 * h + e] =
              fmaf(sreg[2 * j + e], accg[4 * j + 2 * h + e],
                   acc[4 * j + 2 * h + e]);
  };
  auto open_group = [&](int t, int g) {
    if (cur_g >= 0) close_group();
    cur_g = g;
    g_hi = (g + 1) * gs;
    scale_d = 0;  // the group's first wgmma overwrites acc_g
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        sreg[2 * j + e] = group_param(t, g, 1, ccol + 8 * j + e);
    fence_regs(accg);
    wgmma_fence();
  };
  auto mma_tile = [&](int t) {
    const int k0 = t * TC_BK;
    // x's tile (term q of fp32 x's at + q·TC_X_BYTES)
    const uint32_t xa =
        F32 ? smem_u32(xs + (t & 1) * TC_TERMS * TC_X_BYTES)
            : smem_u32(xs + (t % P::STAGES) * TC_X_BYTES);
    const uint32_t ba = smem_u32(bs + (t & 1) * TC_B_BYTES) + wg * 64 * 128;
    // 16-row step j: one wgmma per term of x, hi first
    auto step = [&](int j, uint64_t db) {
#pragma unroll
      for (int q = 0; q < TERMS; ++q) {
        wgmma_ss(accg, make_desc(kstep(xa + q * TC_X_BYTES, j, TC_X_HALF)),
                 db, scale_d);
        scale_d = 1;
      }
    };
    const int g0 = k0 / gs;
    if (F32 && g0 == cur_g) {
      // fp32 x: a group that runs on from the last tile (gs > 128, or one
      // group for the whole row) has its partial scaled into acc here and
      // acc_g starts again, so no tensor-core sum spans more than a tile
      close_group();
      scale_d = 0;
      fence_regs(accg);
    }
    if (k0 + TC_BK <= k && (k0 + TC_BK - 1) / gs == g0) {
      // the whole tile lies in one quant group (gs 128: every tile): eight
      // steps back to back, nothing else touching the accumulators
      if (g0 != cur_g) open_group(t, g0);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < TC_BK / 16; ++j)
        step(j, make_desc(kstep(ba, j, TC_B_HALF)));
      wgmma_commit();
      wgmma_wait<1>();  // the previous tile's wgmmas are done
      return;
    }
    wgmma_fence();
    for (int j = 0; j < TC_BK / 16; ++j) {
      const int r0 = k0 + 16 * j;
      if (r0 >= k) break;
      const int r1 = min(r0 + 16, k);
      const uint64_t db = make_desc(kstep(ba, j, TC_B_HALF));
      if (cur_g >= 0 && r0 >= cur_g * gs && r1 <= g_hi) {
        step(j, db);
        continue;
      }
      const int ga = r0 / gs, gb = (r1 - 1) / gs;
      if (ga == gb) {  // a new group starts at this step
        open_group(t, ga);
        step(j, db);
        continue;
      }
      // group boundaries inside the step: once per group, x from
      // registers with the other groups' rows zeroed
      for (int g = ga; g <= gb; ++g) {
        if (g != cur_g) open_group(t, g);
        wgmma_commit();
        wgmma_wait<0>();
        const int mi = lane / 8;
        const int row = warp * 16 + (mi & 1) * 8 + lane % 8;
        const int lo = max(r0, g * gs), hi = min(r1, (g + 1) * gs);
        uint32_t a[TERMS][4];
#pragma unroll
        for (int q = 0; q < TERMS; ++q) {
          asm volatile(
              "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
              "[%4];\n"
              : "=r"(a[q][0]), "=r"(a[q][1]), "=r"(a[q][2]), "=r"(a[q][3])
              : "r"(xa + q * TC_X_BYTES +
                    swz(row, 2 * j + (mi >> 1), TC_X_HALF)));
#pragma unroll
          for (int f = 0; f < 4; ++f) {
            const int kk = r0 + 2 * (lane % 4) + (f >= 2 ? 8 : 0);
            const uint32_t keep = (kk >= lo && kk < hi ? 0x0000FFFFu : 0u) |
                                  (kk + 1 >= lo && kk + 1 < hi ? 0xFFFF0000u
                                                               : 0u);
            a[q][f] &= keep;
          }
        }
        fence_regs(accg);
        wgmma_fence();
#pragma unroll
        for (int q = 0; q < TERMS; ++q) {
          wgmma_rs(accg, a[q], db, scale_d);
          scale_d = 1;
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(accg);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous tile's wgmmas are done
  };

  for (int t = 0; t < n_tiles; ++t) {
    bar_sync(BAR_FULL + t % 2, TC_THREADS);  // B tile t and x tile t ready
    mma_tile(t);
    // tile t - 1's wgmmas are done: its B buffer and ring slot are free
    // (released only where a later tile will wait for them)
    if (t >= 1 && t + 1 < n_tiles) bar_arrive(BAR_EMPTY + (t - 1) % 2,
                                              TC_THREADS);
  }
  if (cur_g >= 0) close_group();

  const int rowb = m0 + warp * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = rowb + 8 * h, col = n0 + ccol + 8 * j + e;
        if (row < m && col < n)
          store(out + (size_t)row * n + col, acc[4 * j + 2 * h + e]);
      }
}

// y = x @ Wᵀ per head; see the note at the top of the file.
//
// Decode (m <= 4): a lane owns QT_COLS columns of d of one packed
// word-row (vpw output rows); the QT_LANES lanes of a word-row cover 128
// columns a pass and add their partial sums in a fixed butterfly.
constexpr int QT_THREADS = 128;
constexpr int QT_LANES = 8;   // lanes of one word-row (x QT_COLS = 128 columns)
constexpr int QT_COLS = 16;   // columns of d a lane holds in a pass
constexpr int QT_WROWS = QT_THREADS / QT_LANES;  // word-rows per block
// Prefill (m > 4): 128 x 128 output tiles (rows of x x output rows),
// 256 threads with 8 x 8 fp32 sums each, d walked in chunks of 32.
constexpr int QTT_BM = 128, QTT_BN = 128, QTT_BK = 32, QTT_THREADS = 256;

// acc[j][i] += x[i][c] * ((code_j - z) * s) over the 4 columns of one
// 16-byte sub-chunk (columns e = 0..3 in order), codes j in [0, VPW): codes
// before jb take group a's scale and zero (+ 2^23), the others group b's
// (a word's rows straddle at most two groups when gs >= VPW).
template <int BITS, int M>
__device__ __forceinline__ void qmm_t_sub(
    float (&acc)[Pack<BITS>::VPW][M], uint4 w4, float4 sa, float4 za,
    float4 sb, float4 zb, const float4 (&x4)[M], int jb) {
  using P = Pack<BITS>;
  const uint32_t wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float s0 = e == 0 ? sa.x : e == 1 ? sa.y : e == 2 ? sa.z : sa.w;
    const float z0 = e == 0 ? za.x : e == 1 ? za.y : e == 2 ? za.z : za.w;
    const float s1 = e == 0 ? sb.x : e == 1 ? sb.y : e == 2 ? sb.z : sb.w;
    const float z1 = e == 0 ? zb.x : e == 1 ? zb.y : e == 2 ? zb.z : zb.w;
#pragma unroll
    for (int j = 0; j < P::VPW; ++j) {
      const bool hi = j >= jb;
      // 2^23 + code, minus 2^23 + zero: code - zero exactly
      const float v =
          (__uint_as_float(0x4B000000u | ((wv[e] >> (j * BITS)) & P::MASK)) -
           (hi ? z1 : z0)) * (hi ? s1 : s0);
#pragma unroll
      for (int i = 0; i < M; ++i) {
        const float xi = e == 0 ? x4[i].x : e == 1 ? x4[i].y
                         : e == 2 ? x4[i].z : x4[i].w;
        acc[j][i] = fmaf(xi, v, acc[j][i]);
      }
    }
  }
}

// Grid (ceil(n_words / QT_WROWS), H).  Lane p (of 8) of word-row slot q
// (of 4) in warp w takes word-row blockIdx.x * 16 + 4w + q and columns
// 128·pass + 16p .. + 15.  The block's x (M x d) and the scale and zero
// rows of its quant groups are staged in shared memory once; each lane's
// 16 code words of a pass are four 16-byte loads issued together.  A row's
// sum runs over its columns in order within a lane, then over the 8 lanes
// in a fixed butterfly, whatever M: a row of y does not depend on m.  At
// most 128 registers: four blocks an SM hold deepseek-v3's 512 in one wave.
// vec: bit 0 the words, bit 1 x, bit 2 scale and zero allow 16-byte loads.
template <int BITS, int M>
__global__ void __launch_bounds__(QT_THREADS, 4)
qmm_t_decode(const float* __restrict__ x, const uint32_t* __restrict__ w,
             const float* __restrict__ scale, const float* __restrict__ zero,
             float* __restrict__ out, int d, int k, int gs, int w_ld,
             int w_hs, int s_ld, int s_hs, int vec) {
  using P = Pack<BITS>;
  extern __shared__ __align__(16) float qt_smem[];
  const int dp = (d + 3) & ~3;  // shared row pitch: float4-aligned
  float* xs = qt_smem;          // M x dp
  float* sz = xs + M * dp;      // n_g x 2 x dp: scale, then zero + 2^23
  const int head = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, p = lane & (QT_LANES - 1);
  const int wi = blockIdx.x * QT_WROWS + (tid >> 3);
  x += (size_t)head * M * d;
  out += (size_t)head * M * k;
  w += (size_t)head * w_hs;
  scale += (size_t)head * s_hs;
  zero += (size_t)head * s_hs;
  const int n_words = (k + P::VPW - 1) / P::VPW;
  const int r_lo = blockIdx.x * QT_WROWS * P::VPW;
  const int r_hi = min(r_lo + QT_WROWS * P::VPW, k) - 1;
  const int g_lo = r_lo / gs, n_g = r_hi / gs - g_lo + 1;
  const bool live = wi < n_words;
  const int row0 = wi * P::VPW;
  // this word-row's groups: a, and b from code jb on (jb = VPW: one group;
  // the launcher routes gs < VPW, where a word may span three, elsewhere)
  const int ga = min(row0, k - 1) / gs - g_lo;
  const int gb = min(row0 + P::VPW - 1, k - 1) / gs - g_lo;
  const int jb = gb != ga ? (g_lo + gb) * gs - row0 : P::VPW;

  // first pass's code words in flight before the staging below
  const uint32_t* wrow = w + (size_t)wi * w_ld;
  auto load_words = [&](int c, uint4 (&w4)[4]) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int cc = c + 4 * u;
      if (vec & 1) {
        w4[u] = live && cc < d ? *reinterpret_cast<const uint4*>(wrow + cc)
                               : make_uint4(0u, 0u, 0u, 0u);
      } else {
        uint32_t t[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          t[e] = live && cc + e < d ? wrow[cc + e] : 0u;
        w4[u] = make_uint4(t[0], t[1], t[2], t[3]);
      }
    }
  };
  uint4 w4[4];
  load_words(QT_COLS * p, w4);
  const int d4 = dp / 4;
  if (vec & 2) {  // d = dp: whole float4s
    for (int idx = tid; idx < M * d4; idx += QT_THREADS)
      reinterpret_cast<float4*>(xs)[idx] =
          reinterpret_cast<const float4*>(x)[idx];
  } else {
    for (int idx = tid; idx < M * dp; idx += QT_THREADS) {
      const int i = idx / dp, c = idx % dp;
      xs[idx] = c < d ? x[(size_t)i * d + c] : 0.f;
    }
  }
  if (vec & 4) {
    for (int idx = tid; idx < n_g * d4; idx += QT_THREADS) {
      const int g = idx / d4, c = 4 * (idx - g * d4);
      const size_t src = (size_t)(g_lo + g) * s_ld + c;
      const float4 s4 = *reinterpret_cast<const float4*>(scale + src);
      const float4 z4 = *reinterpret_cast<const float4*>(zero + src);
      *reinterpret_cast<float4*>(sz + (2 * g) * dp + c) = s4;
      *reinterpret_cast<float4*>(sz + (2 * g + 1) * dp + c) =
          make_float4(z4.x + 8388608.f, z4.y + 8388608.f, z4.z + 8388608.f,
                      z4.w + 8388608.f);
    }
  } else {
    for (int idx = tid; idx < n_g * dp; idx += QT_THREADS) {
      const int g = idx / dp, c = idx % dp;
      const size_t src = (size_t)(g_lo + g) * s_ld + c;
      sz[(2 * g) * dp + c] = c < d ? scale[src] : 0.f;
      sz[(2 * g + 1) * dp + c] = (c < d ? zero[src] : 0.f) + 8388608.f;
    }
  }
  __syncthreads();

  float acc[P::VPW][M];
#pragma unroll
  for (int j = 0; j < P::VPW; ++j)
#pragma unroll
    for (int i = 0; i < M; ++i) acc[j][i] = 0.f;
  for (int c0 = 0; c0 < d; c0 += QT_LANES * QT_COLS) {
    const int cl = c0 + QT_COLS * p;  // this lane's first column
    if (c0 > 0) load_words(cl, w4);
    if (live && cl < d) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = cl + 4 * u;
        if (c < d) {  // columns past d hold zero words and zero x
          float4 x4[M];
#pragma unroll
          for (int i = 0; i < M; ++i)
            x4[i] = *reinterpret_cast<const float4*>(xs + i * dp + c);
          const float4* sa = reinterpret_cast<const float4*>(
              sz + (2 * ga) * dp + c);
          const float4* sb = reinterpret_cast<const float4*>(
              sz + (2 * gb) * dp + c);
          qmm_t_sub<BITS, M>(acc, w4[u], sa[0], sa[dp / 4], sb[0],
                             sb[dp / 4], x4, jb);
        }
      }
    }
  }
  // the 8 lanes' partial sums, in a fixed order; lane p stores every 8th
#pragma unroll
  for (int j = 0; j < P::VPW; ++j)
#pragma unroll
    for (int i = 0; i < M; ++i) {
      float v = acc[j][i];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      const int row = row0 + j;
      if ((j * M + i) % QT_LANES == p && live && row < k)
        out[(size_t)i * k + row] = v;
    }
}

// Grid (ceil(k / QTT_BN), ceil(m / QTT_BM), H).  Per 32-column chunk of d
// the block stages x (transposed) and dequantizes the packed words that
// cover its 128 output rows once into shared memory (each code with its own
// row's quant group), for all of its 128 rows of x; thread (ty, tx) then
// adds an 8 x 8 tile of fp32 products (rows ty·4 + {0..3, 64..67} of x,
// output rows tx·4 + {0..3, 64..67}).  The next chunk's x, words and their
// first rows' scales and zeros are loaded into registers while the current
// one is multiplied.
// Each sum runs over d in order, whatever m: a row of y does not depend on
// m.  xvec: x rows allow 16-byte loads.
template <int BITS>
__global__ void __launch_bounds__(QTT_THREADS, 2)
qmm_t_tile(const float* __restrict__ x, const uint32_t* __restrict__ w,
           const float* __restrict__ scale, const float* __restrict__ zero,
           float* __restrict__ out, int m, int d, int k, int gs, int w_ld,
           int w_hs, int s_ld, int s_hs, int xvec) {
  using P = Pack<BITS>;
  // words a thread stages per chunk: the tile's rows span BN / VPW + 2
  constexpr int WPT =
      ((QTT_BN / P::VPW + 2) * QTT_BK + QTT_THREADS - 1) / QTT_THREADS;
  constexpr int XPT = QTT_BM * QTT_BK / QTT_THREADS;  // x values a thread
  __shared__ __align__(16) float xs[QTT_BK][QTT_BM + 4];
  __shared__ __align__(16) float ws[QTT_BK][QTT_BN + 4];
  const int head = blockIdx.z, tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int r0 = blockIdx.x * QTT_BN, m0 = blockIdx.y * QTT_BM;
  x += (size_t)head * m * d;
  out += (size_t)head * m * k;
  w += (size_t)head * w_hs;
  scale += (size_t)head * s_hs;
  zero += (size_t)head * s_hs;
  const int n_words = (k + P::VPW - 1) / P::VPW;
  const int wa = r0 / P::VPW;
  const int wb = min((r0 + QTT_BN + P::VPW - 1) / P::VPW, n_words);
  const int nw = wb - wa;

  // rows of the tile no word covers (past k) read as zero in every chunk
  for (int idx = tid; idx < QTT_BK * QTT_BN; idx += QTT_THREADS) {
    const int c = idx / QTT_BN, r = idx % QTT_BN;
    if (r0 + r >= wb * P::VPW) ws[c][r] = 0.f;
  }

  float xr[XPT];
  uint32_t wr[WPT];
  float sa[WPT], za[WPT];  // the group of the word's first row
  auto fetch = [&](int c0) {
    if (xvec) {  // value (i, 4·c4 + e) of the chunk: f = i·8 + c4
#pragma unroll
      for (int q = 0; q < XPT / 4; ++q) {
        const int f = tid + QTT_THREADS * q, i = f >> 3, c = 4 * (f & 7);
        const float4 v = (m0 + i < m && c0 + c < d)
            ? *reinterpret_cast<const float4*>(x + (size_t)(m0 + i) * d +
                                               c0 + c)
            : make_float4(0.f, 0.f, 0.f, 0.f);
        xr[4 * q] = v.x;
        xr[4 * q + 1] = v.y;
        xr[4 * q + 2] = v.z;
        xr[4 * q + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int q = 0; q < XPT; ++q) {
        const int idx = tid + QTT_THREADS * q;
        const int i = idx / QTT_BK, c = idx % QTT_BK;
        xr[q] = (m0 + i < m && c0 + c < d)
                    ? x[(size_t)(m0 + i) * d + c0 + c] : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < WPT; ++u) {
      const int idx = tid + QTT_THREADS * u;
      const int wl = idx / QTT_BK, col = c0 + idx % QTT_BK;
      const int wi = wa + wl;
      const bool ok = wl < nw && col < d;
      const int ga = min(wi * P::VPW, k - 1) / gs;
      wr[u] = ok ? w[(size_t)wi * w_ld + col] : 0u;
      sa[u] = ok ? scale[(size_t)ga * s_ld + col] : 0.f;
      za[u] = ok ? zero[(size_t)ga * s_ld + col] : 0.f;
    }
  };
  auto stash = [&](int c0) {
    if (xvec) {
#pragma unroll
      for (int q = 0; q < XPT / 4; ++q) {
        const int f = tid + QTT_THREADS * q, i = f >> 3, c = 4 * (f & 7);
#pragma unroll
        for (int e = 0; e < 4; ++e) xs[c + e][i] = xr[4 * q + e];
      }
    } else {
#pragma unroll
      for (int q = 0; q < XPT; ++q) {
        const int idx = tid + QTT_THREADS * q;
        xs[idx % QTT_BK][idx / QTT_BK] = xr[q];
      }
    }
#pragma unroll
    for (int u = 0; u < WPT; ++u) {
      const int idx = tid + QTT_THREADS * u;
      const int wl = idx / QTT_BK, c = idx % QTT_BK;
      if (wl < nw) {
        const int wi = wa + wl, col = c0 + c;
        const int ga = min(wi * P::VPW, k - 1) / gs;
#pragma unroll
        for (int j = 0; j < P::VPW; ++j) {
          const int row = wi * P::VPW + j;
          if (row >= r0 && row < r0 + QTT_BN) {
            float v = 0.f;
            if (col < d && row < k) {
              float s = sa[u], z = za[u];
              if (row >= (ga + 1) * gs) {  // a later group of the word
                const int g = row / gs;
                s = scale[(size_t)g * s_ld + col];
                z = zero[(size_t)g * s_ld + col];
              }
              v = (static_cast<float>((wr[u] >> (j * BITS)) & P::MASK) - z) *
                  s;
            }
            ws[c][row - r0] = v;
          }
        }
      }
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  fetch(0);
  for (int c0 = 0; c0 < d; c0 += QTT_BK) {
    stash(c0);
    __syncthreads();
    if (c0 + QTT_BK < d) fetch(c0 + QTT_BK);  // in flight during the FMAs
#pragma unroll 4
    for (int c = 0; c < QTT_BK; ++c) {
      float a[8], b[8];
      const float4 a0 = *reinterpret_cast<const float4*>(&xs[c][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&xs[c][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&ws[c][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&ws[c][64 + tx * 4]);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = r0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (col < k) out[(size_t)row * k + col] = acc[i][j];
    }
  }
}

struct Strides {
  int w_ld, w_hs, s_ld, s_hs;
};

// The decode's split plan, its one owner: splits along k (the blocks of one
// cluster, at most DEC_MAX_SPLITS) for the least time in a model of waves
// of as many clusters as the card holds at once (max_clusters), each as
// long as its words plus DEC_FIXED_WORDS of fixed cost (staging, the
// cluster's sums), the smaller on a tie; words a split; words a pass (what
// a pass stages must fit its shared memory).  It reads k (n_words, gs), n,
// H and the card, never m.
struct DecPlan {
  int splits, wps, wpp;
};
template <typename Fn>
DecPlan dec_plan(int n_words, int vpw, int gs, long col_blocks,
                 Fn max_clusters) {
  int splits = 1;
  long best = -1;
  for (int sp = 1; sp <= DEC_MAX_SPLITS && sp <= n_words; ++sp) {
    const long active = std::max(1, max_clusters(sp));
    const long waves = (col_blocks + active - 1) / active;
    const long cost = waves * ((n_words + sp - 1) / sp + DEC_FIXED_WORDS);
    if (best < 0 || cost < best) {
      best = cost;
      splits = sp;
    }
  }
  const int wps = (n_words + splits - 1) / splits;
  // a pass of R rows touches at most (R - 1) / gs + 2 quant groups
  const long by_groups = (static_cast<long>(DEC_GROUPS - 2) * gs + 1) / vpw;
  const int wmax = static_cast<int>(
      std::max(1L, std::min(static_cast<long>(DEC_XROWS / vpw), by_groups)));
  const int passes = (wps + wmax - 1) / wmax;
  return {(n_words + wps - 1) / wps, wps, (wps + passes - 1) / passes};
}

template <typename T, int BITS, int M>
int launch_decode(const T* x, const uint32_t* w, const float* scale,
                  const float* zero, T* out, int H, int m, int k, int n,
                  int gs, Strides st, cudaStream_t s) {
  using P = Pack<BITS>;
  auto kern = qmm_decode<T, BITS, M>;
  int err = allow_smem(reinterpret_cast<const void*>(kern), DEC_SMEM);
  if (err != 0) return err;
  const int n_words = (k + P::VPW - 1) / P::VPW;
  const int col_blocks = (n + DEC_BN - 1) / DEC_BN;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(DEC_THREADS);
  cfg.dynamicSmemBytes = DEC_SMEM;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // clusters of each size the card holds at once (asked once a device)
  static int active[64][DEC_MAX_SPLITS + 1] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) dev = 0;
  auto max_clusters = [&](int sp) {
    if (active[dev][sp] == 0) {
      cfg.gridDim = dim3(1, sp, 1);
      attr[0].val.clusterDim.y = sp;
      int c = 0;
      if (cudaOccupancyMaxActiveClusters(&c, kern, &cfg) != cudaSuccess ||
          c < 1) {
        cudaGetLastError();  // not a launch error: plan as if one fits
        c = 1;
      }
      active[dev][sp] = c;
    }
    return active[dev][sp];
  };
  const DecPlan plan =
      dec_plan(n_words, P::VPW, gs,
               static_cast<long>(col_blocks) * H, max_clusters);
  const int w_vec = n % 4 == 0 && st.w_ld % 4 == 0 && st.w_hs % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(w) % 16 == 0;
  cfg.gridDim = dim3(col_blocks, plan.splits, H);
  attr[0].val.clusterDim.y = plan.splits;
  err = static_cast<int>(cudaLaunchKernelEx(
      &cfg, kern, x, w, scale, zero, out, m, k, n, gs, plan.wps, plan.wpp,
      st.w_ld, st.w_hs, st.s_ld, st.s_hs, w_vec));
  return err != 0 ? err : static_cast<int>(cudaGetLastError());
}

// m <= DEC_MAXM: qmm_decode; larger m: qmm_tc
template <typename T, int BITS>
int launch(const void* x, const uint32_t* w, const float* scale,
           const float* zero, void* out, int H, int m, int k, int n, int gs,
           Strides st, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (m <= DEC_MAXM) {  // m 3 runs the M 4 kernel: a row's sums are the same
    switch (m) {
      case 1: return launch_decode<T, BITS, 1>(xt, w, scale, zero, ot, H, m, k, n, gs, st, s);
      case 2: return launch_decode<T, BITS, 2>(xt, w, scale, zero, ot, H, m, k, n, gs, st, s);
      case 3:
      case 4: return launch_decode<T, BITS, 4>(xt, w, scale, zero, ot, H, m, k, n, gs, st, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  constexpr int smem = TcPack<BITS, std::is_same<T, float>::value>::SMEM;
  const int err =
      allow_smem(reinterpret_cast<const void*>(qmm_tc<T, BITS>), smem);
  if (err != 0) return err;
  // rows of x in 16-byte chunks (8 bf16 or 4 fp32 values)
  const int x_vec = k % (16 / sizeof(T)) == 0 &&
                    reinterpret_cast<uintptr_t>(xt) % 16 == 0;
  const int w_vec = st.w_ld % 4 == 0 && st.w_hs % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const int s_vec = st.s_ld % 4 == 0 && st.s_hs % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(scale) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(zero) % 16 == 0;
  const dim3 grid((n + TC_BN - 1) / TC_BN, (m + TC_BM - 1) / TC_BM, H);
  qmm_tc<T, BITS><<<grid, TC_THREADS, smem, s>>>(
      xt, w, scale, zero, ot, m, k, n, gs, st.w_ld, st.w_hs, st.s_ld,
      st.s_hs, x_vec, w_vec, s_vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bits(int bits, const void* x, const uint32_t* w, const float* sc,
                const float* zr, void* out, int H, int m, int k, int n,
                int gs, Strides st, cudaStream_t s) {
  switch (bits) {
    case 2: return launch<T, 2>(x, w, sc, zr, out, H, m, k, n, gs, st, s);
    case 3: return launch<T, 3>(x, w, sc, zr, out, H, m, k, n, gs, st, s);
    case 4: return launch<T, 4>(x, w, sc, zr, out, H, m, k, n, gs, st, s);
    case 8: return launch<T, 8>(x, w, sc, zr, out, H, m, k, n, gs, st, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int BITS, int M>
int launch_t_decode(const float* x, const uint32_t* w, const float* scale,
                    const float* zero, float* out, int H, int d, int k,
                    int gs, Strides st, cudaStream_t s) {
  using P = Pack<BITS>;
  const int n_words = (k + P::VPW - 1) / P::VPW;
  const int dp = (d + 3) & ~3;
  const int max_g = (QT_WROWS * P::VPW - 1) / gs + 2;  // groups of a block
  const size_t smem = sizeof(float) * (M + 2 * (size_t)max_g) * dp;
  const int err =
      allow_smem(reinterpret_cast<const void*>(qmm_t_decode<BITS, M>), smem);
  if (err != 0) return err;
  const int vec =
      (d % 4 == 0 && st.w_ld % 4 == 0 && st.w_hs % 4 == 0 &&
       reinterpret_cast<uintptr_t>(w) % 16 == 0) |
      (d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0) << 1 |
      (d % 4 == 0 && st.s_ld % 4 == 0 && st.s_hs % 4 == 0 &&
       (reinterpret_cast<uintptr_t>(scale) |
        reinterpret_cast<uintptr_t>(zero)) % 16 == 0) << 2;
  const dim3 grid((n_words + QT_WROWS - 1) / QT_WROWS, H);
  qmm_t_decode<BITS, M><<<grid, QT_THREADS, smem, s>>>(
      x, w, scale, zero, out, d, k, gs, st.w_ld, st.w_hs, st.s_ld, st.s_hs,
      vec);
  return static_cast<int>(cudaGetLastError());
}

template <int BITS>
int launch_t(const float* x, const uint32_t* w, const float* scale,
             const float* zero, float* out, int H, int m, int d, int k,
             int gs, int decode, Strides st, cudaStream_t s) {
  if (decode) {  // needs words that span at most two quant groups
    if (gs < Pack<BITS>::VPW) return static_cast<int>(cudaErrorInvalidValue);
    switch (m) {
      case 1: return launch_t_decode<BITS, 1>(x, w, scale, zero, out, H, d, k, gs, st, s);
      case 2: return launch_t_decode<BITS, 2>(x, w, scale, zero, out, H, d, k, gs, st, s);
      case 3: return launch_t_decode<BITS, 3>(x, w, scale, zero, out, H, d, k, gs, st, s);
      case 4: return launch_t_decode<BITS, 4>(x, w, scale, zero, out, H, d, k, gs, st, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const dim3 grid((k + QTT_BN - 1) / QTT_BN, (m + QTT_BM - 1) / QTT_BM, H);
  const int xvec = d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  qmm_t_tile<BITS><<<grid, QTT_THREADS, 0, s>>>(x, w, scale, zero, out, m, d,
                                                k, gs, st.w_ld, st.w_hs,
                                                st.s_ld, st.s_hs, xvec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// m <= 4 selects the decode (qmm_decode, one launch: its split-k sums
// meet in a thread-block cluster), larger m the prefill (qmm_tc on the
// tensor cores, its bf16 or its fp32 form by x's type); kernel.qmm_kernel
// names the same choice.  x (H, m, k), out (H, m, n); codes / scale rows
// w_ld / s_ld apart, heads w_hs / s_hs apart.
extern "C" int qmm_launch(const void* x, int x_bf16, const void* w,
                          const float* scale, const float* zero, void* out,
                          int H, int m, int k, int n, int bits, int gs,
                          int w_ld, int w_hs, int s_ld, int s_hs,
                          void* stream) {
  const uint32_t* wu = static_cast<const uint32_t*>(w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides st{w_ld, w_hs, s_ld, s_hs};
  if (x_bf16)
    return launch_bits<__nv_bfloat16>(bits, x, wu, scale, zero, out, H, m, k,
                                      n, gs, st, s);
  return launch_bits<float>(bits, x, wu, scale, zero, out, H, m, k, n, gs,
                            st, s);
}

// y = x @ Wᵀ: x (H, m, d) fp32, W (ceil(k/vpw), d) words per head with the
// strides of qmm_launch, y (H, m, k) fp32.  decode != 0 selects qmm_t_decode
// (1 <= m <= 4, gs >= vpw; anything else is refused), 0 qmm_t_tile: the
// caller chooses (kernel.qmm_t_kernel, which also counts the launch).
extern "C" int qmm_t_launch(const float* x, const void* w, const float* scale,
                            const float* zero, float* out, int H, int m,
                            int d, int k, int bits, int gs, int decode,
                            int w_ld, int w_hs, int s_ld, int s_hs,
                            void* stream) {
  const uint32_t* wu = static_cast<const uint32_t*>(w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides st{w_ld, w_hs, s_ld, s_hs};
  switch (bits) {
    case 2: return launch_t<2>(x, wu, scale, zero, out, H, m, d, k, gs, decode, st, s);
    case 3: return launch_t<3>(x, wu, scale, zero, out, H, m, d, k, gs, decode, st, s);
    case 4: return launch_t<4>(x, wu, scale, zero, out, H, m, d, k, gs, decode, st, s);
    case 8: return launch_t<8>(x, wu, scale, zero, out, H, m, d, k, gs, decode, st, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
