// Weighted gram for the GPTQ Hessian: out += alpha * (X·r)^T (X·r).
//
// Replaces: weighted_gram_pallas / _gram_kernel in
// src/repro/kernels/gram/kernel.py (the TPU kernel that tiles the (d, d)
// output over a 2-D grid, both triangles, and streams the token axis
// through VMEM along a sequential "arbitrary" grid axis).
//
// What bounds it on the H100: operations.  The product is symmetric, so
// its least work is the triangle, n·d·(d+1) flop (4.21e11 at n 2048,
// d 14336).  Held to 1e-5 of the fp32 product, the cheapest exact route is
// the tensor cores with every fp32 operand split into three bf16 terms and
// the six term products i + j < 3: 2.55 ms at 989 TFLOP/s, against 6.28 ms
// for the triangle at the fp32 pipes' 67 TFLOP/s.  The bytes (x once, the
// (d, d) accumulator read and written) are ~0.5 ms.
//
// Batches: the reference vmaps its Pallas kernel over a leading axis of E
// independent grams (the stacked experts' capacity buffers, (E, n, d) ->
// (E, d, d)).  Here that axis is the grid's second: block (b, e) computes
// tile b of matrix e, whose x, r and out start e times their batch strides
// in; every matrix keeps the tiling, terms and sums below, so a batch of
// one is the 2-D call bit for bit.
//
// Design: one block per 128 x 128 output tile (I, J) with I <= J only;
// the block adds its tile to (I, J) and its transpose to (J, I).  Blocks
// walk the triangle in bands of G_BAND tile rows, column by column inside
// a band, so the blocks resident at once share a few dozen feature panels
// in L2.  Each block loops over the token axis itself (nothing carries
// between blocks, so the TPU's sequential grid axis becomes this loop),
// 64 tokens a stage, in a ring of two stages.  384 threads:
//   - one producer warpgroup loads the stage's fp32 or bf16 x of both
//     feature panels (thread f owns feature f of each panel; a warp reads
//     32 consecutive features of a token, one coalesced row), multiplies
//     by r, splits a = x·r exactly into hi = bf16(a), mid = bf16(a - hi),
//     lo = bf16(a - hi - mid), and stores the three terms transposed,
//     token-contiguous (K-major) in the 128-byte swizzle, so wgmma reads
//     both operands K-major and needs no transpose bits.  Its loads run
//     G_AHEAD quarters of a stage ahead of its splits.  A load that feeds
//     an arithmetic step inside its own branch stalls the warp on every
//     load, so masked loads read a clamped valid address and select zero;
//   - two consumer warpgroups (64 rows of the tile each, all 128 columns)
//     issue per 16-token step the six products hi·hi, hi·mid, mid·hi,
//     hi·lo, lo·hi, mid·mid as wgmma m64n128k16 (a product of two bf16
//     terms is exact).  The tensor core's fp32 sums truncate, and over
//     2048 tokens (768 wgmmas into one accumulator) that alone came to
//     1.6e-5 of the largest entry on the H100, so each stage's 24 wgmmas
//     start from zero and the stage's partial is added to an fp32 sum in
//     registers, in stage order;
//   - named barriers hand the stages over (filled / its wgmmas done).
// The epilogue stages the tile in shared memory and updates out with
// coalesced rows on both sides: out[I][J] += alpha·S and out[J][I] +=
// alpha·Sᵀ.  On a diagonal tile entry (i, j) and (j, i) both take
// S[min][max], so a sum into a zero accumulator is bitwise symmetric.  The
// order of every sum is fixed (no atomics, no split over tokens), so two
// calls give the same bits.  Ragged n and d are masked at the load and at
// the store; a NaN or Inf in x makes the same entries non-finite as in the
// plain product.
//
// What holds it back (the H100, n 2048, d 4096: 0.84 ms, 4x its 0.21 ms
// bound): the one producer warpgroup, a single warp a scheduler.  Without
// the wgmmas it takes 0.75 ms alone; halving its loads saves 0.23 ms of
// that and skipping the split 0.22.  Tried and slower: four features a
// load (16 bytes), 1.19 ms; a deeper register prefetch (it spills at the
// 168-register cap); a second producer warpgroup, registers moved to the
// consumers by setmaxnreg (104 / 152), 0.97 ms with the producers alone at
// 0.86: more warps do not help, so a resource the producer warps share
// (the L1 and shared-memory path that their loads, their stores and the
// wgmmas' operand reads all use) is the likely limit.  Bulk copies of x
// into shared memory (TMA) would take the loads off that path but need
// room that the two 96 KB stages of terms take: the next step.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int G_TILE = 128;   // output tile side (features)
constexpr int G_BK = 64;      // tokens a stage: one 128-byte bf16 row
constexpr int G_TERMS = SPLIT_TERMS;  // hi, mid, lo
constexpr int G_PANEL = G_TILE * G_BK * 2;          // one term of a panel
constexpr int G_STAGE = 2 * G_TERMS * G_PANEL;      // A and B terms: 96 KB
constexpr int G_STAGES = 2;
constexpr int G_CONSUMERS = 256, G_PRODUCERS = 128;
constexpr int G_THREADS = G_CONSUMERS + G_PRODUCERS;
constexpr int G_SMEM = G_STAGES * G_STAGE + 1024;  // + the 1024 alignment
constexpr int G_PITCH = G_TILE + 1;  // epilogue row of floats (odd: the
                                     // transposed reads are conflict-free)
constexpr int G_BAND = 8;            // tile rows of a band of the block order
constexpr int G_EPI = 8;             // epilogue entries a thread loads at once
// quarter stages a producer has in flight ahead of its split (a divisor of
// 4; 4 spills at the 168-register cap and was slower on the H100)
constexpr int G_AHEAD = 2;
// a producer fills feature row f of both panels, a stage in four quarters
// (panel q / 2, chunks of 8 tokens 4·(q % 2) .. + 3)
static_assert(G_PRODUCERS == G_TILE, "one producer per feature row");
static_assert(G_TILE * G_PITCH * 4 <= G_STAGES * G_STAGE, "epilogue tile");
// named barriers (0 is __syncthreads'): stage s filled, stage s free, and
// the consumers among themselves
constexpr int BAR_FULL = 1, BAR_EMPTY = 3, BAR_EPI = 5;

// (I, J) of block b: bands of G_BAND tile rows; inside a band, by column J
// and then row I <= J
__device__ __forceinline__ void tile_of(int b, int tiles, int& I, int& J) {
  for (int r0 = 0;; r0 += G_BAND) {
    const int r1 = min(r0 + G_BAND, tiles), h = r1 - r0;
    const int tri = h * (h + 1) / 2;
    const int cnt = tri + (tiles - r1) * h;
    if (b < cnt) {
      if (b < tri) {  // the band's own triangle: column r0 + jj has jj + 1
        int jj = 0;
        while (b > jj) b -= ++jj;
        J = r0 + jj;
        I = r0 + b;
      } else {
        b -= tri;
        J = r1 + b / h;
        I = r0 + b % h;
      }
      return;
    }
    b -= cnt;
  }
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// d (64 x 128, fp32) += A · B, A (64 x 16) and B (16 x 128) bf16 from
// shared memory, both K-major
// (d = A · B when scale_d is 0)
__device__ __forceinline__ void wgmma_128(float (&d)[64], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// (A term, B term) of product q: hi·hi, hi·mid, mid·hi, hi·lo, lo·hi,
// mid·mid (0 hi, 1 mid, 2 lo; the pairs with i + j < 3)
__device__ constexpr int term_a(int q) {
  return q == 2 || q == 5 ? 1 : q == 4 ? 2 : 0;
}
__device__ constexpr int term_b(int q) {
  return q == 1 || q == 5 ? 1 : q == 3 ? 2 : 0;
}

template <typename T>
__global__ void __launch_bounds__(G_THREADS, 1)
gram_tc(const T* __restrict__ x, const float* __restrict__ r,
        float* __restrict__ out, int n, int d, float alpha,
        long long x_bs, long long r_bs, long long out_bs) {
  extern __shared__ __align__(128) uint8_t smem_raw[];
  // matrix blockIdx.y of the batch
  x += blockIdx.y * x_bs;
  if (r != nullptr) r += blockIdx.y * r_bs;
  out += blockIdx.y * out_bs;
  uint8_t* const ring =
      smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  const int tiles = (d + G_TILE - 1) / G_TILE;
  int I, J;
  tile_of(blockIdx.x, tiles, I, J);
  const int i0 = I * G_TILE, j0 = J * G_TILE;
  const int n_stages = (n + G_BK - 1) / G_BK;
  const int tid = threadIdx.x;

  if (tid >= G_CONSUMERS) {
    // ---------- producer: x·r -> three bf16 terms, K-major ----------
    const int f = tid - G_CONSUMERS;  // feature row of both panels
    const int lane = f % 32;
    const bool ok[2] = {i0 + f < d, j0 + f < d};
    // masked loads read a valid address and select zero, so that a
    // quarter's 32 loads go out together, unbranched
    const T* const xp[2] = {x + min(i0 + f, d - 1), x + min(j0 + f, d - 1)};
    // quarter q of stage s -> v (4 chunks of 8 tokens, x as loaded) and rv
    // (r of the quarter's 32 tokens, one a lane)
    auto load = [&](int s, int q, float (&v)[4][8], float& rv) {
      const int panel = q / 2;
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int t = s * G_BK + 8 * (4 * (q % 2) + c) + e;
          const float a = to_f(xp[panel][(size_t)min(t, n - 1) * d]);
          v[c][e] = t < n && ok[panel] ? a : 0.f;
        }
      const int t = s * G_BK + 32 * (q % 2) + lane;
      const float rt = r != nullptr ? __ldg(r + min(t, n - 1)) : 1.f;
      rv = t < n ? rt : 0.f;
    };
    auto split = [&](int s, int q, const float (&v)[4][8], float rv) {
      uint8_t* const st = ring + (s % 2) * G_STAGE + q / 2 * G_TERMS * G_PANEL;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float a[8];  // x·r, r of token 8c + e of the half from its lane
#pragma unroll
        for (int e = 0; e < 8; ++e)
          a[e] = v[c][e] * __shfl_sync(0xFFFFFFFFu, rv, 8 * c + e);
        uint32_t t3[4][G_TERMS];
#pragma unroll
        for (int e = 0; e < 4; ++e) split3(a[2 * e], a[2 * e + 1], t3[e]);
        const int off = swz128(f, 4 * (q % 2) + c);
#pragma unroll
        for (int k = 0; k < G_TERMS; ++k)
          *reinterpret_cast<uint4*>(st + k * G_PANEL + off) =
              make_uint4(t3[0][k], t3[1][k], t3[2][k], t3[3][k]);
      }
    };
    float v[G_AHEAD][4][8], rv[G_AHEAD];
#pragma unroll
    for (int q = 0; q < G_AHEAD; ++q) load(0, q, v[q], rv[q]);
    for (int s = 0; s < n_stages; ++s) {
      // buffer s % 2 held stage s - 2, whose wgmmas are done
      if (s >= G_STAGES) bar_sync(BAR_EMPTY + s % 2, G_THREADS);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int b = q % G_AHEAD;
        split(s, q, v[b], rv[b]);
        // G_AHEAD quarters ahead, into the next stage near its end
        const int s2 = s + (q + G_AHEAD) / 4, q2 = (q + G_AHEAD) % 4;
        if (s2 < n_stages) load(s2, q2, v[b], rv[b]);
      }
      fence_proxy_async();  // the terms -> visible to wgmma
      bar_arrive(BAR_FULL + s % 2, G_THREADS);
    }
    return;
  }

  // ---------- consumers: six term products on the tensor cores ----------
  // warpgroup wg owns tile rows 64·wg .. +63 and all 128 columns
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  float acc[64], part[64];  // fp32 sum; the stage's tensor-core partial
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;
  for (int s = 0; s < n_stages; ++s) {
    bar_sync(BAR_FULL + s % 2, G_THREADS);  // stage s's terms are in place
    const uint32_t st = smem_u32(ring + (s % 2) * G_STAGE);
    fence_regs(part);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < G_BK / 16; ++j)
#pragma unroll
      for (int q = 0; q < 6; ++q)
        wgmma_128(part,
                  make_desc(st + term_a(q) * G_PANEL + wg * 64 * 128 +
                            j * 32),
                  make_desc(st + (G_TERMS + term_b(q)) * G_PANEL + j * 32),
                  j + q > 0);  // the stage's first product overwrites
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(part);
    // the buffer is free (released only where a later stage waits for it)
    if (s + G_STAGES < n_stages) bar_arrive(BAR_EMPTY + s % 2, G_THREADS);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[i];
  }

  // ---------- epilogue: out[I][J] += alpha·S, out[J][I] += alpha·Sᵀ ------
  bar_sync(BAR_EPI, G_CONSUMERS);  // every wgmma is done: the ring is free
  float* const S = reinterpret_cast<float*>(ring);
  // accumulator element 4j + 2h + e: row 16·warp + lane/4 + 8h, column
  // 8j + 2·(lane % 4) + e of the warpgroup's 64 x 128
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        S[(wg * 64 + 16 * warp + lane / 4 + 8 * h) * G_PITCH + 8 * j +
          2 * (lane % 4) + e] = acc[4 * j + 2 * h + e];
  bar_sync(BAR_EPI, G_CONSUMERS);
  // batches of G_EPI entries a thread: their loads of out go out together
  const bool diag = I == J;
  for (int side = 0; side < (diag ? 1 : 2); ++side) {
    for (int i0b = 0; i0b < G_TILE * G_TILE; i0b += G_EPI * G_CONSUMERS) {
      float o[G_EPI];
#pragma unroll
      for (int u = 0; u < G_EPI; ++u) {
        const int idx = i0b + u * G_CONSUMERS + tid;
        const int a = idx / G_TILE, b = idx % G_TILE;  // out row a, column b
        const int row = (side ? j0 : i0) + a, col = (side ? i0 : j0) + b;
        o[u] = row < d && col < d ? out[(size_t)row * d + col] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < G_EPI; ++u) {
        const int idx = i0b + u * G_CONSUMERS + tid;
        const int a = idx / G_TILE, b = idx % G_TILE;
        const int row = (side ? j0 : i0) + a, col = (side ? i0 : j0) + b;
        // side 0: S[a][b] (S[min][max] on a diagonal tile); side 1: S[b][a]
        const float v = side || (diag && a > b) ? S[b * G_PITCH + a]
                                                : S[a * G_PITCH + b];
        if (row < d && col < d)
          out[(size_t)row * d + col] = fmaf(alpha, v, o[u]);
      }
    }
  }
}

}  // namespace

// x: batch matrices (n, d) fp32 (x_bf16 == 0) or bf16 (x_bf16 == 1),
// row-major, x_bs elements apart; r: batch vectors (n,) fp32, r_bs apart,
// or null (all ones); out: batch (d, d) fp32, out_bs apart, accumulated
// into.  One launch for the whole batch.
extern "C" int gram_launch(const void* x, int x_bf16, const float* r,
                           float* out, int n, int d, float alpha, int batch,
                           long long x_bs, long long r_bs, long long out_bs,
                           void* stream) {
  if (n <= 0 || d <= 0 || batch <= 0) return 0;  // nothing to add
  if (batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (d + G_TILE - 1) / G_TILE;
  const dim3 blocks(tiles * (tiles + 1) / 2, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = allow_smem(
      x_bf16 ? reinterpret_cast<const void*>(gram_tc<__nv_bfloat16>)
             : reinterpret_cast<const void*>(gram_tc<float>),
      G_SMEM);
  if (err != 0) return err;
  if (x_bf16) {
    gram_tc<__nv_bfloat16><<<blocks, G_THREADS, G_SMEM, s>>>(
        static_cast<const __nv_bfloat16*>(x), r, out, n, d, alpha, x_bs,
        r_bs, out_bs);
  } else {
    gram_tc<float><<<blocks, G_THREADS, G_SMEM, s>>>(
        static_cast<const float*>(x), r, out, n, d, alpha, x_bs, r_bs,
        out_bs);
  }
  return static_cast<int>(cudaGetLastError());
}
