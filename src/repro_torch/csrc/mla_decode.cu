// MLA absorbed ("latent") attention on a quantized latent cache for Hopper
// (sm_90a): one-token decode over a flat or block-paged kv8/kv2 cache, and
// the chunked-prefill extend over paged past pages plus the chunk's own fp
// latents.  One kernel template computes both (mla_attend_kernel<DEC>).
//
// Replaces the reference's Pallas kernels in
// src/repro/kernels/flash_decode/kernel.py:
//   mla_flash_decode_pallas        (:438) -> mla_attend_kernel<true>, flat
//                                            (tbl == nullptr), then
//                                            mla_merge_kernel
//   paged_mla_flash_decode_pallas  (:520) -> the same through tbl
//   paged_mla_flash_extend_pallas  (:632) -> mla_own_terms_kernel, then
//                                            mla_attend_kernel<false>
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
// 512, dr 64 a row costs 128 x (576 + 512) multiply-adds against 576
// codes, so both are bound by operations, not bytes.  Counted at the
// cheapest fp32-accurate rate, three bf16 term products at 989 TFLOP/s:
// the decode at B 4, S 8192 ~27.3 GFLOP, 0.0276 ms (the kv8 codes take 5.6
// us to read); the extend at L 256 over 16 past pages ~246 GFLOP, 0.249 ms.
//
// Arithmetic.  Q.K^T and P.V run on the tensor cores (mma.sync m16n8k16,
// bf16 operands, fp32 sums) and keep the fp32 result:
//   - the codes (int8, or the 2-bit levels +-0.25, +-1) are exact in bf16
//     and are widened without their scales into one bf16 tile that serves
//     as K ([c | r]) and as V (its c columns);
//   - the fp32 queries are split once, at the start, into three bf16 terms
//     (hi + mid + lo, ~24 bits) kept in shared memory; each key's c and r
//     scales multiply the fp32 partial scores after the product, and the
//     softmax takes exp2((s - m) log2(e)), the difference rounded first;
//   - each past key's value scale is folded into P, and P is split into
//     three bf16 terms against the exact codes;
//   - the extend's own fp32 latents are split too, once a launch, by a
//     first small kernel (mla_own_terms_kernel), and a tile takes the term
//     pairs whose product is not below 2^-24 of hi.hi (query or P term i
//     against key term j for i + j < 3), one key term at a time;
//   - each k16 step of the scores and each tile of P.V is summed from zero
//     in the tensor core and added in fp32: the unit's truncating
//     accumulation never runs over more than three MMAs (a step's query
//     terms) or six (a tile's P terms and two k16 steps).
//
// A block owns EX_ROWS = 32 query rows, 32 heads of one token (a chunk
// token in the extend, a request in the decode), so its rows share one key
// range and every key tile is loaded and widened once for all of them.
// Keys come in tiles of 32.  12 warps.  The 8 computing warps take, for
// Q.K^T, two row groups of 16 x four quarters of the 576-wide dot product,
// whose partial scores meet in shared memory and are added in a fixed
// order; for the softmax the same row groups x four quarters of the 32
// keys, each row's max and sum and P's terms meeting in shared memory; for
// P.V the same row groups x four quarters of the 512 value columns (a 16 x
// 128 fp32 accumulator a warp).  The 4 producer warps fill two key tiles
// in turn (full / empty mbarriers), so the next tile is widened while this
// one is computed: a past tile's codes arrive in a one-tile ring by bulk
// copies (the TMA unit, completing on an mbarrier; one copy of a page's
// run of c rows and one of r rows), with page ids and scales fetched a tile
// ahead; the own keys' terms go by one bulk copy straight into a key tile.
// The causal edge, the decode's last key and ragged tails are masked by
// select; rows past them and pages not in tbl are never read.  Shared
// memory: the query terms (112 KB at dl 512, dr 64), two key tiles, the
// ring and the partial scores, ~228 KB: one block an SM, so the computing
// warps' phases of a tile (scores, their exchange, softmax, P.V) follow one
// another.  Shared memory, in bytes from the start (ex_layout): the query
// terms, the two key tiles, the ring, the partial scores (P's terms over
// them), the scales, the row maxima and sums, the mbarriers.
//
// Extend.  Grid (ceil(H / 32), L): block (hb, y) takes chunk token L - 1 -
// y (the longest causal rows first), its past pages through tbl, then the
// chunk's own keys up to its token; it writes normalized rows.
//
// Decode.  Grid (ceil(H / 32), splits, B).  A request's keys 0 .. pos are
// cut into splits of whole 32-key tiles, ceil(n / DEC_SPLITS) tiles each
// for its n live ones (dec_plan): a function of its pos alone, so that a
// flat and a paged call (at any page), and a request alone or in any
// batch, walk the same tiles and give the same bits.  Long caches take
// long splits and short ones short, at most DEC_SPLITS = 8 a request: at
// B 4 x H 128 that is 128 blocks on the 132 SMs at S 8192 (32 tiles each)
// and 96 at the engine's ~575 keys (3 tiles each), and the split partials
// stay 8 rows a head.  The grid is sized from the cache's or the table's
// length alone; a block past its request's splits exits at once.  A block
// writes its rows' raw (acc, m, l); mla_merge_kernel adds a request's
// splits in order (deterministic).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int EX_ROWS = 32;      // query rows a block: 32 heads of one token
constexpr int EX_KEYS = 32;      // keys a tile
constexpr int EX_THREADS = 256;  // 8 warps: 2 row groups x 4 quarters
constexpr int EX_PRODUCERS = 128;  // and four producer warps
constexpr int EX_BLOCK = EX_THREADS + EX_PRODUCERS;
constexpr int EX_TERMS = SPLIT_TERMS;  // bf16 terms of an fp32 operand
constexpr int EX_MAX_W = 576;    // padded latent + rope width
constexpr int EX_NQ = 16;        // 8-column value tiles a warp (128 columns)
constexpr int EX_SPP = 40;       // partial-score row pitch (floats)
constexpr int EX_PP = 80;        // P term row pitch (bytes): 32 keys + 16
constexpr int DEC_SPLITS = 8;    // a decode request's splits, at most
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.44269504088896341f;

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Bulk copies (the TMA unit: one thread asks, the bytes land without
// registers) completing on an mbarrier of shared memory.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)), "r"(parity) : "memory");
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)), "l"(src), "r"(bytes),
      "r"(smem_u32(bar)) : "memory");
}
// Four 8x8 bf16 matrices from shared memory (lane l gives the address of
// row l % 8 of matrix l / 8), plain or transposed.
__device__ __forceinline__ void ldsm4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm4_t(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a.b: m16n8k16, A row-major, B column-major, bf16, fp32 sums.
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An int8 code word (4 codes) -> two bf16x2 words, exact: byte ^ 0x80 under
// exponent 2^23 is 2^23 + 128 + code; the difference has at most 8
// significant bits, so its top 16 bits are its bf16.  Codes at or past
// `valid` read as zero.
__device__ __forceinline__ uint2 i8x4_bf16(uint32_t w, int valid) {
  const uint32_t x = w ^ 0x80808080u;
  uint32_t u[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    u[k] = __float_as_uint(
        __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7540 + k)) -
        8388736.f);
  const uint2 b = make_uint2(__byte_perm(u[0], u[1], 0x7632),
                             __byte_perm(u[2], u[3], 0x7632));
  if (valid >= 4) return b;
  return make_uint2(valid >= 2 ? b.x : valid == 1 ? b.x & 0xFFFFu : 0u,
                    valid == 3 ? b.y & 0xFFFFu : 0u);
}

// Codes 2k and 2k + 1 of a word of 2-bit codes -> the bf16x2 bits of their
// levels {-1, -0.25, +0.25, +1}: one byte-permute picks each level's top
// byte (0xBF, 0xBE, 0x3E, 0x3F) and the low bytes 0x80.
__device__ __forceinline__ uint32_t lvl2x2_bf16(uint32_t w, int k) {
  const uint32_t t = w >> (4 * k);
  const uint32_t sel = 0x0404u | (t & 3u) << 4 | (t & 12u) << 10;
  return __byte_perm(0x3F3EBEBFu, 0x80808080u, sel);
}

// Shared-memory layout of mla_attend_kernel, in bytes from the start; the
// kernel and the launchers carve it with the same function.
struct ExLayout {
  int dlp, drp, dw, qp, cbp, rbp;
  int qs, kb, ring, spart, scl, rows, bar, total;
};

__host__ __device__ inline ExLayout ex_layout(int dl, int dr, int cb, int rb) {
  ExLayout g;
  g.dlp = (dl + 15) & ~15;
  g.drp = (dr + 15) & ~15;
  g.dw = g.dlp + g.drp;
  g.qp = 2 * g.dw + 16;  // an odd number of 16-byte units: ldmatrix rows
                         // fall on distinct banks
  g.cbp = (cb + 15) & ~15;  // the ring: a block of c rows, then of r rows
  g.rbp = (rb + 15) & ~15;
  g.qs = 0;
  g.kb = g.qs + EX_TERMS * EX_ROWS * g.qp;      // two key tiles
  g.ring = g.kb + 2 * EX_KEYS * g.qp;          // one tile of codes
  g.spart = g.ring + EX_KEYS * (g.cbp + g.rbp);
  g.scl = g.spart + 4 * EX_ROWS * EX_SPP * 4;  // a key tile's scales
  g.rows = g.scl + 2 * 3 * EX_KEYS * 4;        // row maxima, row sums
  g.bar = g.rows + 2 * 4 * EX_ROWS * 4;        // 8-byte aligned
  g.total = g.bar + 5 * 8;
  return g;
}

// A decode request's splits (dec_plan): its last visible key lim (pos, at
// most max_key: the flat cache's last row or the table's last key), its n
// = lim / EX_KEYS + 1 live key tiles in runs of tps = ceil(n / DEC_SPLITS)
// tiles (1 while n <= DEC_SPLITS); returns the number of runs.  While pos
// <= max_key, a function of pos alone.
__host__ __device__ inline int dec_plan(int pos, int max_key, int* lim,
                                        int* tps) {
  *lim = pos < max_key ? pos : max_key;
  const int n = *lim < 0 ? 0 : *lim / EX_KEYS + 1;
  *tps = n > DEC_SPLITS ? (n + DEC_SPLITS - 1) / DEC_SPLITS : 1;
  return (n + *tps - 1) / *tps;
}

// Grid (Lp).  The chunk's own fp32 latents [c | r] -> their three bf16
// terms (split3), rows padded with zeros to the key tile's row of pw
// values (dl and dr each padded to 16, plus 8) and to Lp =
// EX_KEYS·ceil(L / EX_KEYS) rows: terms (3, Lp, pw), a tile of 32 rows one
// bulk copy into the extend's key tile.  nz (2, Lp / EX_KEYS), zeroed by
// the caller: 1 where terms 1 / 2 of a tile hold a non-zero value (never,
// for latents that are bf16 values, as the model's are: the extend then
// skips those terms, whose products are exact zeros).
__global__ void __launch_bounds__(128) mla_own_terms_kernel(
    const float* __restrict__ c_new, const float* __restrict__ r_new,
    __nv_bfloat16* __restrict__ terms, int* __restrict__ nz, int L, int Lp,
    int dl, int dr, int dlp, int pw) {
  const int key = blockIdx.x;
  bool nz1 = false, nz2 = false;
  for (int d = 2 * threadIdx.x; d < pw; d += 2 * blockDim.x) {
    float x0 = 0.f, x1 = 0.f;
    if (key < L) {
      if (d < dlp) {
        if (d < dl) x0 = c_new[(size_t)key * dl + d];
        if (d + 1 < dl) x1 = c_new[(size_t)key * dl + d + 1];
      } else {
        const int e = d - dlp;
        if (e < dr) x0 = r_new[(size_t)key * dr + e];
        if (e + 1 < dr) x1 = r_new[(size_t)key * dr + e + 1];
      }
    }
    uint32_t t3[EX_TERMS];
    split3(x0, x1, t3);
#pragma unroll
    for (int k = 0; k < EX_TERMS; ++k)
      *reinterpret_cast<uint32_t*>(terms + ((size_t)k * Lp + key) * pw + d) =
          t3[k];
    nz1 |= (t3[1] & 0x7FFF7FFFu) != 0;  // -0 is a zero term too
    nz2 |= (t3[2] & 0x7FFF7FFFu) != 0;
  }
  nz1 = __syncthreads_or(nz1);
  nz2 = __syncthreads_or(nz2);
  if (threadIdx.x == 0) {
    if (nz1) atomicOr(&nz[key / EX_KEYS], 1);
    if (nz2) atomicOr(&nz[Lp / EX_KEYS + key / EX_KEYS], 1);
  }
}

// The most splits a decode request over `keys` cache rows takes.
__host__ __device__ inline int dec_max_splits(long long keys) {
  const long long n = (keys + EX_KEYS - 1) / EX_KEYS;
  return n < DEC_SPLITS ? (int)n : DEC_SPLITS;
}

// The arguments of mla_attend_kernel.  Queries (tokens, H, dl | dr) fp32,
// the attention scale folded in (a token: a chunk token in the extend, a
// request in the decode).  Pools as the codec stores them: cq / rq code
// rows of cb / rb bytes, cs / rs bf16 scales, one a `chunk` rows.  unit: 16
// when every code row start allows bulk copies, else the cp.async size (4;
// 1 for plain byte copies).
struct AttendArgs {
  const float* ql;
  const float* qr;
  const __nv_bfloat16* own;  // extend: the own latents' terms and their
  const int* own_nz;         // non-zero flags (mla_own_terms_kernel)
  const char* cq;
  const __nv_bfloat16* cs;
  const char* rq;
  const __nv_bfloat16* rs;
  const int* tbl;  // extend (n_past,) full pages; decode (B, n_tiles), or
                   // nullptr for a flat cache (B, S, ·), scales (B, SR)
  const int* pos;  // decode (B,): each request's last key
  float* out;      // extend (L, H, dl) normalized; decode the split rows'
                   // raw acc (B, H, n_split, dl)
  float* part_m;   // decode (B, H, n_split): their max and sum
  float* part_l;
  int H, dl, dr, page, chunk, kv_bits, cb, rb, unit;
  int L, n_past;                // extend
  int S, SR, n_tiles, n_split;  // decode (page: the page or flat tile)
};

// Warps 0-7 compute; warps 8-11 produce the key tiles the computing warps
// consume, in a fixed sequence of stages: one a past tile (its codes
// widened into a key tile, its scales beside it), and in the extend 2n - 1
// an own tile with n key terms that are not all zero (terms 0, 1, 2, then
// 1, 0 for P.V at n = 3; the last term serves the first P.V round too).
// Stage s fills key tile s % 2; full[b] / empty[b] hand tile b over and
// back, so the producers widen the next tile while the others compute on
// this one.
template <bool DEC>
__global__ void __launch_bounds__(EX_BLOCK, 1) mla_attend_kernel(
    const AttendArgs a) {
  extern __shared__ __align__(16) char smem[];
  const int H = a.H, dl = a.dl, dr = a.dr, chunk = a.chunk;
  const int kv_bits = a.kv_bits, cb = a.cb, rb = a.rb;
  const ExLayout g = ex_layout(dl, dr, cb, rb);
  char* qs = smem + g.qs;      // [term][row][dw] bf16, pitch qp
  char* kbs = smem + g.kb;     // [tile][key][dw] bf16 (one term), pitch qp
  char* ring = smem + g.ring;  // [c rows | r rows], pitches cbp, rbp
  float* spart = reinterpret_cast<float*>(smem + g.spart);  // [q][row][key]
  float* scl = reinterpret_cast<float*>(smem + g.scl);  // [tile][3][key]
  // P's bf16 terms, [term][row][key] at a pitch of EX_PP bytes, over the
  // partial scores (read before P is written, written after P is read)
  char* ps = smem + g.spart;
  float* rmax = reinterpret_cast<float*>(smem + g.rows);  // [quarter][row]
  float* rsum = rmax + 4 * EX_ROWS;                       // [quarter][row]
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + g.bar);
  uint64_t* full = bars;       // [tile]: filled (producers' arrival, bytes)
  uint64_t* empty = bars + 2;  // [tile]: consumed (one arrival a warp)
  uint64_t* ring_bar = bars + 4;  // the codes of a past tile landed

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool producer = tid >= EX_THREADS;
  const int ptid = tid - EX_THREADS;  // producers: 0 .. EX_PRODUCERS - 1
  const int rg = warp & 1, qd = warp >> 1;  // row group, quarter
  const int gid = lane >> 2, tq = lane & 3;
  const int h0 = blockIdx.x * EX_ROWS;
  // the block's query token and its past keys key0 .. key0 + np_keys - 1:
  // key k is row k % page of page tbl[k / page] (flat: of the request's
  // rows, one page of S), its scale row pid·spp + k % page / chunk
  int tok, key0, np_keys, split = 0, page = a.page, spp = a.page / chunk;
  const int* tbl = a.tbl;
  if constexpr (DEC) {
    tok = blockIdx.z;
    split = blockIdx.y;
    int lim, tps;
    const int max_key = tbl ? a.n_tiles * a.page - 1 : a.S - 1;
    if (split >= dec_plan(a.pos[tok], max_key, &lim, &tps)) return;
    key0 = split * tps * EX_KEYS;
    np_keys = min(key0 + tps * EX_KEYS, lim + 1) - key0;
    if (tbl) {
      tbl += (size_t)tok * a.n_tiles;
    } else {
      page = a.S;
      spp = a.SR;
    }
  } else {
    tok = a.L - 1 - blockIdx.y;  // the longest causal rows first
    key0 = 0;
    np_keys = a.n_past * a.page;
  }
  const int n_pt = (np_keys + EX_KEYS - 1) / EX_KEYS;
  const int n_t = DEC ? n_pt : n_pt + tok / EX_KEYS + 1;
  const int tile_bytes = EX_KEYS * g.qp;
  const int Lp = (a.L + EX_KEYS - 1) / EX_KEYS * EX_KEYS;
  // own tile o's key terms, in order (term 0 always; 1 and 2 where not all
  // zero): n of them, then its stages are those terms for Q.K^T and the
  // same but the last again in reverse for P.V, 2n - 1 in all
  auto own_terms = [&](int o, int (&term)[EX_TERMS]) {
    int n = 0;
    term[n++] = 0;
    if (a.own_nz[o]) term[n++] = 1;
    if (a.own_nz[Lp / EX_KEYS + o]) term[n++] = 2;
    return n;
  };

  if (tid == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(&full[b], 1);
      mbar_init(&empty[b], EX_THREADS / 32);
    }
    mbar_init(ring_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the last block-wide barrier: the roles part here

  if (producer) {
    const bool meta = ptid < 32;  // the first producer warp: lane = key row
    const bool bulk = a.unit == 16;
    // key row `lane` of a past tile: its page id and scales (bf16, widened
    // only when put), loaded a tile ahead of their use
    struct Meta {
      int pid;
      __nv_bfloat16 sc, sr;
    };
    auto load_meta = [&](int t) {
      const int key = t * EX_KEYS + lane;
      Meta m{0, __float2bfloat16(0.f), __float2bfloat16(0.f)};
      if (key < np_keys) {
        const int k = key0 + key;
        m.pid = tbl ? tbl[k / page] : tok;
        const size_t srow = (size_t)m.pid * spp + k % page / chunk;
        m.sc = a.cs[srow];
        m.sr = a.rs[srow];
      }
      return m;
    };
    Meta cur{0, __float2bfloat16(0.f), __float2bfloat16(0.f)}, nxt = cur;
    // past tile t's c and r code rows -> the ring (first producer warp;
    // pid: the page id of key row lane)
    auto issue = [&](int t, int pid) {
      const int k = key0 + t * EX_KEYS;
      const int n_live = min(EX_KEYS, np_keys - t * EX_KEYS);
      if (bulk) {  // lane i: the tile's keys on its (i+1)-th page, a run of
                   // contiguous c rows and one of r rows (cbp = cb)
        const int p0 = k / page, runs = (k + n_live - 1) / page - p0 + 1;
        const int ra = max(k, (p0 + lane) * page);
        const int rb_ = min(k + n_live, (p0 + lane + 1) * page);
        const int run_pid = __shfl_sync(0xffffffffu, pid, min(ra - k, 31));
        fence_proxy_async();
        if (lane == 0) mbar_expect(ring_bar, n_live * (cb + rb));
        __syncwarp();
        if (lane < runs) {
          const long long row = (long long)run_pid * page + ra % page;
          bulk_copy(ring + (ra - k) * cb, a.cq + row * cb, (rb_ - ra) * cb,
                    ring_bar);
          bulk_copy(ring + EX_KEYS * cb + (ra - k) * rb, a.rq + row * rb,
                    (rb_ - ra) * rb, ring_bar);
        }
      } else if (lane < n_live) {  // lane r: key row r, unit by unit
        const long long row = (long long)pid * page + (k + lane) % page;
        const char* src[2] = {a.cq + row * cb, a.rq + row * rb};
        char* dst[2] = {ring + lane * g.cbp,
                        ring + EX_KEYS * g.cbp + lane * g.rbp};
        const int bytes[2] = {cb, rb};
        for (int m = 0; m < 2; ++m)
          for (int u = 0; u < bytes[m]; u += a.unit) {
            if (a.unit == 4)
              cp_async4(dst[m] + u, src[m] + u);
            else
              dst[m][u] = src[m][u];
          }
        cp_async_commit();
      }
    };
    // the ring -> key tile kbuf, exact, no scale; keys past the live ones
    // and columns past dl / dr zero.  Producer thread ptid takes key row
    // ptid / 4 and its 16-dim items ptid % 4 + 4k (a row has dw / 16 <=
    // 36), five ring loads in flight at a time
    const int nq16 = g.dw / 16, ncq16 = g.dlp / 16;
    auto widen = [&](int t, char* kbuf) {
      const int r = ptid >> 2, n_live = min(EX_KEYS, np_keys - t * EX_KEYS);
      const char* src_c = ring + r * g.cbp;
      const char* src_r = ring + EX_KEYS * g.cbp + r * g.rbp;
      char* dst = kbuf + r * g.qp;
#pragma unroll 1
      for (int k0 = 0; k0 < EX_MAX_W / 64; k0 += 5) {
        uint4 raw[5];
        int valid[5];
#pragma unroll
        for (int k = 0; k < 5; ++k) {
          const int q = (ptid & 3) + 4 * (k0 + k);
          const bool lat = q < ncq16;
          const int d = lat ? 16 * q : 16 * (q - ncq16);  // dim in c or r
          valid[k] = q < nq16 && r < n_live ? (lat ? dl : dr) - d : 0;
          raw[k] = make_uint4(0u, 0u, 0u, 0u);
          if (valid[k] > 0) {
            const char* src = lat ? src_c : src_r;
            if (kv_bits == 8)
              raw[k] = *reinterpret_cast<const uint4*>(src + d);
            else
              raw[k].x = *reinterpret_cast<const uint32_t*>(src + d / 4);
          }
        }
#pragma unroll
        for (int k = 0; k < 5; ++k) {
          const int q = (ptid & 3) + 4 * (k0 + k);
          if (q < nq16) {
            uint32_t u[8];
            if (kv_bits == 8) {
              const uint32_t w[4] = {raw[k].x, raw[k].y, raw[k].z, raw[k].w};
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const uint2 b = i8x4_bf16(w[i], valid[k] - 4 * i);
                u[2 * i] = b.x;
                u[2 * i + 1] = b.y;
              }
            } else {
#pragma unroll
              for (int i = 0; i < 8; ++i) {
                const uint32_t v = lvl2x2_bf16(raw[k].x, i);
                u[i] = 2 * i + 1 < valid[k] ? v
                       : 2 * i < valid[k]   ? v & 0xFFFFu : 0u;
              }
            }
            uint4* o = reinterpret_cast<uint4*>(dst + 32 * q);
            o[0] = make_uint4(u[0], u[1], u[2], u[3]);
            o[1] = make_uint4(u[4], u[5], u[6], u[7]);
          }
        }
      }
    };

    if (n_pt > 0 && meta) {
      cur = load_meta(0);
      issue(0, cur.pid);
      if (n_pt > 1) nxt = load_meta(1);
    }
    int s = 0;  // stage
    for (int t = 0; t < n_t; ++t) {
      if (t < n_pt) {
        const int b = s & 1;
        if (s >= 2) mbar_wait(&empty[b], ((s - 2) >> 1) & 1);
        if (bulk) {
          mbar_wait(ring_bar, t & 1);
        } else {
          if (meta) cp_async_wait_all();
          bar_sync(2, EX_PRODUCERS);
        }
        widen(t, kbs + b * tile_bytes);
        if (meta) {  // c and r for the scores, c again for the values
          float* st = scl + b * 3 * EX_KEYS;
          const float c = __bfloat162float(cur.sc);
          st[lane] = c;
          st[EX_KEYS + lane] = __bfloat162float(cur.sr);
          st[2 * EX_KEYS + lane] = c;
        }
        bar_sync(2, EX_PRODUCERS);  // the ring read, tile b written
        if (ptid == 0) mbar_arrive(&full[b]);
        if (t + 1 < n_pt && meta) {
          issue(t + 1, nxt.pid);
          cur = nxt;
          if (t + 2 < n_pt) nxt = load_meta(t + 2);
        }
        ++s;
      } else if constexpr (!DEC) {  // own keys j0 .. j0 + 31: their terms,
                                    // then back
        const int j0 = (t - n_pt) * EX_KEYS;
        int terms[EX_TERMS];
        const int n = own_terms(t - n_pt, terms);
        for (int i = 0; i < 2 * n - 1; ++i, ++s) {
          const int b = s & 1, term = terms[i < n ? i : 2 * n - 2 - i];
          if (ptid == 0) {
            if (s >= 2) mbar_wait(&empty[b], ((s - 2) >> 1) & 1);
            fence_proxy_async();
            mbar_expect(&full[b], tile_bytes);
            bulk_copy(kbs + b * tile_bytes,
                      a.own + ((size_t)term * Lp + j0) * (g.qp / 2),
                      tile_bytes, &full[b]);
          }
        }
      }
    }
    return;
  }

  // ---------------------------------------------------- computing warps
  const int nks = g.dw / 16, ncs = g.dlp / 16;  // k16 steps: all, latent
  const int kq = (nks + 3) / 4;                 // k16 steps a quarter
  const int s_lo = min(qd * kq, nks), s_hi = min(s_lo + kq, nks);
  const int ntv = g.dlp / 8;                    // 8-column value tiles
  const int nqv = 2 * ((ntv + 7) / 8);          // a quarter's, even
  const int v0 = qd * nqv;                      // this warp's first

  // four fp32 values of a [c | r] row padded to dlp + drp: dims 4q .. 4q + 3
  // (c_row dl wide, r_row dr wide), zero past dl / dr; one 16-byte load
  // when the widths and row starts allow (vec)
  const bool vec =
      dl % 4 == 0 && dr % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(a.ql) | reinterpret_cast<uintptr_t>(a.qr)) &
       15) == 0;
  auto load4 = [&](const float* c_row, const float* r_row, int q) {
    const bool lat = 4 * q < g.dlp;
    const int d = lat ? 4 * q : 4 * q - g.dlp, n = lat ? dl : dr;
    const float* p = lat ? c_row : r_row;
    if (vec)
      return d < n ? *reinterpret_cast<const float4*>(p + d)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    return make_float4(d < n ? p[d] : 0.f, d + 1 < n ? p[d + 1] : 0.f,
                       d + 2 < n ? p[d + 2] : 0.f, d + 3 < n ? p[d + 3] : 0.f);
  };
  // queries -> three bf16 terms; rows past H and columns past dl / dr zero.
  // Thread tid takes row tid / 8 and its 4-dim items tid % 8 + 8k, six
  // loads in flight at a time
  {
    const int r = tid >> 3, h = h0 + r;
    const bool ok = h < H;
    const size_t qrow = (size_t)tok * H + (ok ? h : 0);
    const float* c_row = a.ql + qrow * dl;
    const float* r_row = a.qr + qrow * dr;
    const int nq4 = g.dw / 4;
#pragma unroll 1
    for (int k0 = 0; k0 < EX_MAX_W / 32; k0 += 6) {
      float4 v[6];
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        const int q = (tid & 7) + 8 * (k0 + k);
        v[k] = ok && q < nq4 ? load4(c_row, r_row, q)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        const int q = (tid & 7) + 8 * (k0 + k);
        if (q < nq4) {
          uint32_t ta[3], tb[3];
          split3(v[k].x, v[k].y, ta);
          split3(v[k].z, v[k].w, tb);
#pragma unroll
          for (int i = 0; i < EX_TERMS; ++i)
            *reinterpret_cast<uint2*>(qs + (i * EX_ROWS + r) * g.qp + 8 * q) =
                make_uint2(ta[i], tb[i]);
        }
      }
    }
  }
  bar_sync(1, EX_THREADS);

  // ldmatrix lane offsets: A (query rows of this warp), B for the scores
  // (keys x dims of a key tile), B for the values (keys x columns, trans)
  const int lr = (lane & 7) + ((lane >> 3) & 1) * 8;  // row of matrix l / 8
  const char* qa_base = qs + (16 * rg + lr) * g.qp + (lane >> 4) * 16;
  const int kq_off =
      ((lane & 7) + (lane >> 4) * 8) * g.qp + ((lane >> 3) & 1) * 16;
  const int kv_off = lr * g.qp + (lane >> 4) * 16;

  // scores of this warp's k16 steps [s0, s1) against key tile kbuf for
  // query terms < nq added to ra (4 key tiles of 8): each step's products
  // summed from zero in the tensor core, then added in fp32
  auto qk = [&](float (&ra)[4][4], const char* kbuf, int s0, int s1,
                int nq) {
    const char* kb_qk = kbuf + kq_off;
#pragma unroll 1
    for (int s = s0; s < s1; ++s) {
      uint32_t b[2][4];
      ldsm4(b[0], kb_qk + 32 * s);
      ldsm4(b[1], kb_qk + 16 * g.qp + 32 * s);
      float st[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = 0.f;
#pragma unroll
      for (int k = EX_TERMS - 1; k >= 0; --k) {
        if (k < nq) {
          uint32_t af[4];
          ldsm4(af, qa_base + k * EX_ROWS * g.qp + 32 * s);
#pragma unroll
          for (int n = 0; n < 4; ++n)
            mma_bf16(st[n], af, b[n >> 1][2 * (n & 1)],
                     b[n >> 1][2 * (n & 1) + 1]);
        }
      }
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) ra[n][e] += st[n][e];
    }
  };

  // running state: rows gid (a) and gid + 8 (b) of this warp's 16: the max
  // and the denominator
  float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.f, l_b = 0.f;
  float acc[EX_NQ][4];
#pragma unroll
  for (int n = 0; n < EX_NQ; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  // P (three terms) . key tile kbuf's value columns for P terms < np,
  // summed from zero a 4-tile group at a time, then acc = acc * alpha +
  // tile (first) or acc + tile
  auto pv = [&](const uint32_t (&pa)[2][EX_TERMS][4], const char* kbuf,
                int np, bool first, float al_a, float al_b) {
    const char* kb_pv = kbuf + kv_off;
#pragma unroll
    for (int n0 = 0; n0 < EX_NQ; n0 += 4) {
      if (n0 < nqv && v0 + n0 < ntv) {
        float o[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
          for (int p2 = 0; p2 < 4; p2 += 2) {
            if (n0 + p2 < nqv && v0 + n0 + p2 < ntv) {
              uint32_t b[4];
              ldsm4_t(b, kb_pv + 16 * ks * g.qp + 16 * (v0 + n0 + p2));
#pragma unroll
              for (int k = EX_TERMS - 1; k >= 0; --k) {
                if (k < np) {
                  mma_bf16(o[p2], pa[ks][k], b[0], b[1]);
                  mma_bf16(o[p2 + 1], pa[ks][k], b[2], b[3]);
                }
              }
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float* ac = acc[n0 + i];
          if (first) {
            ac[0] = fmaf(ac[0], al_a, o[i][0]);
            ac[1] = fmaf(ac[1], al_a, o[i][1]);
            ac[2] = fmaf(ac[2], al_b, o[i][2]);
            ac[3] = fmaf(ac[3], al_b, o[i][3]);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) ac[e] += o[i][e];
          }
        }
      }
    }
  };
  // stage st's key tile: wait until filled; give it back when done
  auto tile_of = [&](int st) {
    mbar_wait(&full[st & 1], (st >> 1) & 1);
    return kbs + (st & 1) * tile_bytes;
  };
  auto release = [&](int st) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st & 1]);
  };

  int s = 0;  // stage
#pragma unroll 1
  for (int t = 0; t < n_t; ++t) {
    const bool past = DEC || t < n_pt;
    const int j0 = past ? t * EX_KEYS : (t - n_pt) * EX_KEYS;
    const int n_live = min(EX_KEYS, (past ? np_keys : a.L) - j0);
    // this warp's partial scores, c and r steps apart (their scales differ)
    float tc[4][4], tr[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) tc[n][e] = tr[n][e] = 0.f;
    auto qk_round = [&](const char* kbuf, int nq) {
      qk(tc, kbuf, s_lo, min(s_hi, ncs), nq);
      qk(tr, kbuf, max(s_lo, ncs), s_hi, nq);
    };

    const char* kt;  // the key tile P.V starts on
    int terms[EX_TERMS], n = 1;  // own: the key terms (past: the codes)
    if (past) {
      kt = tile_of(s);
      qk_round(kt, EX_TERMS);  // exact codes: every query term once
    } else {
      // fp32 own keys, split too: query term i x key term j for i + j < 3
      n = own_terms(t - n_pt, terms);
#pragma unroll 1
      for (int i = 0; i < n; ++i) {
        kt = tile_of(s + i);
        qk_round(kt, EX_TERMS - terms[i]);
        if (i < n - 1) release(s + i);
      }
    }

    // scale, publish this quarter's partial scores
    bar_sync(1, EX_THREADS);  // the last tile's partial scores are read
    const float* sct = scl + (s & 1) * 3 * EX_KEYS;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int key = 8 * n + 2 * tq;
      const float c0 = past ? sct[key] : 1.f;
      const float c1 = past ? sct[key + 1] : 1.f;
      const float r0 = past ? sct[EX_KEYS + key] : 1.f;
      const float r1 = past ? sct[EX_KEYS + key + 1] : 1.f;
      float* sp = spart + (qd * EX_ROWS + 16 * rg + gid) * EX_SPP + key;
      *reinterpret_cast<float2*>(sp) =
          make_float2(c0 * tc[n][0] + r0 * tr[n][0],
                      c1 * tc[n][1] + r1 * tr[n][1]);
      *reinterpret_cast<float2*>(sp + 8 * EX_SPP) =
          make_float2(c0 * tc[n][2] + r0 * tr[n][2],
                      c1 * tc[n][3] + r1 * tr[n][3]);
    }
    bar_sync(1, EX_THREADS);

    // streaming softmax, each warp over key tile qd (8 keys) of its 16
    // rows: the four quarters' partials in order, masked by select; each
    // row's max and sum meet through shared memory in a fixed order, P's
    // terms too, so the four warps of a row group agree
    const int key = 8 * qd + 2 * tq;  // this lane's two keys
    float sc4[4];  // rows a, a, b, b x keys key, key + 1
    bool live[4];
    {
      float2 xa = make_float2(0.f, 0.f), xb = make_float2(0.f, 0.f);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float* sp = spart + (q * EX_ROWS + 16 * rg + gid) * EX_SPP + key;
        const float2 ya = *reinterpret_cast<const float2*>(sp);
        const float2 yb = *reinterpret_cast<const float2*>(sp + 8 * EX_SPP);
        xa.x += ya.x;
        xa.y += ya.y;
        xb.x += yb.x;
        xb.y += yb.y;
      }
      live[0] = live[2] = key < n_live && (past || j0 + key <= tok);
      live[1] = live[3] = key + 1 < n_live && (past || j0 + key + 1 <= tok);
      sc4[0] = live[0] ? xa.x : NEG_INF;
      sc4[1] = live[1] ? xa.y : NEG_INF;
      sc4[2] = live[2] ? xb.x : NEG_INF;
      sc4[3] = live[3] ? xb.y : NEG_INF;
    }
    const int row_a = 16 * rg + gid, row_b = row_a + 8;
    float mx_a = fmaxf(sc4[0], sc4[1]), mx_b = fmaxf(sc4[2], sc4[3]);
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o));
    }
    if (tq == 0) {
      rmax[qd * EX_ROWS + row_a] = mx_a;
      rmax[qd * EX_ROWS + row_b] = mx_b;
    }
    bar_sync(1, EX_THREADS);  // every quarter's maxima; spart read
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      mx_a = fmaxf(mx_a, rmax[q * EX_ROWS + row_a]);
      mx_b = fmaxf(mx_b, rmax[q * EX_ROWS + row_b]);
    }
    // exp(x - m) as exp2((x - m) log2(e)): the difference first, so that
    // its rounding, not the score's, meets log2(e)
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float al_a = exp2f((m_a - mn_a) * LOG2E);
    const float al_b = exp2f((m_b - mn_b) * LOG2E);
    m_a = mn_a;
    m_b = mn_b;
    const float sv0 = past ? sct[2 * EX_KEYS + key] : 1.f;
    const float sv1 = past ? sct[2 * EX_KEYS + key + 1] : 1.f;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p =
          live[e] ? exp2f((sc4[e] - (e < 2 ? mn_a : mn_b)) * LOG2E) : 0.f;
      if (e < 2)
        sum_a += p;
      else
        sum_b += p;
      sc4[e] = p * ((e & 1) ? sv1 : sv0);  // the value scale folded in
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      sum_a += __shfl_xor_sync(0xffffffffu, sum_a, o);
      sum_b += __shfl_xor_sync(0xffffffffu, sum_b, o);
    }
    {
      uint32_t ta[3], tb[3];
      split3(sc4[0], sc4[1], ta);
      split3(sc4[2], sc4[3], tb);
#pragma unroll
      for (int k = 0; k < EX_TERMS; ++k) {
        *reinterpret_cast<uint32_t*>(
            ps + (k * EX_ROWS + row_a) * EX_PP + 2 * key) = ta[k];
        *reinterpret_cast<uint32_t*>(
            ps + (k * EX_ROWS + row_b) * EX_PP + 2 * key) = tb[k];
      }
    }
    if (tq == 0) {
      rsum[qd * EX_ROWS + row_a] = sum_a;
      rsum[qd * EX_ROWS + row_b] = sum_b;
    }
    bar_sync(1, EX_THREADS);  // P's terms and the row sums written
    l_a = al_a * l_a + (((rsum[row_a] + rsum[EX_ROWS + row_a]) +
                         rsum[2 * EX_ROWS + row_a]) +
                        rsum[3 * EX_ROWS + row_a]);
    l_b = al_b * l_b + (((rsum[row_b] + rsum[EX_ROWS + row_b]) +
                         rsum[2 * EX_ROWS + row_b]) +
                        rsum[3 * EX_ROWS + row_b]);
    // P as A fragments, three terms: k16 step ks holds keys 16ks .. +15
    uint32_t pa[2][EX_TERMS][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int k = 0; k < EX_TERMS; ++k)
        ldsm4(pa[ks][k], ps + (k * EX_ROWS + 16 * rg + lr) * EX_PP +
                             (16 * ks + (lane >> 4) * 8) * 2);

    if (past) {
      pv(pa, kt, EX_TERMS, true, al_a, al_b);
      release(s);
      ++s;
    } else {
      // the own keys' last term; then the others, each against the P terms
      // that keep the product's error below 2^-24
      pv(pa, kt, EX_TERMS - terms[n - 1], true, al_a, al_b);
      release(s + n - 1);
#pragma unroll 1
      for (int i = n; i < 2 * n - 1; ++i) {
        pv(pa, tile_of(s + i), EX_TERMS - terms[2 * n - 2 - i], false, 1.f,
           1.f);
        release(s + i);
      }
      s += 2 * n - 1;
    }
  }

  // extend: normalized rows; decode: this split's raw rows (acc, and each
  // row's max and sum, from the first quarter's warps)
  const size_t row0 = (size_t)tok * H;
#pragma unroll
  for (int n = 0; n < EX_NQ; ++n) {
    const int col = 8 * (v0 + n) + 2 * tq;
    if (n < nqv && col < dl) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = h0 + 16 * rg + gid + (e < 2 ? 0 : 8);
        const int c = col + (e & 1);
        if (h < H && c < dl) {
          if constexpr (DEC)
            a.out[((row0 + h) * a.n_split + split) * dl + c] = acc[n][e];
          else
            a.out[(row0 + h) * dl + c] =
                acc[n][e] / fmaxf(e < 2 ? l_a : l_b, 1e-30f);
        }
      }
    }
  }
  if constexpr (DEC) {
    if (qd == 0 && tq == 0) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int h = h0 + 16 * rg + gid + 8 * e;
        if (h < H) {
          const size_t part = (row0 + h) * a.n_split + split;
          a.part_m[part] = e ? m_b : m_a;
          a.part_l[part] = e ? l_b : l_a;
        }
      }
    }
  }
}

// Grid (B * H).  Adds each (request, head)'s split rows in order: each
// shifted to the largest max, then normalized once; a request's splits
// from dec_plan, as the attend kernel took them.  A thread's loads of all
// (at most DEC_SPLITS) splits are issued together.
__global__ void __launch_bounds__(256) mla_merge_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_m,
    const float* __restrict__ part_l, const int* __restrict__ pos,
    float* __restrict__ out, int H, int dl, int n_split, int max_key) {
  const size_t bh = blockIdx.x;
  int lim, tps;
  const int ns = dec_plan(pos[bh / H], max_key, &lim, &tps);
  const float* pm = part_m + bh * n_split;
  const float* pl = part_l + bh * n_split;
  float m[DEC_SPLITS], l[DEC_SPLITS], w[DEC_SPLITS];
  float mg = NEG_INF, den = 0.f;
#pragma unroll
  for (int sp = 0; sp < DEC_SPLITS; ++sp) {
    m[sp] = sp < ns ? pm[sp] : NEG_INF;
    l[sp] = sp < ns ? pl[sp] : 0.f;
    mg = fmaxf(mg, m[sp]);
  }
#pragma unroll
  for (int sp = 0; sp < DEC_SPLITS; ++sp) {
    w[sp] = exp2f((m[sp] - mg) * LOG2E);
    if (sp < ns) den += w[sp] * l[sp];
  }
  for (int d = threadIdx.x; d < dl; d += blockDim.x) {
    float x[DEC_SPLITS];
#pragma unroll
    for (int sp = 0; sp < DEC_SPLITS; ++sp)
      x[sp] = sp < ns ? part_acc[(bh * n_split + sp) * dl + d] : 0.f;
    float num = 0.f;
#pragma unroll
    for (int sp = 0; sp < DEC_SPLITS; ++sp)
      if (sp < ns) num += w[sp] * x[sp];
    out[bh * dl + d] = num / fmaxf(den, 1e-30f);
  }
}

// The latent and rope widths the kernel takes: dl within the value tiles
// of four quarters, both (each padded to 16) within a key-tile row.
bool widths_ok(int dl, int dr) {
  return dl <= EX_NQ * 8 * 4 && ((dl + 15) & ~15) + ((dr + 15) & ~15) <= EX_MAX_W;
}

// The code-row copy unit: 16 (bulk copies) when every row start is 16-byte
// aligned, else 4 (cp.async), else 1.
int copy_unit(const void* cq, const void* rq, int cb, int rb) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(cq) |
                      reinterpret_cast<uintptr_t>(rq);
  return (cb % 16 == 0 && rb % 16 == 0 && a % 16 == 0) ? 16
         : (cb % 4 == 0 && rb % 4 == 0 && a % 4 == 0)  ? 4
                                                       : 1;
}

}  // namespace

// The scratch that mla_decode_launch takes for B requests over `keys`
// cache rows a request (the flat cache's S, or the table's width x the
// page), in fp32 elements (its one owner; the caller allocates it):
// part_acc (B, H, n_split, dl) and part_m / part_l (B, H, n_split),
// n_split = dec_max_splits(keys).  cudaErrorInvalidValue for widths the
// kernel does not take.
extern "C" int mla_decode_scratch(int B, int H, int dl, int dr,
                                  long long keys, long long* acc,
                                  long long* ml) {
  if (!widths_ok(dl, dr) || keys < 1) return (int)cudaErrorInvalidValue;
  *ml = (long long)B * H * dec_max_splits(keys);
  *acc = *ml * dl;
  return 0;
}

// ql (B, H, dl), qr (B, H, dr) fp32 scaled.  Flat (tbl == nullptr): cq (B,
// S, wc), cs (B, SR), rq (B, S, wr), rs (B, SR), tile a multiple of chunk.
// Paged: cq (n_pages, tile, wc), cs (n_pages, tile / chunk), ..., tbl (B,
// n_tiles).  pos (B,).
// part_acc, part_m, part_l: scratch of the sizes mla_decode_scratch gives;
// out (B, H, dl) fp32, normalized.
extern "C" int mla_decode_launch(
    const float* ql, const float* qr, const void* cq, const void* cs,
    const void* rq, const void* rs, const int* pos, const int* tbl,
    float* part_acc, float* part_m, float* part_l, float* out, int B, int H,
    int dl, int dr, int S, int SR, int n_tiles, int tile, int chunk,
    int kv_bits, int wc, int wr, void* stream) {
  if (!widths_ok(dl, dr) || (kv_bits != 8 && kv_bits != 2) || n_tiles < 1 ||
      tile < 1 || chunk < 1 || tile % chunk)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int esz = kv_bits == 8 ? 1 : 4;
  AttendArgs a{};
  a.ql = ql;
  a.qr = qr;
  a.cq = (const char*)cq;
  a.cs = (const __nv_bfloat16*)cs;
  a.rq = (const char*)rq;
  a.rs = (const __nv_bfloat16*)rs;
  a.tbl = tbl;
  a.pos = pos;
  a.out = part_acc;
  a.part_m = part_m;
  a.part_l = part_l;
  a.H = H;
  a.dl = dl;
  a.dr = dr;
  a.page = tile;
  a.chunk = chunk;
  a.kv_bits = kv_bits;
  a.cb = wc * esz;
  a.rb = wr * esz;
  a.unit = copy_unit(cq, rq, a.cb, a.rb);
  a.S = S;
  a.SR = SR;
  a.n_tiles = n_tiles;
  const long long keys = tbl ? (long long)n_tiles * tile : S;
  a.n_split = dec_max_splits(keys);
  const ExLayout g = ex_layout(dl, dr, a.cb, a.rb);
  int err = allow_smem((const void*)mla_attend_kernel<true>, g.total);
  if (err) return err;
  const dim3 grid((H + EX_ROWS - 1) / EX_ROWS, a.n_split, B);
  mla_attend_kernel<true><<<grid, EX_BLOCK, g.total, st>>>(a);
  err = (int)cudaGetLastError();
  if (err) return err;
  mla_merge_kernel<<<B * H, 256, 0, st>>>(
      part_acc, part_m, part_l, pos, out, H, dl, a.n_split, (int)keys - 1);
  return (int)cudaGetLastError();
}

// The scratch that mla_extend_launch takes for an L-token chunk, in
// elements (its one owner; the caller allocates it): own, the chunk's own
// latents' bf16 terms, (3, 32·ceil(L / 32), the key tile's row of dl and
// dr each padded to 16, plus 8); own_nz, int32 (2, ceil(L / 32)), zeroed
// by the caller.  cudaErrorInvalidValue for widths the extend does not take.
extern "C" int mla_extend_scratch(int L, int dl, int dr, long long* own,
                                  long long* own_nz) {
  if (!widths_ok(dl, dr)) return (int)cudaErrorInvalidValue;
  const long long tiles = (L + EX_KEYS - 1) / EX_KEYS;
  *own = EX_TERMS * tiles * EX_KEYS * (ex_layout(dl, dr, 0, 0).qp / 2);
  *own_nz = 2 * tiles;
  return 0;
}

// ql (L, H, dl), qr (L, H, dr) fp32 scaled; c_new (L, dl), r_new (L, dr)
// fp32, the chunk's own latents; own, own_nz: scratch of the sizes
// mla_extend_scratch gives; pools as in the paged decode, tbl (n_past,)
// full past pages; out (L, H, dl) fp32, normalized.
extern "C" int mla_extend_launch(
    const float* ql, const float* qr, const float* c_new, const float* r_new,
    void* own, int* own_nz, const void* cq, const void* cs, const void* rq,
    const void* rs, const int* tbl, int n_past, float* out, int H, int L,
    int dl, int dr, int page, int chunk, int kv_bits, int wc, int wr,
    void* stream) {
  if (!widths_ok(dl, dr) || (kv_bits != 8 && kv_bits != 2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int esz = kv_bits == 8 ? 1 : 4;
  AttendArgs a{};
  a.ql = ql;
  a.qr = qr;
  a.own = (const __nv_bfloat16*)own;
  a.own_nz = own_nz;
  a.cq = (const char*)cq;
  a.cs = (const __nv_bfloat16*)cs;
  a.rq = (const char*)rq;
  a.rs = (const __nv_bfloat16*)rs;
  a.tbl = tbl;
  a.out = out;
  a.H = H;
  a.dl = dl;
  a.dr = dr;
  a.page = page;
  a.chunk = chunk;
  a.kv_bits = kv_bits;
  a.cb = wc * esz;
  a.rb = wr * esz;
  a.unit = copy_unit(cq, rq, a.cb, a.rb);
  a.L = L;
  a.n_past = n_past;
  const ExLayout g = ex_layout(dl, dr, a.cb, a.rb);
  int err = allow_smem((const void*)mla_attend_kernel<false>, g.total);
  if (err) return err;
  const int Lp = (L + EX_KEYS - 1) / EX_KEYS * EX_KEYS;
  mla_own_terms_kernel<<<Lp, 128, 0, st>>>(c_new, r_new,
                                          (__nv_bfloat16*)own, own_nz, L, Lp,
                                          dl, dr, g.dlp, g.qp / 2);
  err = (int)cudaGetLastError();
  if (err) return err;
  const dim3 grid((H + EX_ROWS - 1) / EX_ROWS, L);
  mla_attend_kernel<false><<<grid, EX_BLOCK, g.total, st>>>(a);
  return (int)cudaGetLastError();
}
