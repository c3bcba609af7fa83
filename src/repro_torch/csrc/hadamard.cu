// Orthonormal fast Walsh-Hadamard transform of rows: y = x · H_d / sqrt(d),
// d a power of two, computed in fp32, stored in x's type (fp32 or bf16).
//
// Replaces: fwht_pallas / _fwht_kernel in src/repro/kernels/hadamard/
// kernel.py (the TPU kernel that holds a (rows_blk, d) tile in VMEM, runs
// the first log2(128) butterfly stages as one MXU product with H_128 and
// the rest as reshape-butterflies).
//
// What bounds it on the H100: bytes.  Each row is read once and written
// once (n·d values each way) for log2(d) adds and subtracts per value:
// at n 2048, d 4096 in fp32 that is 67 MB, ~20 us at 3.35 TB/s, against
// ~0.1 us of fp32 operations.
//
// Design.  There is no 128 x 128 matrix unit here, and the butterfly needs
// only adds, so the TPU's H_128 product becomes register and shuffle
// stages.  A row of d = E · T values is held by T threads, E consecutive
// values each (E = 8 for 16 <= d <= 8192, 16 and 32 above; T <= 1024), and
// the log2(d) stages run in three tiers:
//   - strides below E inside each thread's registers;
//   - the next five (strides E .. 16E) by __shfl_xor_sync across the warp;
//   - the rest through shared memory, in place: each thread updates whole
//     pairs, so one barrier per stage separates them.  A row takes d fp32
//     values of dynamic shared memory (128 KB at d = 2^15).
// Then each value is scaled by 1/sqrt(d) and stored.  Rows narrower than
// 256 threads' worth share a block (256 / T rows).  d = 1 .. 2^15 in one
// pass; the wrapper raises above that.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int MAX_LOG2 = 15;
constexpr int MIN_THREADS = 256;  // a block holds 256 / T rows when T < 256

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f(float& d, float v) { d = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16& d, float v) {
  d = __float2bfloat16(v);
}

// E values of type T at p, 16-byte vectors when E·sizeof(T) allows (the
// wrapper hands in 16-byte aligned rows).
template <typename T, int E>
__device__ __forceinline__ void load_row(const T* p, float (&v)[E]) {
  if constexpr (E * sizeof(T) % 16 == 0) {
    constexpr int PER = 16 / sizeof(T);
#pragma unroll
    for (int c = 0; c < E / PER; ++c) {
      const uint4 raw = reinterpret_cast<const uint4*>(p)[c];
      const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < PER; ++i) v[c * PER + i] = to_f(vals[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < E; ++i) v[i] = to_f(p[i]);
  }
}

template <typename T, int E>
__device__ __forceinline__ void store_row(T* p, const float (&v)[E],
                                          float scale) {
  if constexpr (E * sizeof(T) % 16 == 0) {
    constexpr int PER = 16 / sizeof(T);
#pragma unroll
    for (int c = 0; c < E / PER; ++c) {
      uint4 raw;
      T* vals = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int i = 0; i < PER; ++i) from_f(vals[i], v[c * PER + i] * scale);
      reinterpret_cast<uint4*>(p)[c] = raw;
    }
  } else {
#pragma unroll
    for (int i = 0; i < E; ++i) from_f(p[i], v[i] * scale);
  }
}

// One block: blockDim.x / trow rows of d = E · trow values, trow threads
// each.  Threads of rows past n compute on zeros (every lane takes part in
// the shuffles and barriers) and store nothing.
template <typename T, int E>
__global__ void fwht_kernel(const T* __restrict__ x, T* __restrict__ out,
                            int n, int d, int trow, float scale) {
  extern __shared__ float rows_s[];
  const int rl = threadIdx.x / trow, t = threadIdx.x % trow;
  const long long row = (long long)blockIdx.x * (blockDim.x / trow) + rl;
  const bool live = row < n;
  float v[E];
  if (live) {
    load_row<T, E>(x + row * d + (long long)t * E, v);
  } else {
#pragma unroll
    for (int i = 0; i < E; ++i) v[i] = 0.f;
  }
  // strides 1 .. E/2: within the thread
#pragma unroll
  for (int h = 1; h < E; h *= 2) {
#pragma unroll
    for (int i = 0; i < E; ++i) {
      if ((i & h) == 0) {
        const float a = v[i], b = v[i + h];
        v[i] = a + b;
        v[i + h] = a - b;
      }
    }
  }
  // strides E .. 16E: the partner value sits in lane t ^ m at the same i
  const int warp_span = trow < 32 ? trow : 32;
  for (int m = 1; m < warp_span; m *= 2) {
    const bool upper = (t & m) != 0;
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const float o = __shfl_xor_sync(0xffffffffu, v[i], m);
      v[i] = upper ? o - v[i] : v[i] + o;
    }
  }
  // strides 32E .. d/2: in place in shared memory, one barrier per stage
  if (trow > 32) {
    float* rs = rows_s + (size_t)rl * d;
#pragma unroll
    for (int i = 0; i < E; ++i) rs[t * E + i] = v[i];
    __syncthreads();
    for (int st = 32 * E; st < d; st *= 2) {
#pragma unroll
      for (int q = 0; q < E / 2; ++q) {
        const int p = t + trow * q;  // pair index: consecutive across lanes
        const int i = ((p & ~(st - 1)) << 1) | (p & (st - 1));
        const float a = rs[i], b = rs[i + st];
        rs[i] = a + b;
        rs[i + st] = a - b;
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < E; ++i) v[i] = rs[t * E + i];
  }
  if (live) store_row<T, E>(out + row * d + (long long)t * E, v, scale);
}

template <typename T, int E>
int launch(const void* x, void* out, int n, int d, float scale,
           cudaStream_t s) {
  const int trow = d / E;
  const int threads = trow >= MIN_THREADS ? trow : MIN_THREADS;
  const int rows_per_block = threads / trow;
  const size_t smem = trow > 32 ? (size_t)threads * E * sizeof(float) : 0;
  const int err =
      allow_smem(reinterpret_cast<const void*>(fwht_kernel<T, E>), smem);
  if (err != 0) return err;
  const int blocks = (n + rows_per_block - 1) / rows_per_block;
  fwht_kernel<T, E><<<blocks, threads, smem, s>>>(
      static_cast<const T*>(x), static_cast<T*>(out), n, d, trow, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* x, void* out, int n, int d, float scale,
             cudaStream_t s) {
  switch (d) {
    case 1: return launch<T, 1>(x, out, n, d, scale, s);
    case 2: return launch<T, 2>(x, out, n, d, scale, s);
    case 4: return launch<T, 4>(x, out, n, d, scale, s);
    case 1 << 14: return launch<T, 16>(x, out, n, d, scale, s);
    case 1 << 15: return launch<T, 32>(x, out, n, d, scale, s);
    default: return launch<T, 8>(x, out, n, d, scale, s);  // 8 .. 2^13
  }
}

}  // namespace

// x, out: (n, d) contiguous, 16-byte aligned, fp32 (x_bf16 = 0) or bf16;
// d a power of two, 1 <= d <= 2^15; scale = 1/sqrt(d).
extern "C" int fwht_launch(const void* x, void* out, int x_bf16, int n, int d,
                           float scale, void* stream) {
  if (n <= 0 || d < 1 || d > (1 << MAX_LOG2) || (d & (d - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) return launch_d<__nv_bfloat16>(x, out, n, d, scale, s);
  return launch_d<float>(x, out, n, d, scale, s);
}
