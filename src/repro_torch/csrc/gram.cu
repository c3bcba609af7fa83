// Weighted gram for the GPTQ Hessian: out += alpha * (X·r)^T (X·r).
//
// Replaces: weighted_gram_pallas / _gram_kernel in
// src/repro/kernels/gram/kernel.py (the TPU kernel that tiles the (d, d)
// output over a 2-D grid and streams the token axis through VMEM along a
// sequential "arbitrary" grid axis).
//
// What bounds it on the H100: operations.  For n tokens and d features it
// does 2·n·d² fp32 multiply-adds on n·d·4 bytes of input; at d = 4096 and
// n = 2048 that is ~4k operations per byte, far above the card's ~20 fp32
// operations per byte of memory bandwidth.  The limit is the fp32 (non
// tensor-core) rate, 67 TFLOP/s.
//
// Design: each block owns one 128 x 128 output tile and loops over the whole
// token axis itself (on the card nothing carries between blocks, so the
// TPU's sequential grid axis becomes this in-block loop).  Per step it stages
// an 8-token slab of both column panels in shared memory with r fused into
// the load, and each of its 256 threads accumulates an 8 x 8 register tile
// in fp32.  A thread owns rows ty + 16·i and columns tx + 16·j, so its
// shared-memory reads are broadcasts or consecutive words (no bank
// conflicts).  Ragged n and d are masked at the load and at the store.  The
// full matrix is computed (both triangles), as the TPU kernel does.
// The result is added into the caller's fp32 accumulator.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128;
constexpr int SLAB = 8;
constexpr int THREADS = 256;
constexpr int PER = TILE / 16;  // 8 rows x 8 columns per thread

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
gram_kernel(const T* __restrict__ x, const float* __restrict__ r,
            float* __restrict__ out, int n, int d, float alpha) {
  __shared__ float as[SLAB][TILE];
  __shared__ float bs[SLAB][TILE];
  const int i0 = blockIdx.y * TILE;
  const int j0 = blockIdx.x * TILE;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  float acc[PER][PER];
#pragma unroll
  for (int i = 0; i < PER; ++i)
#pragma unroll
    for (int j = 0; j < PER; ++j) acc[i][j] = 0.f;

  for (int t0 = 0; t0 < n; t0 += SLAB) {
#pragma unroll
    for (int s = 0; s < (SLAB * TILE) / THREADS; ++s) {
      const int idx = tid + s * THREADS;
      const int kk = idx / TILE;
      const int c = idx % TILE;
      const int t = t0 + kk;
      float rv = 0.f;
      if (t < n) rv = (r != nullptr) ? r[t] : 1.f;
      const int ci = i0 + c;
      const int cj = j0 + c;
      as[kk][c] = (t < n && ci < d) ? to_f(x[(size_t)t * d + ci]) * rv : 0.f;
      bs[kk][c] = (t < n && cj < d) ? to_f(x[(size_t)t * d + cj]) * rv : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < SLAB; ++kk) {
      float a[PER], b[PER];
#pragma unroll
      for (int i = 0; i < PER; ++i) a[i] = as[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < PER; ++j) b[j] = bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < PER; ++i)
#pragma unroll
        for (int j = 0; j < PER; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int row = i0 + ty + 16 * i;
    if (row >= d) continue;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int col = j0 + tx + 16 * j;
      if (col < d) out[(size_t)row * d + col] += alpha * acc[i][j];
    }
  }
}

}  // namespace

// x: (n, d) fp32 (x_bf16 == 0) or bf16 (x_bf16 == 1), row-major;
// r: (n,) fp32 or null (all ones); out: (d, d) fp32, accumulated into.
extern "C" int gram_launch(const void* x, int x_bf16, const float* r,
                           float* out, int n, int d, float alpha,
                           void* stream) {
  const dim3 grid((d + TILE - 1) / TILE, (d + TILE - 1) / TILE);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    gram_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), r, out, n, d, alpha);
  } else {
    gram_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), r, out, n, d, alpha);
  }
  return static_cast<int>(cudaGetLastError());
}
