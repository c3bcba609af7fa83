// Helpers shared by the Hopper kernels (gram.cu, quant_matmul.cu,
// mla_decode.cu, hadamard.cu, gptq_block.cu): named barriers, the async-proxy fence,
// wgmma's fence / commit / wait, its shared-memory descriptor for K-major
// operands in the 128-byte swizzle, the exact split of fp32 values into
// three bf16 terms that their fp32-accurate products rest on, and the
// launch-side raise of a kernel's shared-memory limit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int SPLIT_TERMS = 3;  // hi, mid, lo
constexpr int SWZ_SBO = 1024;   // descriptor: the next 8 rows of 128 bytes

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// a barrier of the `count` threads (whole warps) that name barrier id
// (0 is __syncthreads')
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// generic-proxy accesses to shared memory before, async-proxy ones (wgmma,
// bulk copies) after
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// pins the accumulators' reads and writes after the asm statement before it
template <int N> __device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor, K-major, 128-byte swizzle: start
// address, leading byte offset (unused in this mode: 1), stride byte offset
// between 8-row groups, each in 16-byte units; layout type 1 (bits 62-63).
// A 16-deep k step inside an atom starts 32 bytes further on.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(SWZ_SBO >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}
// byte offset of 16-byte chunk c (< 8) of row r in the 128-byte swizzle: a
// row holds 128 bytes, its chunk c stored at chunk c ^ (row % 8)
__device__ __forceinline__ int swz128(int r, int c) {
  return r * 128 + ((c ^ (r % 8)) * 16);
}

// Two fp32 values -> three bf16x2 terms (low half: x0): hi = bf16(x),
// mid = bf16(x - hi), lo = bf16(x - hi - mid); each difference is exact in
// fp32, so hi + mid + lo is within ~2^-24 of x.
__device__ __forceinline__ void split3(float x0, float x1,
                                       uint32_t (&t)[SPLIT_TERMS]) {
#pragma unroll
  for (int i = 0; i < SPLIT_TERMS; ++i) {
    const __nv_bfloat162 b = __floats2bfloat162_rn(x0, x1);
    t[i] = *reinterpret_cast<const uint32_t*>(&b);
    x0 -= __low2float(b);
    x1 -= __high2float(b);
  }
}

// Raise a kernel's dynamic shared-memory limit to what it needs, on the
// current device: set on every launch, since the attribute is per device
int allow_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

}  // namespace
