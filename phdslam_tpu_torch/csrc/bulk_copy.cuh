// Staging one contiguous slab of floats from device memory into shared
// memory with the Tensor Memory Accelerator's bulk copy (cp.async.bulk,
// global -> shared, completing on an mbarrier). Shared by gather_cols.cu
// and gather_rows.cu, whose blocks each stage one particle's table.
//
// A bulk copy moves whole 16-byte lines between 16-byte aligned addresses,
// so a slab that does not start or end on a line (C * R % 4 != 0, or a
// table that is a view) is split: the aligned middle goes by one bulk copy,
// the head and tail (under 16 bytes each) by plain loads. In shared memory
// the slab keeps its offset within a 16-byte line, so the middle lands on
// an aligned address and row r of the slab sits at the same float offset
// as in device memory.
//
// Dynamic shared memory layout: the 8-byte mbarrier in a 16-byte line,
// then the slab (n floats, shifted by up to 3 floats): staged_smem_bytes.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace phd {

// bytes of dynamic shared memory a staged slab of n floats needs
__host__ __device__ constexpr int staged_smem_bytes(int n) {
  return 16 + 4 * n + 16;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
  // make the initialised barrier visible to the async (TMA) proxy
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// spin until the barrier's phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}

// one bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from device memory to this block's shared memory
__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src,
                                              uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Starts staging the n floats at g into the block's dynamic shared memory
// `smem` (laid out as above) and returns where the slab starts there. Every
// thread calls it; thread 0 initialises the barrier and starts the bulk
// copy, and all threads load the unaligned head and tail. The slab is
// ready after a __syncthreads() (for the head and tail) and
// mbar_wait(bar, 0) (for the middle); the caller can load its own operands
// in between, overlapping them with the copy.
__device__ __forceinline__ const float* stage_slab(const float* g, int n,
                                                  unsigned char* smem,
                                                  uint64_t** bar_out) {
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  const int shift = static_cast<int>(
      (reinterpret_cast<uintptr_t>(g) & 15u) >> 2);    // floats into a line
  float* s = reinterpret_cast<float*>(smem + 16) + shift;
  const int head = min(n, (4 - shift) & 3);       // floats before a line
  const int body = (n - head) & ~3;               // whole lines
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    if (body > 0) {
      mbar_arrive_expect_tx(bar, 4u * body);
      bulk_copy_g2s(s + head, g + head, 4u * body, bar);
    } else {
      mbar_arrive(bar);                           // nothing in flight
    }
  }
  for (int i = threadIdx.x; i < head; i += blockDim.x) s[i] = g[i];
  for (int i = head + body + threadIdx.x; i < n; i += blockDim.x) s[i] = g[i];
  *bar_out = bar;
  return s;
}

// the devices allow_smem keeps a record for
constexpr int kMaxDevices = 64;

// Allows `bytes` of dynamic shared memory for `kernel` on the current
// device (above the 48 KB default only after this call). `allowed` is the
// caller's record of what is set already, a function-local static per
// kernel, so the attribute is set once per device and new maximum and not
// on every launch; a no-op at or below 48 KB.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, int (&allowed)[kMaxDevices]) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool kept = dev < kMaxDevices;
  if (kept && bytes <= allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && kept) allowed[dev] = bytes;
  return err;
}

}  // namespace phd
