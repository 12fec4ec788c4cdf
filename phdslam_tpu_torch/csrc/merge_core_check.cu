// Holds merge_core.cuh's Recip quotient against IEEE f32 division on the
// card: over n pseudo-random operand pairs (a splitmix hash of the pair's
// index and a seed), counts the pairs tested, those Recip declines (the
// kernels then divide in IEEE f32) and those whose Recip quotient differs
// from a / b in any bit, which must be none. Mode 0 draws any finite bit
// patterns (subnormal, huge and tiny quotients included); mode 1
// exponents from 2^-27 to 2^28, both signs.

#include <cuda_runtime.h>

#include <cstdint>

#include "merge_core.cuh"

namespace {

__device__ __forceinline__ uint32_t hash(uint64_t x) {
  x += 0x9e3779b97f4a7c15ULL;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
  return static_cast<uint32_t>(x ^ (x >> 31));
}

__device__ __forceinline__ float draw(uint32_t u, int mode) {
  if (mode == 0) return __uint_as_float(u);
  return __uint_as_float((u & 0x807fffffu) | ((100u + (u >> 24) % 56u) << 23));
}

__global__ void recip_check_kernel(unsigned long long n,
                                   unsigned long long seed, int mode,
                                   unsigned long long* counts) {
  unsigned long long tested = 0, declined = 0, differ = 0;
  for (unsigned long long k = blockIdx.x * blockDim.x + threadIdx.x; k < n;
       k += static_cast<unsigned long long>(gridDim.x) * blockDim.x) {
    const float a = draw(hash((seed << 40) ^ (2 * k)), mode);
    const float b = draw(hash((seed << 40) ^ (2 * k + 1)), mode);
    if (!isfinite(a) || !isfinite(b) || b == 0.f) continue;
    ++tested;
    bool ok = true;
    const phd_merge::Recip rb(b, ok);
    const float q = rb(a, ok);
    if (!ok)
      ++declined;
    else if (__float_as_uint(q) != __float_as_uint(a / b))
      ++differ;
  }
  atomicAdd(&counts[0], tested);
  atomicAdd(&counts[1], declined);
  atomicAdd(&counts[2], differ);
}

}  // namespace

// counts: 3 zeroed device integers (tested, declined, differing)
extern "C" int phd_merge_recip_check(unsigned long long n,
                                     unsigned long long seed, int mode,
                                     unsigned long long* counts,
                                     void* stream) {
  if (mode != 0 && mode != 1) return static_cast<int>(cudaErrorInvalidValue);
  recip_check_kernel<<<1024, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      n, seed, mode, counts);
  return static_cast<int>(cudaGetLastError());
}
