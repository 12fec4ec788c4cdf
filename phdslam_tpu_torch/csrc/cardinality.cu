// The CPHD cardinality prediction's product, out[p, n] = sum over j of
// lin[p, j] * T[j, n], each sum taken j ascending from 0
// (filters/cphd.py::cardinality_predict_batch: lin [P, J] the rows'
// linear cardinality distributions, T [J, N] the shared birth Toeplitz
// matrix).
//
// Replaces the f32 dot of phdslam_tpu/filters/cphd.py:105 (XLA, no Pallas
// kernel there). A library product (cuBLAS) picks its tiling, and so its
// sum order, from the batch's row count: a block of rows, as one rank of a
// sharded step holds, then gives other bits than the whole batch. Here
// every output is one thread's sum in one order, whatever rows the batch
// holds; kernels/cardinality.py's twin sums the same order on the CPU,
// and --fmad=false keeps each multiply and add a separate rounding, as the
// twin's element-wise ops round.
//
// What bounds it: neither bytes nor operations at the paths' shapes
// (P = 512 to 10240 rows, J = N = max_cardinality + 1 = 65): the launch.
// One thread an output element, the row's lin[p, :] read through the L1
// as a broadcast across the row's threads, T's rows coalesced across n.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
cardinality_product_kernel(const float* __restrict__ lin,
                           const float* __restrict__ T,
                           float* __restrict__ out, int P, int J, int N) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= static_cast<int64_t>(P) * N) return;
  const int64_t p = i / N;
  const int n = static_cast<int>(i - p * N);
  const float* row = lin + p * J;
  float acc = 0.f;
  for (int j = 0; j < J; ++j)
    acc = acc + __ldg(row + j) * __ldg(T + static_cast<int64_t>(j) * N + n);
  out[i] = acc;
}

}  // namespace

// lin float[P, J], T float[J, N], out float[P, N], all contiguous on the
// current device; 0 or the CUDA error
extern "C" int phd_cardinality_product(const float* lin, const float* T,
                                       float* out, int P, int J, int N,
                                       void* stream) {
  if (P <= 0 || N <= 0) return 0;
  if (J < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = static_cast<int64_t>(P) * N;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  cardinality_product_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      lin, T, out, P, J, N);
  return static_cast<int>(cudaGetLastError());
}
