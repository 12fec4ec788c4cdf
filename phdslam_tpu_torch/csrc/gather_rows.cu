// Batched row gather: out[p, c, :] = tab[p, idx[p, c], :].
//
// Replaces phdslam_tpu/ops/pallas_select.py::_rows_kernel (entry
// onehot_rows_batch). The TPU kernel built a one-hot [cap, R] matrix per
// particle and multiplied on the MXU, because small-row gathers serialize
// there; on Hopper a gather is a plain indexed load. An index outside
// [0, R) gives a zero row, as the one-hot product does (gather_cols.cu
// keeps the same rule).
//
// What bounds it on Hopper: pure data movement, 4 bytes written and at
// most 8 read per output element. Design: one thread per output element
// with the C axis fastest, so writes and table reads coalesce along a row;
// the index is read once per row by C neighbouring threads (a broadcast
// from L1). A grid-stride loop covers any size.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__global__ void gather_rows_kernel(const int* __restrict__ idx,
                                   const float* __restrict__ tab,
                                   float* __restrict__ out, int R, int C,
                                   int cap, int64_t total) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x
                   + threadIdx.x;
       i < total; i += stride) {
    const int64_t pc = i / C;                   // p * cap + c
    const int col = static_cast<int>(i - pc * C);
    const int64_t p = pc / cap;
    const int src = idx[pc];
    out[i] = (src >= 0 && src < R) ? tab[(p * R + src) * C + col] : 0.f;
  }
}

}  // namespace

extern "C" int phd_gather_rows(const int* idx, const float* tab, float* out,
                               int P, int R, int C, int cap, void* stream) {
  const int64_t total = static_cast<int64_t>(P) * cap * C;
  if (total <= 0) return 0;
  constexpr int kThreads = 256;
  const int64_t want = (total + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 132 * 64 ? want : 132 * 64);
  gather_rows_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      idx, tab, out, R, C, cap, total);
  return static_cast<int>(cudaGetLastError());
}
