// Batched row gather: out[p, j, :] = tab[p, idx[p, j], :].
//
// Replaces phdslam_tpu/ops/pallas_select.py::_rows_kernel (entry
// onehot_rows_batch). The TPU kernel built a one-hot [cap, R] matrix per
// particle and multiplied on the MXU, because small-row gathers serialize
// there; on Hopper a gather is a plain indexed load. An index outside
// [0, R) gives a zero row, as the one-hot product does (gather_cols.cu
// keeps the same rule).
//
// What bounds it: bytes. It must read idx once and the table once and
// write the output once; there is no arithmetic to speak of.
//
// What the first design lost: one thread per output float over a flat
// int64 index paid two 64-bit divisions per float (emulated, tens of
// instructions each) and moved 4 bytes per load and store on 64-byte rows;
// torch.gather beat it 1.36x.
//
// This design, gather_cols.cu's: one block per particle (a 2D grid splits
// the cap axis when P alone leaves the card short of blocks), 32-bit index
// math inside the particle and no division per element. The particle's
// [R, C] slab is staged into shared memory by one TMA bulk copy, started
// before the block loads its indices. A row is copied from shared memory
// as 16-byte vectors by C / 4 neighbouring threads (four to a 64-byte row
// at C=16), each index read once per row, the output written with 16-byte
// streaming stores (__stcs). A C that is not a multiple of 4 (or an
// unaligned table) copies single floats in the same kernel (kVec false);
// a slab above the wrapper's shared-memory budget reads the table through
// __ldg (kStaged false).

#include <cuda_runtime.h>

#include <cstdint>

#include "bulk_copy.cuh"

namespace {

// units: the vectors (kVec) or floats of a row; lanes: the threads that
// share one row, rows_per_pass = blockDim.x / lanes rows at a time
template <bool kStaged, bool kVec>
__global__ void __launch_bounds__(256)
gather_rows_kernel(const int* __restrict__ idx, const float* __restrict__ tab,
                   float* __restrict__ out, int R, int C, int cap,
                   int rows_per_split, int lanes) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int p = blockIdx.x;
  // the only 64-bit offsets: each particle's base, once per block
  const float* slab = tab + static_cast<int64_t>(p) * R * C;
  const int* idx_p = idx + static_cast<int64_t>(p) * cap;
  float* out_p = out + static_cast<int64_t>(p) * cap * C;
  uint64_t* bar = nullptr;
  if constexpr (kStaged) slab = phd::stage_slab(slab, R * C, smem, &bar);

  // one division per thread, none per element
  const int lane = threadIdx.x % lanes;
  const int rows_per_pass = blockDim.x / lanes;
  const int units = kVec ? C >> 2 : C;
  const int j_end = min(cap, static_cast<int>(blockIdx.y + 1)
                                 * rows_per_split);
  int j = blockIdx.y * rows_per_split + threadIdx.x / lanes;
  const bool active = threadIdx.x < rows_per_pass * lanes;
  // this thread's first row index, loaded while the copy is in flight
  int src = active && j < j_end ? __ldg(idx_p + j) : -1;
  if constexpr (kStaged) {
    __syncthreads();                  // the head and tail of the slab
    phd::mbar_wait(bar, 0);           // its bulk-copied middle
  }
  if (!active) return;
  for (; j < j_end; j += rows_per_pass) {
    // one range check per row; a row outside [0, R) reads nothing and
    // gives zeros
    const bool ok = static_cast<unsigned>(src) < static_cast<unsigned>(R);
    const float* row = slab + (ok ? src : 0) * C;
    float* dst = out_p + j * C;
    if (j + rows_per_pass < j_end) src = __ldg(idx_p + j + rows_per_pass);
    for (int u = lane; u < units; u += lanes) {
      if constexpr (kVec) {
        const float4* vrow = reinterpret_cast<const float4*>(row);
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if constexpr (kStaged) {
          if (ok) v = vrow[u];
        } else {
          if (ok) v = __ldg(vrow + u);
        }
        __stcs(reinterpret_cast<float4*>(dst) + u, v);
      } else {
        float v = 0.f;
        if constexpr (kStaged) {
          if (ok) v = row[u];
        } else {
          if (ok) v = __ldg(row + u);
        }
        __stcs(dst + u, v);
      }
    }
  }
}

template <bool kStaged, bool kVec>
int launch(const int* idx, const float* tab, float* out, int P, int R, int C,
           int cap, cudaStream_t stream) {
  constexpr int kTargetBlocks = 2 * 132;      // two blocks per H100 SM
  const int units = kVec ? C / 4 : C;
  const int lanes = min(units, 256);
  const int rows_per_pass_max = 256 / lanes;
  // split the cap axis only when P alone gives too few blocks, and never
  // below one full pass of rows per block
  int splits = (kTargetBlocks + P - 1) / P;
  splits = max(1, min(splits, (cap + rows_per_pass_max - 1)
                                  / rows_per_pass_max));
  const int per_split = (cap + splits - 1) / splits;
  const int rows = min(per_split, rows_per_pass_max);
  const int threads = (rows * lanes + 31) / 32 * 32;
  const int smem = kStaged ? phd::staged_smem_bytes(R * C) : 0;
  static int allowed[phd::kMaxDevices] = {};  // this kernel's smem setting
  auto kernel = gather_rows_kernel<kStaged, kVec>;
  const cudaError_t err = phd::allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(P, splits), threads, smem, stream>>>(idx, tab, out, R, C, cap,
                                                     per_split, lanes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// staged: the [R, C] slab fits the shared-memory budget (the wrapper
// decides and counts the launch under its mode's name); vec: C % 4 == 0
// and tab and out 16-byte aligned.
extern "C" int phd_gather_rows(const int* idx, const float* tab, float* out,
                               int P, int R, int C, int cap, int staged,
                               int vec, void* stream) {
  if (static_cast<int64_t>(P) * cap * C <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (staged) {
    return vec ? launch<true, true>(idx, tab, out, P, R, C, cap, s)
               : launch<true, false>(idx, tab, out, P, R, C, cap, s);
  }
  return vec ? launch<false, true>(idx, tab, out, P, R, C, cap, s)
             : launch<false, false>(idx, tab, out, P, R, C, cap, s);
}
