// Batched column gather: out[p, c, j] = tab[p, c, idx[p, j]].
//
// Replaces phdslam_tpu/ops/pallas_select.py::_cols_kernel. The TPU kernel
// built a one-hot [R, cap] matrix per particle and multiplied on the MXU,
// because small-row gathers serialize on the TPU; on Hopper a gather is a
// plain indexed load. An index outside [0, R) gives 0, as the one-hot
// product does.
//
// What bounds it: bytes. It must read idx once and the table once and
// write the output once (22 MB at the main path's t_k, C=16 R=128 cap=512
// P=512); there is no arithmetic to speak of.
//
// What the first design lost: one thread per output element over a flat
// int64 index paid two 64-bit divisions per element (emulated, tens of
// instructions each), read idx[p, j] once for every row c (C times in
// all), stored 4 bytes a thread and read the table through L1/L2 at
// scattered addresses. torch.gather, with 32-bit offsets and magic-number
// division, beat it 1.25-1.5x.
//
// This design: one block per particle (a 2D grid splits the cap axis when
// P alone leaves the card short of blocks); all index math in 32 bits
// inside the particle and no division per element. The particle's [C, R]
// slab is staged into shared memory by one TMA bulk copy, started before
// the block loads its indices so that the two overlap, so the table is
// read from device memory exactly once. Each thread loads four consecutive
// indices with one 16-byte load, checks them once, and writes
// out[p, c, j..j+3] for its rows c as one 16-byte streaming store (__stcs);
// when the cap axis needs fewer than 256 threads, the rest split the rows
// (at cap 128: 32 threads a row group, up to 8 groups).
// A cap that is not a multiple of 4 (or an unaligned idx) takes scalar
// loads and stores in the same kernel (kVec false); an unaligned slab is
// handled by stage_slab.
//
// A slab above the shared-memory budget that the wrapper sets cannot be
// staged, and then each read of the table is a random 4-byte load from
// device memory; what bounds that is the number of loads in flight. So
// gather_cols_ldg_kernel keeps the first design's one thread per output
// element, which puts the most loads in flight, reading through __ldg,
// with the (j, c, p) position taken from the grid's three axes instead of
// divided out of a flat index. No width is refused.

#include <cuda_runtime.h>

#include <cstdint>

#include "bulk_copy.cuh"

namespace {

template <bool kVec>
__global__ void __launch_bounds__(256)
gather_cols_kernel(const int* __restrict__ idx, const float* __restrict__ tab,
                   float* __restrict__ out, int C, int R, int cap,
                   int quads_per_split, int qthreads) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int p = blockIdx.x;
  // the only 64-bit offsets: each particle's base, once per block
  const int* idx_p = idx + static_cast<int64_t>(p) * cap;
  float* out_p = out + static_cast<int64_t>(p) * C * cap;
  uint64_t* bar;
  const float* slab = phd::stage_slab(tab + static_cast<int64_t>(p) * C * R,
                                      C * R, smem, &bar);

  const int n_quads = (cap + 3) >> 2;
  const int q_end = min(n_quads, static_cast<int>(blockIdx.y + 1)
                                     * quads_per_split);
  // four consecutive indices per thread and pass
  int4 j4 = make_int4(-1, -1, -1, -1);
  auto load = [&](int q) {
    if constexpr (kVec) {
      j4 = __ldg(reinterpret_cast<const int4*>(idx_p) + q);
    } else {
      const int j = 4 * q;
      j4.x = __ldg(idx_p + j);
      j4.y = j + 1 < cap ? __ldg(idx_p + j + 1) : -1;
      j4.z = j + 2 < cap ? __ldg(idx_p + j + 2) : -1;
      j4.w = j + 3 < cap ? __ldg(idx_p + j + 3) : -1;
    }
  };
  // thread (qx, cy) takes quads qx, qx + qthreads, ... and rows cy,
  // cy + ry, ...: when the cap axis leaves threads over, they split the
  // rows (one division per thread, none per element)
  const int qx = threadIdx.x % qthreads;
  const int cy = threadIdx.x / qthreads;
  const int ry = blockDim.x / qthreads;
  int q = blockIdx.y * quads_per_split + qx;
  if (q < q_end) load(q);             // while the bulk copy is in flight
  __syncthreads();                    // the head and tail of the slab
  phd::mbar_wait(bar, 0);             // its bulk-copied middle
  const unsigned r = static_cast<unsigned>(R);
  while (q < q_end) {
    // one range check per index; an index outside [0, R) reads nothing
    // and gives 0
    const bool ok0 = static_cast<unsigned>(j4.x) < r;
    const bool ok1 = static_cast<unsigned>(j4.y) < r;
    const bool ok2 = static_cast<unsigned>(j4.z) < r;
    const bool ok3 = static_cast<unsigned>(j4.w) < r;
    const int4 s = j4;
    const int j = 4 * q;
    q += qthreads;
    if (q < q_end) load(q);           // the next pass's indices
    const float* row = slab + cy * R;
    float* dst = out_p + cy * cap + j;
#pragma unroll 4
    for (int c = cy; c < C; c += ry, row += ry * R, dst += ry * cap) {
      float4 v;
      v.x = ok0 ? row[s.x] : 0.f;
      v.y = ok1 ? row[s.y] : 0.f;
      v.z = ok2 ? row[s.z] : 0.f;
      v.w = ok3 ? row[s.w] : 0.f;
      if constexpr (kVec) {
        __stcs(reinterpret_cast<float4*>(dst), v);
      } else {
        __stcs(dst, v.x);
        if (j + 1 < cap) __stcs(dst + 1, v.y);
        if (j + 2 < cap) __stcs(dst + 2, v.z);
        if (j + 3 < cap) __stcs(dst + 3, v.w);
      }
    }
  }
}

// one thread per output element: j from the grid's x axis, c from y, p
// from z (each loops by its grid extent past 65535 rows or particles)
__global__ void __launch_bounds__(256)
gather_cols_ldg_kernel(const int* __restrict__ idx,
                       const float* __restrict__ tab, float* __restrict__ out,
                       int P, int C, int R, int cap) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= cap) return;
  const unsigned r = static_cast<unsigned>(R);
  for (int p = blockIdx.z; p < P; p += gridDim.z) {
    const int k = __ldg(idx + static_cast<int64_t>(p) * cap + j);
    const bool ok = static_cast<unsigned>(k) < r;
    const float* tab_p = tab + static_cast<int64_t>(p) * C * R;
    float* out_p = out + static_cast<int64_t>(p) * C * cap;
    for (int c = blockIdx.y; c < C; c += gridDim.y) {
      out_p[c * cap + j] = ok ? __ldg(tab_p + c * R + k) : 0.f;
    }
  }
}

template <bool kVec>
int launch(const int* idx, const float* tab, float* out, int P, int C, int R,
           int cap, cudaStream_t stream) {
  constexpr int kTargetBlocks = 2 * 132;      // two blocks per H100 SM
  const int n_quads = (cap + 3) / 4;
  // split the cap axis only when P alone gives too few blocks, and never
  // below a warp's worth of quads per block
  int splits = (kTargetBlocks + P - 1) / P;
  splits = max(1, min(splits, (n_quads + 31) / 32));
  const int per_split = (n_quads + splits - 1) / splits;
  // threads along the cap axis, and as many row groups as fill 256
  const int qthreads = min(256, (per_split + 31) / 32 * 32);
  const int threads = qthreads * max(1, min(256 / qthreads, C));
  const int smem = phd::staged_smem_bytes(C * R);
  static int allowed[phd::kMaxDevices] = {};  // this kernel's smem setting
  auto kernel = gather_cols_kernel<kVec>;
  const cudaError_t err = phd::allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(P, splits), threads, smem, stream>>>(idx, tab, out, C, R,
                                                      cap, per_split,
                                                      qthreads);
  return static_cast<int>(cudaGetLastError());
}

int launch_ldg(const int* idx, const float* tab, float* out, int P, int C,
               int R, int cap, cudaStream_t stream) {
  const int threads = min(256, (cap + 31) / 32 * 32);
  const dim3 grid((cap + threads - 1) / threads, min(C, 65535),
                  min(P, 65535));
  gather_cols_ldg_kernel<<<grid, threads, 0, stream>>>(idx, tab, out, P, C,
                                                       R, cap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// staged: the [C, R] slab fits the shared-memory budget (the wrapper
// decides and counts the launch under its mode's name); vec: cap % 4 == 0
// and idx and out 16-byte aligned (staged mode only).
extern "C" int phd_gather_cols(const int* idx, const float* tab, float* out,
                               int P, int C, int R, int cap, int staged,
                               int vec, void* stream) {
  if (static_cast<int64_t>(P) * C * cap <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (!staged) return launch_ldg(idx, tab, out, P, C, R, cap, s);
  return vec ? launch<true>(idx, tab, out, P, C, R, cap, s)
             : launch<false>(idx, tab, out, P, C, R, cap, s);
}
