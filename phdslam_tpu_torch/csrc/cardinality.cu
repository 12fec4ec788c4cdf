// The CPHD cardinality prediction in one launch
// (filters/cphd.py::cardinality_predict_batch): for log_cn [P, C1], the
// rows' log cardinality distributions, and one shared log_cn_birth [C1],
//   mx[p]    = max_j log_cn[p, j]          bmax = max_d log_cn_birth[d]
//   lin[p, j] = expf(log_cn[p, j] - mx[p])
//   T[j, n]  = expf(log_cn_birth[n - j] - bmax) for n >= j, else 0
//   acc[p, n] = sum over j of lin[p, j] * T[j, n], j ascending from 0
//   out[p, n] = ((acc > 0 ? logf(acc) : LOG0) + mx[p]) + bmax
//
// Replaces the JAX package's cardinality_predict_batch
// (phdslam_tpu/filters/cphd.py:87: XLA's max, exp, f32 dot and log; no
// Pallas kernel there) and the port's eager chain of about 19 PyTorch ops
// around its former product kernel. A library product (cuBLAS) picks its
// sum order from the batch's row count, so a block of rows, as one rank
// of a sharded step holds, would get other bits than the whole batch.
// Here every output is one thread's sum in one order whatever rows the
// batch holds, and each step is the op PyTorch's element-wise kernels
// launch (a subtract, then expf; a multiply and an add each rounded,
// --fmad=false): kernels/cardinality.py's twin runs that chain on the
// CPU and the kernel gives its bits.
//
// What bounds it: at the CPHD path's shapes (P = 512 to 10240, C1 =
// max_cardinality + 1 = 65) the bytes (log_cn in, the prediction out)
// take 0.0001-0.0016 ms of HBM time and the products' multiplies and
// adds (the triangle n >= j) 0.00003-0.0007 ms of the f32 peak: the
// launch and the latency of its few dependent steps at P = 512, the
// issue of ~4300 f32 operations a row, 65 of them exp and log, at 10240.
//
// The design. T is a Toeplitz matrix, T[j, n] = e[n - j] with
// e[d] = expf(log_cn_birth[d] - bmax): each block builds e once in shared
// memory, zero-padded below 0 so that T's zeros (n < j) are plain loads
// (ez[C1 + d], d from -C1). A block takes 16 rows: their contiguous slab
// of log_cn comes by one TMA bulk copy (bulk_copy.cuh::stage_slab) while
// the block takes bmax and builds e, and is turned into lin in place, a
// warp two rows at once (the max is exact in any order; NaN wins it, as
// in torch.amax). A lane then takes one row (lane % 16) and one quad of 4
// consecutive outputs n0..n0 + 3 (a warp two neighbouring quads, so
// ceil(Q / 2) warps a block for Q = ceil(C1 / 4) quads: 9 at C1 = 65, and
// 640 blocks at P = 10240, ~5 an SM, all resident at once). Per 4 terms j
// it loads 4 lin values (row stride C1, odd at the paths' C1: no bank
// conflict; the two half-warps read the same rows, a broadcast) and the 4
// e values that enter its window (two addresses a warp) before its 16
// multiplies and 16 adds, the window of its quad in registers. A row
// whose max is finite has lin in [0, 1], so its terms past n add exactly
// 0 and its loop stops at n0 + 3 (a quad's triangle); a row with a NaN or
// infinite max takes all C1 terms, so that NaN * 0 reaches its sums as in
// the twin. Each lane writes its 4 outputs.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "bulk_copy.cuh"

namespace {

constexpr int kRows = 16;             // rows a block: one a half-warp lane
constexpr int kQuad = 4;              // consecutive outputs a lane
constexpr int kMaxWarps = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog0 = -1.0e30f;     // ops/math.py::LOG0
constexpr size_t kMaxSmem = 227 * 1024;

__host__ __device__ constexpr int quads(int C1) {
  return (C1 + kQuad - 1) / kQuad;
}

// warps a block: two quads each
__host__ __device__ constexpr int block_warps(int C1) {
  return (quads(C1) + 1) / 2 < kMaxWarps ? (quads(C1) + 1) / 2 : kMaxWarps;
}

// bytes of dynamic shared memory before ez: the barrier and the staged
// slab of the block's rows
__host__ __device__ constexpr size_t slab_bytes(int C1) {
  return (static_cast<size_t>(phd::staged_smem_bytes(kRows * C1)) + 15)
         & ~static_cast<size_t>(15);
}

// dynamic shared memory: the slab | ez [C1 + 4 Q] | mx [kRows]
size_t smem_bytes(int C1) {
  return slab_bytes(C1)
         + 4 * (static_cast<size_t>(C1) + kQuad * quads(C1) + kRows);
}

// torch.amax's order-free max: NaN wins
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// an output from its sum: safe_log, then + mx, then + bmax
__device__ __forceinline__ float finish(float acc, float mx, float bmax) {
  float v = acc > 0.f ? logf(acc) : kLog0;
  v = v + mx;
  return v + bmax;
}

// grid (ceil(P / 16), ceil(Q / (2 warps))): block (x, y) takes rows
// 16 x .. and the quads y * 2 warps .., two a warp
__global__ void __launch_bounds__(32 * kMaxWarps)
cardinality_predict_kernel(const float* __restrict__ log_cn,
                           const float* __restrict__ log_b,
                           float* __restrict__ out, int P, int C1) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Q = quads(C1);
  const int nw = block_warps(C1);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, P - row0);
  uint64_t* bar;
  float* lin = const_cast<float*>(phd::stage_slab(
      log_cn + static_cast<size_t>(row0) * C1, rows * C1, smem, &bar));
  float* ez = reinterpret_cast<float*>(smem + slab_bytes(C1));
  float* mxs = ez + C1 + kQuad * Q;

  // while the slab arrives: bmax, taken by every warp (the same bits in
  // each), then e
  float bmax = -INFINITY;
  for (int d = lane; d < C1; d += 32) bmax = max_nan(bmax, log_b[d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    bmax = max_nan(bmax, __shfl_xor_sync(kFull, bmax, off));
  for (int i = threadIdx.x; i < C1 + kQuad * Q; i += blockDim.x) {
    const int d = i - C1;
    float v = 0.f;
    if (d >= 0 && d < C1) {
      const float x = log_b[d] - bmax;
      v = expf(x);
    }
    ez[i] = v;
  }
  __syncthreads();                      // the slab's head and tail
  phd::mbar_wait(bar, 0);               // its bulk-copied middle
  // a warp two rows at once (r and r + nw): the max, then lin in place
  // (0 on rows past P)
  for (int r = warp; r < kRows; r += 2 * nw) {
    const int r2 = r + nw < kRows ? r + nw : r;
    const bool v1 = r < rows, v2 = r2 != r && r2 < rows;
    float* l1 = lin + r * C1;
    float* l2 = lin + r2 * C1;
    float m1 = -INFINITY, m2 = -INFINITY;
    for (int c = lane; c < C1; c += 32) {
      if (v1) m1 = max_nan(m1, l1[c]);
      if (v2) m2 = max_nan(m2, l2[c]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      m1 = max_nan(m1, __shfl_xor_sync(kFull, m1, off));
      m2 = max_nan(m2, __shfl_xor_sync(kFull, m2, off));
    }
    const float mx1 = v1 ? m1 : 0.f, mx2 = v2 ? m2 : 0.f;
    for (int c = lane; c < C1; c += 32) {
      const float x1 = l1[c] - mx1;
      l1[c] = v1 ? expf(x1) : 0.f;
      if (r2 != r) {
        const float x2 = l2[c] - mx2;
        l2[c] = v2 ? expf(x2) : 0.f;
      }
    }
    if (lane == 0) {
      mxs[r] = mx1;
      mxs[r2] = r2 != r ? mx2 : mx1;
    }
  }
  __syncthreads();

  // a lane a row and a quad
  const int r = lane & (kRows - 1);
  const int q = (blockIdx.y * nw + warp) * 2 + (lane >> 4);
  if (q >= Q) return;
  const float mx = mxs[r];
  const float* lr = lin + r * C1;
  const int n0 = kQuad * q;
  const int trips = isfinite(mx) ? min(n0 + kQuad, C1) : C1;
  const float* e = ez + C1 + n0;        // T[j, n0 + k] = e[k - j]
  float w0 = e[0], w1 = e[1], w2 = e[2], w3 = e[3];
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  int j = 0;
  for (; j + 4 <= trips; j += 4) {
    // terms j .. j + 3: lin[j + i] and x_i = e[-j - 1 - i], which enters
    // the window after term j + i
    const float l0 = lr[j], l1 = lr[j + 1], l2 = lr[j + 2], l3 = lr[j + 3];
    const float x0 = e[-j - 1], x1 = e[-j - 2], x2 = e[-j - 3],
                x3 = e[-j - 4];
    a0 = a0 + l0 * w0;
    a1 = a1 + l0 * w1;
    a2 = a2 + l0 * w2;
    a3 = a3 + l0 * w3;
    a0 = a0 + l1 * x0;
    a1 = a1 + l1 * w0;
    a2 = a2 + l1 * w1;
    a3 = a3 + l1 * w2;
    a0 = a0 + l2 * x1;
    a1 = a1 + l2 * x0;
    a2 = a2 + l2 * w0;
    a3 = a3 + l2 * w1;
    a0 = a0 + l3 * x2;
    a1 = a1 + l3 * x1;
    a2 = a2 + l3 * x0;
    a3 = a3 + l3 * w0;
    w0 = x3;
    w1 = x2;
    w2 = x1;
    w3 = x0;
  }
  for (; j < trips; ++j) {
    const float l = lr[j];
    a0 = a0 + l * w0;
    a1 = a1 + l * w1;
    a2 = a2 + l * w2;
    a3 = a3 + l * w3;
    w3 = w2;
    w2 = w1;
    w1 = w0;
    w0 = e[-j - 1];
  }
  if (r >= rows) return;
  float* o = out + static_cast<size_t>(row0 + r) * C1 + n0;
  const int left = C1 - n0;
  o[0] = finish(a0, mx, bmax);
  if (left > 1) o[1] = finish(a1, mx, bmax);
  if (left > 2) o[2] = finish(a2, mx, bmax);
  if (left > 3) o[3] = finish(a3, mx, bmax);
}

}  // namespace

// log_cn float[P, C1], log_b float[C1], out float[P, C1], all contiguous
// on the current device; 0 or the CUDA error
extern "C" int phd_cardinality_predict(const float* log_cn, const float* log_b,
                                       float* out, int P, int C1,
                                       void* stream) {
  if (P <= 0) return 0;
  if (C1 <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(C1);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  static int allowed[phd::kMaxDevices] = {};
  const cudaError_t err = phd::allow_smem(cardinality_predict_kernel,
                                          static_cast<int>(smem), allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nw = block_warps(C1);
  const dim3 grid((P + kRows - 1) / kRows,
                  (quads(C1) + 2 * nw - 1) / (2 * nw));
  cardinality_predict_kernel<<<grid, 32 * nw, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      log_cn, log_b, out, P, C1);
  return static_cast<int>(cudaGetLastError());
}
