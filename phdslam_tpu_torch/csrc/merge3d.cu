// Exact sequential greedy moment-matched merge of 3D disparity-space
// Gaussian candidates (u, v, d): the feature map of the monocular SC-PHD
// (disparity) filter.
//
// Replaces phdslam_tpu/ops/pallas_merge.py::_merge_kernel_3d as the
// disparity step runs it (entry gm_merge_pallas_batch_3d, Mahalanobis
// metric; the caller always hands it weight-sorted lanes, which covers both
// of that kernel's modes, see filters/disparity.py). Input planes
// [P, 11, N]: w, act, m0..m2, then the 6 upper-triangle covariance planes
// c00 c01 c02 c11 c12 c22; the active lanes are weight-descending, so the
// greedy principal is always the first unmerged lane. Each trip: every
// unmerged lane whose squared Mahalanobis distance to the principal
// (averaged covariance, closed-form adjugate inverse in the operation
// order of the TPU kernel's mahal3, with its |det| > 1e-30 clamp) is below
// min_sep joins it; the trip emits W = sum w, mu = sum w m / W and the
// two-pass covariance sum w (c + dd dd') / W with dd = mu - m (W clamped
// at 1e-30). Output planes [P, 12, K]: w, m0..m2, the 6 covariance planes,
// the count of lanes left unmerged (broadcast), one zero pad. Empty slots
// hold w 0, mean 0 and identity covariance. Lanes with w <= 0 or NaN never
// enter; every trip emits its principal, so the loop ends after at most K
// trips whatever the weights hold.
//
// What bounds it on Hopper: the loop is sequential in the clusters (at most
// K = 24 trips in the disparity step) and each trip touches only the
// particle's unmerged lanes (at most 512 after compaction), so it is bound
// by the latency of two block-wide reductions per trip (4 partial sums,
// then 6 plus the next principal), not by bytes or FLOPs. Design: merge2d.cu
// and merge4d.cu's, at 3D. One block of 64 threads (2 warps) per particle;
// the 11 candidate planes sit in shared memory for the whole loop
// (11 N 4 bytes: 22.5 KB at N = 512); each thread owns lanes tid + 64 j as
// a bit mask of still-unmerged lanes, so a trip costs the live count, not
// N; the next principal falls out of the second reduction. The TPU kernel's
// R-principals-per-trip validity chain and lane cumsum existed to amortise
// its per-trip overhead and are not needed here.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 64;
constexpr int kWarps = kThreads / 32;
constexpr int kPlanes = 11;
constexpr int kOutPlanes = 12;
constexpr int kCov = 6;    // covariance planes, row-major upper triangle

// dd_a dd_b for the 6 (a, b) of the covariance planes, in plane order
__device__ __forceinline__ void outer_upper(const float d[3],
                                            float out[kCov]) {
  out[0] = d[0] * d[0];
  out[1] = d[0] * d[1];
  out[2] = d[0] * d[2];
  out[3] = d[1] * d[1];
  out[4] = d[1] * d[2];
  out[5] = d[2] * d[2];
}

__device__ __forceinline__ bool is_diag(int q) {
  return q == 0 || q == 3 || q == 5;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = min(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ int first_lane(unsigned own, int tid) {
  return own ? tid + (__ffs(own) - 1) * kThreads : INT_MAX;
}

// d' S^-1 d for the averaged covariance S (6 planes), operation for
// operation as pallas_merge.py's mahal3
__device__ __forceinline__ float mahal3(const float d[3],
                                        const float s[kCov]) {
  const float s00 = s[0], s01 = s[1], s02 = s[2];
  const float s11 = s[3], s12 = s[4], s22 = s[5];
  float det = (s00 * (s11 * s22 - s12 * s12)
               - s01 * (s01 * s22 - s12 * s02)
               + s02 * (s01 * s12 - s11 * s02));
  det = fabsf(det) > 1e-30f ? det : 1e-30f;
  const float i00 = (s11 * s22 - s12 * s12) / det;
  const float i01 = (s02 * s12 - s01 * s22) / det;
  const float i02 = (s01 * s12 - s02 * s11) / det;
  const float i11 = (s00 * s22 - s02 * s02) / det;
  const float i12 = (s01 * s02 - s00 * s12) / det;
  const float i22 = (s00 * s11 - s01 * s01) / det;
  return (d[0] * d[0] * i00 + d[1] * d[1] * i11 + d[2] * d[2] * i22
          + 2.f * (d[0] * d[1] * i01 + d[0] * d[2] * i02
                   + d[1] * d[2] * i12));
}

__global__ void __launch_bounds__(kThreads)
merge3d_kernel(const float* __restrict__ packed, float* __restrict__ out,
               int N, int K, float min_sep) {
  extern __shared__ float s[];                  // [11, N]
  __shared__ float red_a[kWarps][4];
  __shared__ float red_b[kWarps][kCov];
  __shared__ int red_next[kWarps];
  __shared__ int red_first[kWarps];
  __shared__ int red_left[kWarps];

  const int p = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* in = packed + static_cast<size_t>(p) * kPlanes * N;
  for (int i = tid; i < kPlanes * N; i += kThreads) s[i] = in[i];
  __syncthreads();
  const float* w = s;
  const float* act = s + N;
  const float* m = s + 2 * N;                   // plane i at m + i * N
  const float* c = s + 5 * N;                   // plane q at c + q * N

  // bit j of own: lane tid + kThreads * j is still unmerged
  unsigned own = 0;
  for (int j = 0; tid + kThreads * j < N; ++j) {
    const int i = tid + kThreads * j;
    if (act[i] > 0.5f && w[i] > 0.f) own |= 1u << j;
  }
  int head = warp_min(first_lane(own, tid));
  if (lane == 0) red_first[warp] = head;
  __syncthreads();
  head = red_first[0];
#pragma unroll
  for (int q = 1; q < kWarps; ++q) head = min(head, red_first[q]);

  float* o = out + static_cast<size_t>(p) * kOutPlanes * K;
  int n_out = 0;
  while (head != INT_MAX && n_out < K) {
    float pm[3], pc[kCov];
#pragma unroll
    for (int i = 0; i < 3; ++i) pm[i] = m[i * N + head];
#pragma unroll
    for (int q = 0; q < kCov; ++q) pc[q] = c[q * N + head];

    // membership + zeroth/first moments
    unsigned sel = 0;
    float a[4] = {0.f, 0.f, 0.f, 0.f};
    for (unsigned b = own; b; b &= b - 1) {
      const int j = __ffs(b) - 1;
      const int i = tid + kThreads * j;
      float d[3], sg[kCov];
#pragma unroll
      for (int k = 0; k < 3; ++k) d[k] = pm[k] - m[k * N + i];
#pragma unroll
      for (int q = 0; q < kCov; ++q) sg[q] = 0.5f * (pc[q] + c[q * N + i]);
      if (mahal3(d, sg) < min_sep || i == head) {
        sel |= 1u << j;
        const float wi = w[i];
        a[0] += wi;
#pragma unroll
        for (int k = 0; k < 3; ++k) a[1 + k] += wi * m[k * N + i];
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) a[k] = warp_sum(a[k]);
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < 4; ++k) red_a[warp][k] = a[k];
    }
    __syncthreads();
    float sum_a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int q = 0; q < kWarps; ++q) {
#pragma unroll
      for (int k = 0; k < 4; ++k) sum_a[k] += red_a[q][k];
    }
    own &= ~sel;
    const float W = sum_a[0];
    const float w_safe = fmaxf(W, 1e-30f);
    float mu[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) mu[k] = sum_a[1 + k] / w_safe;

    // second moments about the merged mean + next principal
    float bsum[kCov];
#pragma unroll
    for (int q = 0; q < kCov; ++q) bsum[q] = 0.f;
    for (unsigned b = sel; b; b &= b - 1) {
      const int i = tid + kThreads * (__ffs(b) - 1);
      float dd[3], spread[kCov];
#pragma unroll
      for (int k = 0; k < 3; ++k) dd[k] = mu[k] - m[k * N + i];
      outer_upper(dd, spread);
      const float wi = w[i];
#pragma unroll
      for (int q = 0; q < kCov; ++q)
        bsum[q] += wi * (c[q * N + i] + spread[q]);
    }
#pragma unroll
    for (int q = 0; q < kCov; ++q) bsum[q] = warp_sum(bsum[q]);
    const int nxt = warp_min(first_lane(own, tid));
    if (lane == 0) {
#pragma unroll
      for (int q = 0; q < kCov; ++q) red_b[warp][q] = bsum[q];
      red_next[warp] = nxt;
    }
    __syncthreads();
    head = INT_MAX;
#pragma unroll
    for (int q = 0; q < kWarps; ++q) head = min(head, red_next[q]);
    if (tid == 0) {
      o[n_out] = W;
#pragma unroll
      for (int k = 0; k < 3; ++k) o[(1 + k) * K + n_out] = mu[k];
#pragma unroll
      for (int q = 0; q < kCov; ++q) {
        float v = 0.f;
#pragma unroll
        for (int r = 0; r < kWarps; ++r) v += red_b[r][q];
        o[(4 + q) * K + n_out] = v / w_safe;
      }
    }
    ++n_out;
    // no third barrier: red_a is read only between this trip's two
    // barriers and rewritten after them; red_b / red_next are read here and
    // rewritten only after the next trip's first barrier
  }

  const int left = static_cast<int>(warp_sum(static_cast<float>(__popc(own))));
  if (lane == 0) red_left[warp] = left;
  __syncthreads();
  int n_left = 0;
#pragma unroll
  for (int q = 0; q < kWarps; ++q) n_left += red_left[q];
  for (int k = n_out + tid; k < K; k += kThreads) {
    for (int r = 0; r < 4; ++r) o[r * K + k] = 0.f;
#pragma unroll
    for (int q = 0; q < kCov; ++q)
      o[(4 + q) * K + k] = is_diag(q) ? 1.f : 0.f;
  }
  for (int k = tid; k < K; k += kThreads) {
    o[10 * K + k] = static_cast<float>(n_left);
    o[11 * K + k] = 0.f;
  }
}

}  // namespace

extern "C" int phd_merge3d(const float* packed, float* out, int P, int N,
                           int K, float min_sep, void* stream) {
  if (P <= 0 || K <= 0) return 0;
  if (N < 0 || N > 32 * kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * kPlanes * static_cast<size_t>(N);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        merge3d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  merge3d_kernel<<<P, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      packed, out, N, K, min_sep);
  return static_cast<int>(cudaGetLastError());
}
