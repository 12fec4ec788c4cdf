// Exact sequential greedy moment-matched merge of 2D Gaussian candidates.
//
// Replaces phdslam_tpu/ops/pallas_merge.py::_merge_kernel -> _merge_core_2d
// in its four variants: the principal is the first unmerged lane
// (sorted_w=True: active lanes weight-descending, top-cap-compacted) or the
// argmax of w over the unmerged lanes, ties to the lowest lane
// (sorted_w=False: any lane order, the full candidate grid); the distance
// is the squared Mahalanobis distance with averaged covariance (metric 0)
// or the Hellinger form (metric 1, with the tiny-determinant identity
// fallback of ops/math.py::hellinger2), operation for operation as the
// Pallas kernel's pair_dist. Input planes [P, 7, N]: w, act, mean x, mean
// y, cov 00, 01, 11. Each trip: every unmerged lane within min_sep of the
// principal joins it; their moment-matched merge is emitted into the next
// output slot. Output planes [P, 8, K]: w, mean x, mean y, cov 00, 01, 11,
// then the count of lanes left unmerged (broadcast), then 0. Empty slots
// hold w 0, mean 0 and identity covariance.
//
// Which lanes enter: sorted mode takes act & w > 0, so NaN and w <= 0
// lanes never enter. Argmax mode takes every act lane, as the Pallas
// kernel does: a lane with w <= 0 can be absorbed but never leads, and the
// row stalls (its remaining lanes are dropped, not counted as left) once
// no unmerged lane has w > 0 or any unmerged lane's w is NaN (jnp.argmax
// picks the NaN, whose max > 0 test fails). The two modes differ only in
// the leftover count when out_cap binds and in rows holding NaN. Every
// trip emits its principal, so the loop ends after at most K trips.
//
// What bounds it on Hopper: the greedy loop is sequential in the clusters
// (tens to ~130 trips per particle), and each trip touches only the
// particle's live lanes, so it is bound by the latency of two block-wide
// reductions per trip, not by bytes or FLOPs. Design: one block per
// particle, 64 threads (2 warps) up to N = 2048 and 256 threads (8 warps)
// up to N = 8192 (the full grid K + M K + M = 6320 at K = 128, M = 48); each
// thread owns lanes tid + threads * j and tracks them as a 32-bit mask, so
// a trip visits only still-unmerged lanes (the live count, not the padded
// width N, sets the cost). The act plane is read once; the other six
// planes are read into shared memory only for the lanes that enter (5-15%
// of the full grid), with the planes sized to N in dynamic shared memory
// (up to 192 KB, opted into above 48 KB). The next principal falls out of
// the trip's second reduction: the lowest unmerged lane (sorted) or the
// (w descending, lane ascending) maximum with a NaN flag (argmax). The TPU
// kernel's R-principals-per-trip validity chain and lane cumsum existed to
// amortise its per-trip control overhead and are not needed here.
//
// merge2d_tables_kernel replaces pallas_merge.py::_merge_tables_kernel
// (fused_gather_merge, entry gm_merge_pallas_batch_tables) in sorted mode
// with either metric: the same greedy core, staged straight from the
// deferred-gather tables, so the packed [P, 7, N] planes, the two column
// gathers and the combine of the two-kernel route never exist. Built with
// --fmad=false and the two-kernel route's order of terms, it reproduces
// that route bit for bit on the lanes that enter, except for a bearing
// innovation at +-pi, where its floor-form wrap (the Pallas kernel's) and
// the combine's C-fmod wrap can differ.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

#include "wrap.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kPlanes = 6;     // w, mean x, mean y, cov 00, 01, 11
constexpr int kTablesK = 16;   // t_k rows (the fused route)
constexpr int kTablesM = 8;    // t_m rows

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

// (w descending, lane ascending): does (wa, ia) come before (wb, ib)?
__device__ __forceinline__ bool heavier(float wa, int ia, float wb, int ib) {
  return wa > wb || (wa == wb && ia < ib);
}

__device__ __forceinline__ void warp_best(float& w, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ow = __shfl_xor_sync(0xffffffffu, w, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (heavier(ow, oi, w, i)) {
      w = ow;
      i = oi;
    }
  }
}

template <int kMetric>
__device__ __forceinline__ float pair_dist(float dx, float dy, float a00,
                                           float a01, float a11, float b00,
                                           float b01, float b11) {
  if (kMetric == 0) {
    const float s00 = 0.5f * (a00 + b00);
    const float s01 = 0.5f * (a01 + b01);
    const float s11 = 0.5f * (a11 + b11);
    const float det = fmaxf(s00 * s11 - s01 * s01, 1e-30f);
    return (dx * dx * s11 - 2.f * dx * dy * s01 + dy * dy * s00) / det;
  }
  const float s00 = a00 + b00;
  const float s01 = a01 + b01;
  const float s11 = a11 + b11;
  const float det_s = s00 * s11 - s01 * s01;
  const bool ok = det_s > 1.1754944e-38f;
  const float det_safe = ok ? det_s : 1.f;
  const float quad_inv =
      (dx * dx * s11 - 2.f * dx * dy * s01 + dy * dy * s00) / det_safe;
  const float quad_eye = dx * dx + dy * dy;
  const float eps = -0.25f * (ok ? quad_inv : quad_eye);
  const float det_half = det_s / 4.f;
  const float det_prod = (a00 * a11 - a01 * a01) * (b00 * b11 - b01 * b01);
  const float ratio = sqrtf(fmaxf(det_prod, 0.f)) / fmaxf(det_half, 1e-30f);
  return 1.f - sqrtf(fmaxf(ratio, 0.f)) * expf(eps);
}

// The principal among the block's unmerged lanes (``own`` per thread), or
// INT_MAX when there is none: the lowest lane (sorted mode), or the
// heaviest lane when its weight is > 0 and no unmerged weight is NaN
// (argmax mode). Ends with a __syncthreads after which every thread reads
// the partials; the next writes come after the trip's next barrier.
template <int kThreads, bool kArgmax>
__device__ __forceinline__ int block_principal(unsigned own, const float* w,
                                               int tid, float* red_w,
                                               int* red_i, int* red_nan) {
  constexpr int kWarps = kThreads / 32;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (!kArgmax) {
    const int first =
        warp_min(own ? tid + (__ffs(own) - 1) * kThreads : INT_MAX);
    if (lane == 0) red_i[warp] = first;
    __syncthreads();
    int head = red_i[0];
#pragma unroll
    for (int q = 1; q < kWarps; ++q) head = min(head, red_i[q]);
    return head;
  }
  float bw = -INFINITY;
  int bi = INT_MAX;
  bool nan_seen = false;
  for (unsigned b = own; b; b &= b - 1) {      // lanes ascending
    const int i = tid + kThreads * (__ffs(b) - 1);
    const float wi = w[i];
    if (isnan(wi)) {
      nan_seen = true;
    } else if (wi > bw) {
      bw = wi;
      bi = i;
    }
  }
  warp_best(bw, bi);
  const bool warp_nan = __any_sync(0xffffffffu, nan_seen);
  if (lane == 0) {
    red_w[warp] = bw;
    red_i[warp] = bi;
    red_nan[warp] = warp_nan;
  }
  __syncthreads();
  bw = red_w[0];
  bi = red_i[0];
  bool any_nan = red_nan[0];
#pragma unroll
  for (int q = 1; q < kWarps; ++q) {
    if (heavier(red_w[q], red_i[q], bw, bi)) {
      bw = red_w[q];
      bi = red_i[q];
    }
    any_nan = any_nan || red_nan[q];
  }
  return (!any_nan && bw > 0.f) ? bi : INT_MAX;
}

// The block's shared scratch for the trip reductions
template <int kWarps>
struct Scratch {
  float red[2][kWarps][3];                      // double-buffered partials
  float red_w[kWarps];                          // principal partials
  int red_i[kWarps];
  int red_nan[kWarps];
  int red_left[kWarps];
};

// The greedy loop over the staged planes s = [w, mean x, mean y, cov 00,
// 01, 11] x N (``own``: this thread's entering lanes), writing the
// particle's output planes o [8, K]. Shared by both kernels below, so the
// packed and the table routes run one core.
template <int kThreads, bool kArgmax, int kMetric>
__device__ __forceinline__ void greedy_merge(unsigned own, const float* s,
                                             float* o, int N, int K,
                                             float min_sep,
                                             Scratch<kThreads / 32>& sc) {
  constexpr int kWarps = kThreads / 32;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* w = s;
  const float* mx = s + N;
  const float* my = s + 2 * N;
  const float* c00 = s + 3 * N;
  const float* c01 = s + 4 * N;
  const float* c11 = s + 5 * N;

  // (the reduction's barrier also publishes the staged planes)
  int head = block_principal<kThreads, kArgmax>(own, w, tid, sc.red_w,
                                                sc.red_i, sc.red_nan);
  int c = 0;
  while (head != INT_MAX && c < K) {
    const float pmx = mx[head], pmy = my[head];
    const float p00 = c00[head], p01 = c01[head], p11 = c11[head];

    // membership + zeroth/first moments
    unsigned sel = 0;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f;
    for (unsigned b = own; b; b &= b - 1) {
      const int j = __ffs(b) - 1;
      const int i = tid + kThreads * j;
      const float d = pair_dist<kMetric>(pmx - mx[i], pmy - my[i], c00[i],
                                         c01[i], c11[i], p00, p01, p11);
      if (d < min_sep || i == head) {
        sel |= 1u << j;
        const float wi = w[i];
        a0 += wi;
        a1 += wi * mx[i];
        a2 += wi * my[i];
      }
    }
    a0 = warp_sum(a0);
    a1 = warp_sum(a1);
    a2 = warp_sum(a2);
    if (lane == 0) {
      sc.red[0][warp][0] = a0;
      sc.red[0][warp][1] = a1;
      sc.red[0][warp][2] = a2;
    }
    __syncthreads();
    float W = 0.f, sx = 0.f, sy = 0.f;
#pragma unroll
    for (int q = 0; q < kWarps; ++q) {
      W += sc.red[0][q][0];
      sx += sc.red[0][q][1];
      sy += sc.red[0][q][2];
    }
    own &= ~sel;
    const float w_safe = fmaxf(W, 1e-30f);
    const float mux = sx / w_safe;
    const float muy = sy / w_safe;

    // second moments about the merged mean + next principal
    float b0 = 0.f, b1 = 0.f, b2 = 0.f;
    for (unsigned b = sel; b; b &= b - 1) {
      const int i = tid + kThreads * (__ffs(b) - 1);
      const float ddx = mux - mx[i];
      const float ddy = muy - my[i];
      const float wi = w[i];
      b0 += wi * (c00[i] + ddx * ddx);
      b1 += wi * (c01[i] + ddx * ddy);
      b2 += wi * (c11[i] + ddy * ddy);
    }
    b0 = warp_sum(b0);
    b1 = warp_sum(b1);
    b2 = warp_sum(b2);
    if (lane == 0) {
      sc.red[1][warp][0] = b0;
      sc.red[1][warp][1] = b1;
      sc.red[1][warp][2] = b2;
    }
    // (the principal's barrier also publishes red[1])
    head = block_principal<kThreads, kArgmax>(own, w, tid, sc.red_w,
                                              sc.red_i, sc.red_nan);
    float m00 = 0.f, m01 = 0.f, m11 = 0.f;
#pragma unroll
    for (int q = 0; q < kWarps; ++q) {
      m00 += sc.red[1][q][0];
      m01 += sc.red[1][q][1];
      m11 += sc.red[1][q][2];
    }
    if (tid == 0) {
      o[c] = W;
      o[K + c] = mux;
      o[2 * K + c] = muy;
      o[3 * K + c] = m00 / w_safe;
      o[4 * K + c] = m01 / w_safe;
      o[5 * K + c] = m11 / w_safe;
    }
    ++c;
  }
  // a row that stalled with budget left drops its remaining lanes (argmax
  // mode; in sorted mode nothing is left then)
  if (c < K) own = 0;

  const int left = static_cast<int>(warp_sum(static_cast<float>(__popc(own))));
  if (lane == 0) sc.red_left[warp] = left;
  __syncthreads();
  int n_left = 0;
#pragma unroll
  for (int q = 0; q < kWarps; ++q) n_left += sc.red_left[q];
  for (int k = c + tid; k < K; k += kThreads) {
    o[k] = 0.f;
    o[K + k] = 0.f;
    o[2 * K + k] = 0.f;
    o[3 * K + k] = 1.f;
    o[4 * K + k] = 0.f;
    o[5 * K + k] = 1.f;
  }
  for (int k = tid; k < K; k += kThreads) {
    o[6 * K + k] = static_cast<float>(n_left);
    o[7 * K + k] = 0.f;
  }
}

// Packed planes [P, 7, N] in: the act plane is read for every lane, the
// other six only for the lanes that enter.
template <int kThreads, bool kArgmax, int kMetric>
__global__ void __launch_bounds__(kThreads)
merge2d_kernel(const float* __restrict__ packed, float* __restrict__ out,
               int N, int K, float min_sep) {
  extern __shared__ float s[];                  // [kPlanes, N]
  __shared__ Scratch<kThreads / 32> sc;
  const int tid = threadIdx.x;
  const float* in = packed + static_cast<size_t>(blockIdx.x) * 7 * N;

  // bit j of own: lane tid + kThreads * j is still unmerged. Only the
  // lanes that enter are ever read again, so only theirs are staged.
  unsigned own = 0;
  for (int j = 0; tid + kThreads * j < N; ++j) {
    const int i = tid + kThreads * j;
    if (!(in[N + i] > 0.5f)) continue;
    const float wi = in[i];
    if (!kArgmax && !(wi > 0.f)) continue;
    own |= 1u << j;
    s[i] = wi;
    for (int c = 1; c < kPlanes; ++c) s[c * N + i] = in[(c + 1) * N + i];
  }
  greedy_merge<kThreads, kArgmax, kMetric>(
      own, s, out + static_cast<size_t>(blockIdx.x) * 8 * K, N, K, min_sep,
      sc);
}

// The fused gather + combine + merge (sorted mode): lanes from the
// deferred-gather tables instead of packed planes. ints [P, 4, N] (k_eff,
// m_eff, is_p, is_d), flts [P, 2, N] (cand_w, sel_act), t_k [P, 16, Kt]
// rows mean 0-1 | cov row-major 2-5 | cov_upd 6-9 | gain 10-13 | r 14 |
// bearing 15, t_m [P, 8, Mt] rows zr | zb | birth mean 2-3 | birth cov
// 4-7. A lane enters when sel_act and w > 0; its table columns are read
// from device memory (a particle's tables, 8-64 KB, stay in L2) and
// combined as ops/ekf.py::combine_selected_planes does, with the Pallas
// kernel's floor-form bearing wrap; an index outside its table reads 0,
// as gather_cols does.
template <int kThreads, int kMetric>
__global__ void __launch_bounds__(kThreads)
merge2d_tables_kernel(const int* __restrict__ ints,
                      const float* __restrict__ flts,
                      const float* __restrict__ tk,
                      const float* __restrict__ tm, float* __restrict__ out,
                      int N, int Kt, int Mt, int K, float min_sep) {
  extern __shared__ float s[];                  // [kPlanes, N]
  __shared__ Scratch<kThreads / 32> sc;
  const int tid = threadIdx.x;
  const size_t p = blockIdx.x;
  const int* ip = ints + p * 4 * N;
  const float* fp = flts + p * 2 * N;
  const float* tkp = tk + p * kTablesK * Kt;
  const float* tmp = tm + p * kTablesM * Mt;

  unsigned own = 0;
  for (int j = 0; tid + kThreads * j < N; ++j) {
    const int i = tid + kThreads * j;
    if (!(fp[N + i] > 0.5f)) continue;
    const float wi = fp[i];
    if (!(wi > 0.f)) continue;
    own |= 1u << j;
    const int k = ip[i];
    const int m = ip[N + i];
    const bool k_ok = k >= 0 && k < Kt;
    const bool m_ok = m >= 0 && m < Mt;
    auto tkv = [&](int c) { return k_ok ? tkp[c * Kt + k] : 0.f; };
    auto tmv = [&](int c) { return m_ok ? tmp[c * Mt + m] : 0.f; };
    float vx, vy, v00, v01, v11;
    if (ip[2 * N + i] > 0) {                    // persistent
      vx = tkv(0);
      vy = tkv(1);
      v00 = tkv(2);
      v01 = tkv(3);
      v11 = tkv(5);
    } else if (ip[3 * N + i] > 0) {             // detection
      const float innov_r = tmv(0) - tkv(14);
      const float innov_b = phd::wrap_angle_floor(tmv(1) - tkv(15));
      vx = tkv(0) + tkv(10) * innov_r + tkv(11) * innov_b;
      vy = tkv(1) + tkv(12) * innov_r + tkv(13) * innov_b;
      v00 = tkv(6);
      v01 = tkv(7);
      v11 = tkv(9);
    } else {                                    // birth
      vx = tmv(2);
      vy = tmv(3);
      v00 = tmv(4);
      v01 = tmv(5);
      v11 = tmv(7);
    }
    s[i] = wi;
    s[N + i] = vx;
    s[2 * N + i] = vy;
    s[3 * N + i] = v00;
    s[4 * N + i] = v01;
    s[5 * N + i] = v11;
  }
  greedy_merge<kThreads, false, kMetric>(own, s, out + p * 8 * K, N, K,
                                         min_sep, sc);
}

template <int kThreads, bool kArgmax, int kMetric>
int launch(const float* packed, float* out, int P, int N, int K,
           float min_sep, cudaStream_t stream) {
  const size_t smem = sizeof(float) * kPlanes * static_cast<size_t>(N);
  auto* kernel = merge2d_kernel<kThreads, kArgmax, kMetric>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<P, kThreads, smem, stream>>>(packed, out, N, K, min_sep);
  return static_cast<int>(cudaGetLastError());
}

template <int kThreads>
int dispatch(const float* packed, float* out, int P, int N, int K,
             float min_sep, int argmax, int metric, cudaStream_t stream) {
  if (argmax) {
    return metric ? launch<kThreads, true, 1>(packed, out, P, N, K, min_sep,
                                              stream)
                  : launch<kThreads, true, 0>(packed, out, P, N, K, min_sep,
                                              stream);
  }
  return metric ? launch<kThreads, false, 1>(packed, out, P, N, K, min_sep,
                                             stream)
                : launch<kThreads, false, 0>(packed, out, P, N, K, min_sep,
                                             stream);
}

template <int kThreads, int kMetric>
int launch_tables(const int* ints, const float* flts, const float* tk,
                  const float* tm, float* out, int P, int N, int Kt, int Mt,
                  int K, float min_sep, cudaStream_t stream) {
  const size_t smem = sizeof(float) * kPlanes * static_cast<size_t>(N);
  auto* kernel = merge2d_tables_kernel<kThreads, kMetric>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<P, kThreads, smem, stream>>>(ints, flts, tk, tm, out, N, Kt, Mt,
                                         K, min_sep);
  return static_cast<int>(cudaGetLastError());
}

template <int kThreads>
int dispatch_tables(const int* ints, const float* flts, const float* tk,
                    const float* tm, float* out, int P, int N, int Kt,
                    int Mt, int K, float min_sep, int metric,
                    cudaStream_t stream) {
  return metric ? launch_tables<kThreads, 1>(ints, flts, tk, tm, out, P, N,
                                             Kt, Mt, K, min_sep, stream)
                : launch_tables<kThreads, 0>(ints, flts, tk, tm, out, P, N,
                                             Kt, Mt, K, min_sep, stream);
}

}  // namespace

extern "C" int phd_merge2d(const float* packed, float* out, int P, int N,
                           int K, float min_sep, int argmax, int metric,
                           void* stream) {
  if (P <= 0 || K <= 0) return 0;
  if (N < 0 || N > 32 * kMaxThreads || (metric != 0 && metric != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  if (N <= 32 * 64)
    return dispatch<64>(packed, out, P, N, K, min_sep, argmax, metric, st);
  return dispatch<kMaxThreads>(packed, out, P, N, K, min_sep, argmax, metric,
                               st);
}

extern "C" int phd_merge2d_tables(const int* ints, const float* flts,
                                  const float* tk, const float* tm,
                                  float* out, int P, int N, int Kt, int Mt,
                                  int K, float min_sep, int metric,
                                  void* stream) {
  if (P <= 0 || K <= 0) return 0;
  if (N < 0 || N > 32 * kMaxThreads || (metric != 0 && metric != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  if (N <= 32 * 64)
    return dispatch_tables<64>(ints, flts, tk, tm, out, P, N, Kt, Mt, K,
                               min_sep, metric, st);
  return dispatch_tables<kMaxThreads>(ints, flts, tk, tm, out, P, N, Kt, Mt,
                                      K, min_sep, metric, st);
}
