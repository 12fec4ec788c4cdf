// Exact sequential greedy moment-matched merge of 3D disparity-space
// Gaussian candidates (u, v, d): the feature map of the monocular SC-PHD
// (disparity) filter.
//
// Replaces phdslam_tpu/ops/pallas_merge.py::_merge_kernel_3d as the
// disparity step runs it (entry gm_merge_pallas_batch_3d, Mahalanobis
// metric; the caller always hands it weight-sorted lanes, which covers both
// of that kernel's modes, see filters/disparity.py). Input planes
// [P, 11, N]: w, act, m0..m2, then the 6 upper-triangle covariance planes
// c00 c01 c02 c11 c12 c22; the active lanes are weight-descending. Each
// cluster: every unmerged lane whose squared Mahalanobis distance to the
// principal (averaged covariance, closed-form adjugate inverse in the
// operation order of the TPU kernel's mahal3, with its |det| > 1e-30
// clamp) is below min_sep joins it; the cluster emits W = sum w,
// mu = sum w m / W and the two-pass covariance sum w (c + dd dd') / W with
// dd = mu - m (W clamped at 1e-30). Output planes [P, 12, K]: w, m0..m2,
// the 6 covariance planes, the count of lanes left unmerged (broadcast),
// one zero pad. The greedy rounds, their exactness and what bounds them
// on Hopper: merge_core.cuh (kR tentative principals a round; at most
// K = 24 clusters over at most 512 lanes on the disparity step).

#include <cuda_runtime.h>

#include "merge_core.cuh"
#include "merge_wide.cuh"

namespace {

constexpr int kR = 8;           // tentative principals a round
constexpr int kWideThreads = 128;  // the staged wide-lane variants

struct Gauss3 {
  static constexpr int kDim = 3;
  static constexpr int kCov = 6;       // c00 c01 c02 c11 c12 c22
  static constexpr int kPlanes = 11;
  static constexpr int kOutPlanes = 12;
  static constexpr bool kHellinger = false;

  // d' S^-1 d for the averaged covariance S, operation for operation as
  // pallas_merge.py's mahal3 (kFast: Recip's quotients, which clear ok
  // where they are not the IEEE ones)
  template <bool kFast>
  __device__ __forceinline__ static float dist(const float (&d)[3],
                                               const float (&s)[6],
                                               bool& ok) {
    using Div = std::conditional_t<kFast, phd_merge::Recip,
                                   phd_merge::Divide>;
    const float s00 = s[0], s01 = s[1], s02 = s[2];
    const float s11 = s[3], s12 = s[4], s22 = s[5];
    const Div dv(phd_merge::clamp_det(s00 * (s11 * s22 - s12 * s12)
                                      - s01 * (s01 * s22 - s12 * s02)
                                      + s02 * (s01 * s12 - s11 * s02)),
                 ok);
    const float i00 = dv(s11 * s22 - s12 * s12, ok);
    const float i01 = dv(s02 * s12 - s01 * s22, ok);
    const float i02 = dv(s01 * s12 - s02 * s11, ok);
    const float i11 = dv(s00 * s22 - s02 * s02, ok);
    const float i12 = dv(s01 * s02 - s00 * s12, ok);
    const float i22 = dv(s00 * s11 - s01 * s01, ok);
    return (d[0] * d[0] * i00 + d[1] * d[1] * i11 + d[2] * d[2] * i22
            + 2.f * (d[0] * d[1] * i01 + d[0] * d[2] * i02
                     + d[1] * d[2] * i12));
  }
};

// The determinant of the symmetric 3x3 matrix of upper triangle s, by
// cofactors along the first row
__device__ __forceinline__ float det3(const float (&s)[6]) {
  return s[0] * (s[3] * s[5] - s[4] * s[4]) - s[1] * (s[1] * s[5] - s[4] * s[2])
         + s[2] * (s[1] * s[4] - s[3] * s[2]);
}

// The Hellinger distance (merge_core.cuh::hell_tail), the quadratic form
// through the adjugate of A + B, as ops/math.py::hellinger2 at D = 3
struct Hell3 : Gauss3 {
  static constexpr bool kHellinger = true;

  __device__ __forceinline__ static float hell(const float (&d)[3],
                                               const float (&a)[6],
                                               const float (&b)[6]) {
    float s[6];
#pragma unroll
    for (int q = 0; q < 6; ++q) s[q] = a[q] + b[q];
    const float s00 = s[0], s01 = s[1], s02 = s[2];
    const float s11 = s[3], s12 = s[4], s22 = s[5];
    const float det_s = det3(s);
    const float j00 = s11 * s22 - s12 * s12;
    const float j01 = s02 * s12 - s01 * s22;
    const float j02 = s01 * s12 - s02 * s11;
    const float j11 = s00 * s22 - s02 * s02;
    const float j12 = s01 * s02 - s00 * s12;
    const float j22 = s00 * s11 - s01 * s01;
    const float q = d[0] * d[0] * j00 + d[1] * d[1] * j11 + d[2] * d[2] * j22
                    + 2.f * (d[0] * d[1] * j01 + d[0] * d[2] * j02
                             + d[1] * d[2] * j12);
    const float quad_eye = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
    return phd_merge::hell_tail<3>(det_s, det3(a) * det3(b),
                                   q / phd_merge::hell_det_safe(det_s),
                                   quad_eye);
  }
};

}  // namespace

// metric 0: Mahalanobis, 1: Hellinger, on sorted lanes. The argmax mode
// (argmax 1) is merge_core.cuh's template argument, not instantiated here:
// the disparity path hands merge3d sorted lanes (filters/disparity.py).
extern "C" int phd_merge3d(const float* packed, float* out, int P, int N,
                           int K, float min_sep, int argmax, int metric,
                           void* stream) {
  if (argmax || (metric != 0 && metric != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (metric == 1)
    return phd_merge::launch<Hell3, kR>(packed, out, P, N, K, min_sep,
                                         stream);
  return phd_merge::launch<Gauss3, kR>(packed, out, P, N, K, min_sep,
                                        stream);
}

// The launch plan for P particles of N lanes, into out[7] (merge_core.cuh)
extern "C" int phd_merge3d_plan(int P, int N, int argmax, int metric,
                                int* out) {
  if (argmax || (metric != 0 && metric != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (metric == 1) return phd_merge::plan<Hell3, kR>(P, N, out);
  return phd_merge::plan<Gauss3, kR>(P, N, out);
}

namespace {

// The wide variants (merge_wide.cuh) of phd_merge3d's: sorted lanes,
// either metric
int run_wide(const float* packed, float* out, float* spill,
             unsigned char* gstate, int P, int N, int K, float min_sep,
             int argmax, int metric, void* stream, phd_wide::Plan* report) {
  if (argmax || (metric != 0 && metric != 1) || N < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (metric == 1)
    return phd_wide::launch<Hell3, kWideThreads, kR, false>(
        packed, out, spill, gstate, P, N, K, min_sep, stream, report);
  return phd_wide::launch<Gauss3, kWideThreads, kR, false>(
      packed, out, spill, gstate, P, N, K, min_sep, stream, report);
}

}  // namespace

// The staged wide-lane variant at any N (the wrapper takes it above
// 2048): spill float[P, 10, X] and gstate uint8[P, X] are scratch for the
// entries past the plan's shared ones (X: its overflow; null when 0)
extern "C" int phd_merge3d_wide(const float* packed, float* out,
                                float* spill, unsigned char* gstate, int P,
                                int N, int K, float min_sep, int argmax,
                                int metric, void* stream) {
  if (P <= 0 || K <= 0) return 0;
  return run_wide(packed, out, spill, gstate, P, N, K, min_sep, argmax,
                  metric, stream, nullptr);
}

// The wide variants' launch plan, into out[7] (merge_core.cuh's layout)
extern "C" int phd_merge3d_wide_plan(int P, int N, int argmax, int metric,
                                     int* out) {
  phd_wide::Plan plan{};
  const int err = run_wide(nullptr, nullptr, nullptr, nullptr, P, N, 1, 0.f,
                           argmax, metric, nullptr, &plan);
  if (err) return err;
  phd_wide::plan_out(plan, out);
  return 0;
}
