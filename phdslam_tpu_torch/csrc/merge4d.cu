// Exact sequential greedy moment-matched merge of 4D constant-velocity
// Gaussian candidates (x, y, vx, vy): the dynamic map of the mixed
// jump-Markov filter.
//
// Replaces phdslam_tpu/ops/pallas_merge.py::_merge_kernel_4d as the mixed
// fast path runs it (entry gm_merge_pallas_batch_packed_4d, sorted_w=True,
// Mahalanobis metric). Input planes [P, 16, N]: w, act, m0..m3, then the 10
// upper-triangle covariance planes c00 c01 c02 c03 c11 c12 c13 c22 c23 c33;
// the active lanes are weight-descending (top-cap-compacted). Each cluster:
// every unmerged lane whose squared Mahalanobis distance to the principal
// (averaged covariance, in the 2x2-block Schur form of the TPU kernel's
// mahal4, with its |det| > 1e-30 clamps) is below min_sep joins it; the
// cluster emits W = sum w, mu = sum w m / W and the two-pass covariance
// sum w (c + dd dd') / W with dd = mu - m. Output planes [P, 16, K]: w,
// m0..m3, the 10 covariance planes, then the count of lanes left unmerged
// (broadcast). The greedy rounds, their exactness and what bounds them on
// Hopper: merge_core.cuh (kR tentative principals a round).

#include <cuda_runtime.h>

#include "merge_core.cuh"
#include "merge_wide.cuh"

namespace {

constexpr int kR = 8;           // tentative principals a round
// the staged wide-lane variants: 128 threads a block, 4 tentative
// principals a round (faster than 8 on the mixed full grid's captured
// step, merge_bench.py)
constexpr int kWideThreads = 128;
constexpr int kWideR = 4;

struct Gauss4 {
  static constexpr int kDim = 4;
  static constexpr int kCov = 10;      // _PAIRS4 order
  static constexpr int kPlanes = 16;
  static constexpr int kOutPlanes = 16;
  static constexpr bool kHellinger = false;

  // d' S^-1 d for the averaged covariance S, operation for operation as
  // pallas_merge.py's mahal4 (kFast: Recip's quotients, which clear ok
  // where they are not the IEEE ones)
  template <bool kFast>
  __device__ __forceinline__ static float dist(const float (&d)[4],
                                               const float (&s)[10],
                                               bool& ok) {
    using Div = std::conditional_t<kFast, phd_merge::Recip,
                                   phd_merge::Divide>;
    const float s00 = s[0], s01 = s[1], s02 = s[2], s03 = s[3], s11 = s[4];
    const float s12 = s[5], s13 = s[6], s22 = s[7], s23 = s[8], s33 = s[9];
    const Div da(phd_merge::clamp_det(s00 * s11 - s01 * s01), ok);
    const float ai00 = da(s11, ok);
    const float ai01 = da(-s01, ok);
    const float ai11 = da(s00, ok);
    const float g00 = ai00 * s02 + ai01 * s12;
    const float g01 = ai00 * s03 + ai01 * s13;
    const float g10 = ai01 * s02 + ai11 * s12;
    const float g11 = ai01 * s03 + ai11 * s13;
    const float m00 = s22 - (s02 * g00 + s12 * g10);
    const float m01 = s23 - (s02 * g01 + s12 * g11);
    const float m11 = s33 - (s03 * g01 + s13 * g11);
    const Div dm(phd_merge::clamp_det(m00 * m11 - m01 * m01), ok);
    const float mi00 = dm(m11, ok);
    const float mi01 = dm(-m01, ok);
    const float mi11 = dm(m00, ok);
    const float v0 = ai00 * d[0] + ai01 * d[1];
    const float v1 = ai01 * d[0] + ai11 * d[1];
    const float pap = d[0] * v0 + d[1] * v1;
    const float u0 = s02 * v0 + s12 * v1 - d[2];
    const float u1 = s03 * v0 + s13 * v1 - d[3];
    return pap + (u0 * u0 * mi00 + 2.f * u0 * u1 * mi01 + u1 * u1 * mi11);
  }
};

// The determinant of the symmetric 4x4 matrix of upper triangle s
// (_PAIRS4 order), by the 2x2 minors of rows 0-1 and rows 2-3 (Laplace)
__device__ __forceinline__ float det4(const float (&s)[10]) {
  const float r0[4] = {s[0], s[1], s[2], s[3]};
  const float r1[4] = {s[1], s[4], s[5], s[6]};
  const float r2[4] = {s[2], s[5], s[7], s[8]};
  const float r3[4] = {s[3], s[6], s[8], s[9]};
  const float a01 = r0[0] * r1[1] - r0[1] * r1[0];
  const float a02 = r0[0] * r1[2] - r0[2] * r1[0];
  const float a03 = r0[0] * r1[3] - r0[3] * r1[0];
  const float a12 = r0[1] * r1[2] - r0[2] * r1[1];
  const float a13 = r0[1] * r1[3] - r0[3] * r1[1];
  const float a23 = r0[2] * r1[3] - r0[3] * r1[2];
  const float b01 = r2[0] * r3[1] - r2[1] * r3[0];
  const float b02 = r2[0] * r3[2] - r2[2] * r3[0];
  const float b03 = r2[0] * r3[3] - r2[3] * r3[0];
  const float b12 = r2[1] * r3[2] - r2[2] * r3[1];
  const float b13 = r2[1] * r3[3] - r2[3] * r3[1];
  const float b23 = r2[2] * r3[3] - r2[3] * r3[2];
  return a01 * b23 - a02 * b13 + a03 * b12 + a12 * b03 - a13 * b02
         + a23 * b01;
}

// The Hellinger distance (merge_core.cuh::hell_tail), as
// ops/math.py::hellinger2 at D = 4: the determinants by 2x2 minors, the
// quadratic form in mahal4's Schur form of A + B (its 1e-30 clamps)
struct Hell4 : Gauss4 {
  static constexpr bool kHellinger = true;

  __device__ __forceinline__ static float hell(const float (&d)[4],
                                               const float (&a)[10],
                                               const float (&b)[10]) {
    float s[10];
#pragma unroll
    for (int q = 0; q < 10; ++q) s[q] = a[q] + b[q];
    const float det_s = det4(s);
    bool ok = true;
    const float quad_inv = Gauss4::dist<false>(d, s, ok);
    const float quad_eye = d[0] * d[0] + d[1] * d[1] + d[2] * d[2] + d[3] * d[3];
    return phd_merge::hell_tail<4>(det_s, det4(a) * det4(b), quad_inv,
                                   quad_eye);
  }
};

}  // namespace

// metric 0: Mahalanobis, 1: Hellinger; argmax 1: argmax mode (Mahalanobis)
extern "C" int phd_merge4d(const float* packed, float* out, int P, int N,
                           int K, float min_sep, int argmax, int metric,
                           void* stream) {
  if (metric == 1 && !argmax)
    return phd_merge::launch<Hell4, kR>(packed, out, P, N, K, min_sep,
                                         stream);
  if (metric != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (argmax)
    return phd_merge::launch<Gauss4, kR, true>(packed, out, P, N, K,
                                                min_sep, stream);
  return phd_merge::launch<Gauss4, kR>(packed, out, P, N, K, min_sep,
                                        stream);
}

// The launch plan for P particles of N lanes, into out[7] (merge_core.cuh)
extern "C" int phd_merge4d_plan(int P, int N, int argmax, int metric,
                                int* out) {
  if (metric == 1 && !argmax) return phd_merge::plan<Hell4, kR>(P, N, out);
  if (metric != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (argmax) return phd_merge::plan<Gauss4, kR, true>(P, N, out);
  return phd_merge::plan<Gauss4, kR>(P, N, out);
}

namespace {

// The wide variants (merge_wide.cuh) of phd_merge4d's: sorted lanes with
// either metric, argmax mode with the Mahalanobis one
int run_wide(const float* packed, float* out, float* spill,
             unsigned char* gstate, int P, int N, int K, float min_sep,
             int argmax, int metric, void* stream, phd_wide::Plan* report) {
  if (N < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (metric == 1 && !argmax)
    return phd_wide::launch<Hell4, kWideThreads, kWideR, false>(
        packed, out, spill, gstate, P, N, K, min_sep, stream, report);
  if (metric != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (argmax)
    return phd_wide::launch<Gauss4, kWideThreads, kWideR, true>(
        packed, out, spill, gstate, P, N, K, min_sep, stream, report);
  return phd_wide::launch<Gauss4, kWideThreads, kWideR, false>(
      packed, out, spill, gstate, P, N, K, min_sep, stream, report);
}

}  // namespace

// The staged wide-lane variant at any N (the wrapper takes it above
// 2048): spill float[P, 15, X] and gstate uint8[P, X] are scratch for the
// entries past the plan's shared ones (X: its overflow; null when 0)
extern "C" int phd_merge4d_wide(const float* packed, float* out,
                                float* spill, unsigned char* gstate, int P,
                                int N, int K, float min_sep, int argmax,
                                int metric, void* stream) {
  if (P <= 0 || K <= 0) return 0;
  return run_wide(packed, out, spill, gstate, P, N, K, min_sep, argmax,
                  metric, stream, nullptr);
}

// The wide variants' launch plan, into out[7] (merge_core.cuh's layout)
extern "C" int phd_merge4d_wide_plan(int P, int N, int argmax, int metric,
                                     int* out) {
  phd_wide::Plan plan{};
  const int err = run_wide(nullptr, nullptr, nullptr, nullptr, P, N, 1, 0.f,
                           argmax, metric, nullptr, &plan);
  if (err) return err;
  phd_wide::plan_out(plan, out);
  return 0;
}
