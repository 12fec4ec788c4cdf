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

namespace {

constexpr int kR = 8;           // tentative principals a round

struct Gauss4 {
  static constexpr int kDim = 4;
  static constexpr int kCov = 10;      // _PAIRS4 order
  static constexpr int kPlanes = 16;
  static constexpr int kOutPlanes = 16;

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

}  // namespace

extern "C" int phd_merge4d(const float* packed, float* out, int P, int N,
                           int K, float min_sep, void* stream) {
  return phd_merge::launch<Gauss4, kR>(packed, out, P, N, K, min_sep,
                                        stream);
}

// The launch plan for P particles of N lanes, into out[7] (merge_core.cuh)
extern "C" int phd_merge4d_plan(int P, int N, int* out) {
  return phd_merge::plan<Gauss4, kR>(P, N, out);
}
