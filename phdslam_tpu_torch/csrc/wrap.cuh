// The Pallas kernels' bearing wrap (phdslam_tpu/ops/pallas_detect.py::
// _wrap_angle), step by step: floor-mod, then the shifts of
// ops/math.py::wrap_angle. Shared by detect.cu and merge2d.cu's fused
// gather + merge; kernels/detect.py::_wrap_angle_floor is its twin.

#pragma once

namespace phd {

constexpr float kTwoPi = 6.283185307179586f;
constexpr float kPi = 3.141592653589793f;

__device__ __forceinline__ float wrap_angle_floor(float a) {
  float r = a - kTwoPi * floorf(a / kTwoPi);
  if (a < 0.f && r > 0.f) r = r - kTwoPi;
  if (r > kPi) r = r - kTwoPi;
  if (r < -kPi) r = r + kTwoPi;
  return r;
}

}  // namespace phd
