// Device helpers shared by the SLAM update kernels (K2/K3, K4).
#pragma once

#include <cuda_runtime.h>

namespace slam {

constexpr float kPi = 3.14159265358979323846f;

// floored modulo, as jnp.mod / torch.remainder: mod(a + π, 2π) − π
__device__ inline float wrap_angle(float a) {
  const float two_pi = 2.0f * kPi;
  const float x = a + kPi;
  float r = fmodf(x, two_pi);
  if (r != 0.0f && (r < 0.0f) != (two_pi < 0.0f)) r += two_pi;
  return r - kPi;
}

}  // namespace slam
