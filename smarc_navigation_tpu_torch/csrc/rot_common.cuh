// Rotation entries shared by the filter tick kernels (K9, K10): R = Rz(yaw)
// Ry(pitch) Rx(roll) and its three partial derivatives, each entry with
// the plain versions' expression and operation order
// (ops/loc_kernels._rot_entries / _drot_entries).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace slam {

struct Trig {
  float R[3][3];
  float dR[3][3][3];  // [k][i][j] = ∂R[i][j]/∂rpy_k
};

// the entries from the sines and cosines of roll, pitch and yaw
__device__ inline void rot_entries(float sr, float cr, float sp, float cp, float sy, float cy,
                                   Trig& t) {
  const float zero = sr * 0.0f;
  t.R[0][0] = cy * cp;
  t.R[0][1] = cy * sp * sr - sy * cr;
  t.R[0][2] = cy * sp * cr + sy * sr;
  t.R[1][0] = sy * cp;
  t.R[1][1] = sy * sp * sr + cy * cr;
  t.R[1][2] = sy * sp * cr - cy * sr;
  t.R[2][0] = -sp;
  t.R[2][1] = cp * sr;
  t.R[2][2] = cp * cr;
  // d/droll
  t.dR[0][0][0] = zero;
  t.dR[0][0][1] = cy * sp * cr + sy * sr;
  t.dR[0][0][2] = -cy * sp * sr + sy * cr;
  t.dR[0][1][0] = zero;
  t.dR[0][1][1] = sy * sp * cr - cy * sr;
  t.dR[0][1][2] = -sy * sp * sr - cy * cr;
  t.dR[0][2][0] = zero;
  t.dR[0][2][1] = cp * cr;
  t.dR[0][2][2] = -cp * sr;
  // d/dpitch
  t.dR[1][0][0] = -cy * sp;
  t.dR[1][0][1] = cy * cp * sr;
  t.dR[1][0][2] = cy * cp * cr;
  t.dR[1][1][0] = -sy * sp;
  t.dR[1][1][1] = sy * cp * sr;
  t.dR[1][1][2] = sy * cp * cr;
  t.dR[1][2][0] = -cp;
  t.dR[1][2][1] = -sp * sr;
  t.dR[1][2][2] = -sp * cr;
  // d/dyaw
  t.dR[2][0][0] = -sy * cp;
  t.dR[2][0][1] = -sy * sp * sr - cy * cr;
  t.dR[2][0][2] = -sy * sp * cr + cy * sr;
  t.dR[2][1][0] = cy * cp;
  t.dR[2][1][1] = cy * sp * sr - sy * cr;
  t.dR[2][1][2] = cy * sp * cr + sy * sr;
  t.dR[2][2][0] = zero;
  t.dR[2][2][1] = zero;
  t.dR[2][2][2] = zero;
}

// Called by all 32 lanes of a warp, lane i < 3 holding angle a of roll,
// pitch and yaw (i): the three sines and cosines at once, one per lane,
// returned to every lane as (sr, cr, sp, cp, sy, cy).
__device__ inline void warp_sincos3(float a, float sc[6]) {
  const float s = sinf(a), c = cosf(a);
  for (int i = 0; i < 3; ++i) {
    sc[2 * i] = __shfl_sync(0xffffffffu, s, i);
    sc[2 * i + 1] = __shfl_sync(0xffffffffu, c, i);
  }
}

}  // namespace slam
