// K15: the online SLAM step's motion predict — odometry to pose, μ and the
// pose rows and columns of Σ in one launch.
//
// Replaces no TPU kernel: the JAX package leaves the single-mission predict
// to XLA (smarc_navigation_tpu/models/ekf_slam.py::predict after
// ::_odom_pose). It was added because on the card the same chain in plain
// torch was ~130 launches a tick (rpy_from_quat's normalize and rotation
// entries, _motion_jacobian's elementwise ops and stacks, A from zeros and
// eye, three matmuls, a clone of Σ and three block writes), which held the
// online tick on the host while the card sat ~95 % idle. Contract: this
// package's models/ekf_slam.predict(state, utils/geometry.odom_pose(value),
// params), the plain twin ops/slam_kernels.online_predict takes on CPU
// tensors:
//   - u_t = odom[0:3] − mu_auv_odom; μ'[0:3] = μ[0:3] + u_t; μ'[3:6] the
//     wrapped attitude; μ'[6:] = μ[6:]; mu_auv_odom' = mu_auv_odom + u_t
//     (bitwise: the same separately rounded adds);
//   - the attitude of a nav_msgs value (quat != 0: the wrapper applies
//     odom_pose's rule on the value's width) from its quaternion in
//     utils/geometry.rpy_from_quat's order of operations: the normalize
//     with its 1e-12 eps (the squares summed in the order of torch's
//     reduction on the card), the rotation entries, the clamp, asinf and
//     atan2f (precise library functions, no fast-math intrinsics, the same
//     bits as torch's on the card, torch 2.11 / CUDA 12.8); of a pose
//     track (quat == 0), value[3:6]; then wrap_angle as torch.remainder computes it
//     (fmodf, then the sign fix; slam_common.cuh);
//   - A = [[I3, g], [0, 0]] with g = ∂(R(att) u_t)/∂att in
//     _motion_jacobian's entries (rot_common.cuh), Σ'[0:6, 0:6] = (A Σ00) Aᵀ
//     + R, Σ'[0:6, 6:] = A Σ[0:6, 6:], Σ'[6:, 0:6] its transpose, and Σ
//     everywhere else. The products' summation order is the kernel's own
//     (the twin's matmuls run in the BLAS library's order): Σ' agrees with
//     the twin to rounding, not bit for bit.
// Every product and sum is separately rounded (the library is built with
// -fmad=false), as torch's elementwise ops round them.
//
// Grid: block 0 derives A and writes everything that depends on it (the
// attitude's three angles and their sines and cosines one per lane of warp
// 0, then g and A on lane 0, then the 6 x 6 block and the pose rows and
// columns over the block) and copies μ[6:]; block b ≥ 1 copies row 5 + b of
// Σ from column 6 on. No block waits for another: there is no grid barrier.
// What bounds it on the H100: the bytes of Σ, read once and written once
// (2·D²·4 B: 0.31 MB at D=198, 4.8 MB at D=774), and at D=198 the latency of
// block 0's chain.

#include <cuda_runtime.h>
#include <math.h>

#include "rot_common.cuh"
#include "slam_common.cuh"

namespace {

constexpr int kThreads = 256;

// Lane a < 3 of warp 0: angle a (roll, pitch, yaw) of the odometry value,
// wrapped: v[3:6] of a pose track, or from v[3:7] = quat (xyzw) of a
// nav_msgs value. rpy_from_quat = rpy_from_rotmat(rotmat_from_quat(q)).
__device__ float attitude(const float* v, int quat, int a) {
  if (!quat) return slam::wrap_angle(v[3 + a]);
  float x = v[3], y = v[4], z = v[5], w = v[6];
  // quat_normalize: q / sqrt(sum(q * q) + eps), the sum of the four squares
  // in the order torch's reduction takes on the card: (x² + z²) + (y² + w²)
  const float n = sqrtf(((x * x + z * z) + (y * y + w * w)) + 1e-12f);
  x = x / n;
  y = y / n;
  z = z / n;
  w = w / n;
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, xz = x * z, yz = y * z;
  const float wx = w * x, wy = w * y, wz = w * z;
  float ang;
  if (a == 1) {
    // pitch = asin(clamp(−R20, −1, 1)); a NaN passes the clamp, as in torch
    float sp = -(2.0f * (xz - wy));
    sp = sp < -1.0f ? -1.0f : (sp > 1.0f ? 1.0f : sp);
    ang = asinf(sp);
  } else {
    // roll = atan2(R21, R22), yaw = atan2(R10, R00)
    const float num = a == 0 ? 2.0f * (yz + wx) : 2.0f * (xy + wz);
    const float den = a == 0 ? 1.0f - 2.0f * (xx + yy) : 1.0f - 2.0f * (yy + zz);
    ang = atan2f(num, den);
  }
  return slam::wrap_angle(ang);
}

__global__ void __launch_bounds__(kThreads)
    online_predict_kernel(int D, int quat, const float* __restrict__ mu,
                          const float* __restrict__ S, const float* __restrict__ mao,
                          const float* __restrict__ v, const float* __restrict__ R,
                          float* __restrict__ out) {
  float* So = out;
  float* muo = out + (size_t)D * D;
  float* maoo = muo + D;
  const int t = threadIdx.x;
  if (blockIdx.x > 0) {  // the landmark block of Σ, one row a block
    const size_t r = 5 + blockIdx.x;
    const float* src = S + r * D;
    float* dst = So + r * D;
    for (int c = 6 + t; c < D; c += kThreads) dst[c] = src[c];
    return;
  }

  __shared__ float A[6][6];
  __shared__ float T[6][6];
  if (t < 32) {
    const int lane = t;
    const int a = lane < 3 ? lane : 0;
    const float u = v[a] - mao[a];
    const float ang = attitude(v, quat, a);
    float sc[6];
    slam::warp_sincos3(ang, sc);
    const float u0 = __shfl_sync(0xffffffffu, u, 0);
    const float u1 = __shfl_sync(0xffffffffu, u, 1);
    const float u2 = __shfl_sync(0xffffffffu, u, 2);
    if (lane < 3) {
      muo[lane] = mu[lane] + u;
      muo[3 + lane] = ang;
      maoo[lane] = mao[lane] + u;
    }
    if (lane == 0) {
      slam::Trig tr;
      slam::rot_entries(sc[0], sc[1], sc[2], sc[3], sc[4], sc[5], tr);
      // g[i][k] = Σ_j dR[k][i][j] u[j], the einsum's contraction
#pragma unroll
      for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          A[i][3 + k] = (tr.dR[k][i][0] * u0 + tr.dR[k][i][1] * u1) + tr.dR[k][i][2] * u2;
          A[i][k] = i == k ? 1.0f : 0.0f;
          A[3 + i][k] = 0.0f;
          A[3 + i][3 + k] = 0.0f;
        }
      }
    }
  } else {
    for (int c = 6 + t - 32; c < D; c += kThreads - 32) muo[c] = mu[c];
  }
  __syncthreads();

  // T = A Σ00
  if (t < 36) {
    const int i = t / 6, j = t % 6;
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < 6; ++k) s = s + A[i][k] * S[k * D + j];
    T[i][j] = s;
  }
  // Σ'[0:6, c] = A Σ[0:6, c] and Σ'[c, 0:6], c ≥ 6
  for (int c = 6 + t; c < D; c += kThreads) {
    float s[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) s[k] = S[(size_t)k * D + c];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < 6; ++k) acc = acc + A[i][k] * s[k];
      So[(size_t)i * D + c] = acc;
      So[(size_t)c * D + i] = acc;
    }
  }
  __syncthreads();
  // Σ'00 = T Aᵀ + R
  if (t < 36) {
    const int i = t / 6, j = t % 6;
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < 6; ++k) s = s + T[i][k] * A[j][k];
    So[i * D + j] = s + R[i * 6 + j];
  }
}

}  // namespace

// K15. mu (D,), Sigma (D, D), mu_auv_odom (3,), value (6,) or, with quat,
// the nav_msgs (≥ 13,), R (6, 6) f32; out (D·D + D + 3,) f32: Σ', then μ',
// then mu_auv_odom'. D = 6 + 3L.
extern "C" int slam_predict_launch(int device, void* stream, int D, int quat, const void* mu,
                                   const void* Sigma, const void* mu_auv_odom,
                                   const void* value, const void* R, void* out) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (D < 6 || (D - 6) % 3 != 0 || D > (1 << 15)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  online_predict_kernel<<<1 + (D - 6), kThreads, 0, s>>>(
      D, quat, static_cast<const float*>(mu), static_cast<const float*>(Sigma),
      static_cast<const float*>(mu_auv_odom), static_cast<const float*>(value),
      static_cast<const float*>(R), static_cast<float*>(out));
  return (int)cudaGetLastError();
}
