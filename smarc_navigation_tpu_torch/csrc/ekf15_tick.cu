// K10: the whole 15-state (robot_localization) EKF fleet tick.
//
// Replaces the TPU kernel smarc_navigation_tpu/ops/ekf15_kernels.py::
// _run_fleet15_jit (pallas_call at :264, body _make_ekf15_kernel and its
// _chol_solve_cols). Contract: this package's
// ops/ekf15_kernels.fleet15_tick_reference, which transcribes the TPU
// kernel's body in its operation order; this file keeps that order
// (compiled with -fmad=false, so every product is rounded as the plain
// version rounds it).
//
// One warp per mission, kWarps missions per block; x (15) and P (15×15,
// double-buffered) in the warp's shared memory. Per mission:
//   1. the predict: every lane computes the control-shaped acceleration, x',
//      and the blocks of A = F − I (A1, A2, A3 on rows 0-2, B1, B2 on rows
//      3-5, dt on rows 6-8), lane 0 stores A's coefficients; lane i < 9 forms
//      row i of AP; lane i < 15 forms the upper-triangle entries of row i of
//      Pn = P + AP + (AP)ᵀ + APAᵀ + q·dt and writes each to (i, j) and (j, i),
//      so P stays exactly symmetric;
//   2. per sensor (k ≤ 6 measured components, its rows of the tick input):
//      every lane computes the same k×k Cholesky of S = P[m, m] + diag(r)
//      (same operations, same bits), lane r < 15 solves its row P[r, m] S⁻¹
//      = K[r, :] and x'[r]; the lanes write P − ½(dij + dji) into the other
//      buffer; the sensor's apply flag selects the new x and P or keeps the
//      old.
// The sensor wiring (static in the TPU kernel, folded at trace time) is a
// struct passed by value; the kernel dispatches on each sensor's k.
//
// What bounds it on the H100: latency. A tick moves ~1 KB per mission and
// does ~10 kFLOP; the sensor updates form a dependent chain (Cholesky,
// solve, downdate) per sensor. The design keeps each mission in one warp so
// the chain pays only __syncwarp and shared-memory latency, and reads and
// writes the state once per tick.

#include <cuda_runtime.h>
#include <math.h>

#include "rot_common.cuh"
#include "slam_common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kMaxSensors = 8;
constexpr int kMaxK = 6;

struct Wiring {            // layout of ops/ekf15_kernels._CWiring
  int n_sens;
  int k[kMaxSensors];
  int idx[kMaxSensors * kMaxK];
  int row[kMaxSensors];
  float noise[kMaxSensors * kMaxK];
  float q[15];
  float gain[3];
  float lim[3];
  int use_control;
};

// column of term t of row r of A = F − I, and the number of terms per row
__device__ inline int a_col(int r, int t) {
  if (r < 3) return t < 3 ? 3 + t : (t < 6 ? 6 + (t - 3) : 12 + (t - 6));
  if (r < 6) return t < 3 ? 3 + t : 9 + (t - 3);
  return 12 + (r - 6);
}

__device__ inline int a_terms(int r) { return r < 3 ? 9 : (r < 6 ? 6 : 1); }

// one sensor's exact-subspace update from Pc into Pn; returns its apply flag
template <int K>
__device__ bool sensor_update(const Wiring& w, int s, int lane, const float* tk,
                              float* xs, const float* Pc, float* Pn, float* Ks) {
  int idx[K];
  float nz[K], z[K];
  const int row = w.row[s];
  for (int a = 0; a < K; ++a) {
    idx[a] = w.idx[s * kMaxK + a];
    nz[a] = w.noise[s * kMaxK + a];
    z[a] = tk[row + a];
  }
  const bool apply = tk[row + K] > 0.5f;
  float nu[K];
  for (int a = 0; a < K; ++a) {
    const float d = z[a] - xs[idx[a]];
    nu[a] = (idx[a] >= 3 && idx[a] <= 5) ? slam::wrap_angle(d) : d;
  }
  float S[K][K], L[K][K];
  for (int a = 0; a < K; ++a)
    for (int b = 0; b < K; ++b) S[a][b] = Pc[idx[a] * 15 + idx[b]] + (a == b ? nz[a] : 0.0f);
  for (int j = 0; j < K; ++j) {
    float acc = 0.0f;
    for (int p = 0; p < j; ++p) acc = acc + L[j][p] * L[j][p];
    L[j][j] = sqrtf(fmaxf(S[j][j] - acc, 1e-20f));
    const float inv_ljj = 1.0f / L[j][j];
    for (int i = j + 1; i < K; ++i) {
      float o = 0.0f;
      for (int p = 0; p < j; ++p) o = o + L[i][p] * L[j][p];
      L[i][j] = (S[i][j] - o) * inv_ljj;
    }
  }
  float x2 = 0.0f;
  if (lane < 15) {
    float y[K], xk[K];
    for (int i = 0; i < K; ++i) {
      float acc = 0.0f;
      for (int p = 0; p < i; ++p) acc = acc + L[i][p] * y[p];
      y[i] = (Pc[lane * 15 + idx[i]] - acc) / L[i][i];
    }
    for (int i = K - 1; i >= 0; --i) {
      float acc = 0.0f;
      for (int j = i + 1; j < K; ++j) acc = acc + L[j][i] * xk[j];
      xk[i] = (y[i] - acc) / L[i][i];
    }
    float acc = 0.0f;
    for (int b = 0; b < K; ++b) {
      Ks[lane * kMaxK + b] = xk[b];
      acc = acc + xk[b] * nu[b];
    }
    x2 = xs[lane] + acc;
    if (lane >= 3 && lane <= 5) x2 = slam::wrap_angle(x2);
  }
  __syncwarp();
  if (lane < 15) {
    const int i = lane;
    for (int j = i; j < 15; ++j) {
      float dij = 0.0f, dji = 0.0f;
      for (int b = 0; b < K; ++b) dij = dij + Ks[i * kMaxK + b] * Pc[idx[b] * 15 + j];
      for (int b = 0; b < K; ++b) dji = dji + Ks[j * kMaxK + b] * Pc[idx[b] * 15 + i];
      const float val = Pc[i * 15 + j] - 0.5f * (dij + dji);
      Pn[i * 15 + j] = val;
      Pn[j * 15 + i] = val;
    }
  }
  __syncwarp();
  if (apply && lane < 15) xs[lane] = x2;
  __syncwarp();
  return apply;
}

__global__ void __launch_bounds__(kWarps * 32)
ekf15_kernel(int B, int rows, const Wiring w, const float* __restrict__ x_in,
             const float* __restrict__ P_in, const float* __restrict__ tick,
             float* __restrict__ x_out, float* __restrict__ P_out,
             float* __restrict__ pd_out) {
  __shared__ float s_x[kWarps][16];
  __shared__ float s_P[kWarps][2][225];
  __shared__ float s_AP[kWarps][9 * 15];
  __shared__ float s_A[kWarps][9 * 9];
  __shared__ float s_K[kWarps][15 * kMaxK];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= B) return;                      // warps only: no block barrier here
  float* xs = s_x[warp];
  float* AP = s_AP[warp];
  float* Ac = s_A[warp];
  float* Ks = s_K[warp];
  int cur = 0;
  if (lane < 15) xs[lane] = x_in[(size_t)b * 15 + lane];
  for (int l = lane; l < 225; l += 32) s_P[warp][0][l] = P_in[(size_t)b * 225 + l];
  __syncwarp();
  const float* tk = tick + (size_t)b * rows;
  const float dt = tk[0];

  // ---- 1. predict -------------------------------------------------------------
  {
    float x[15];
    for (int i = 0; i < 15; ++i) x[i] = xs[i];
    float a_cmd[3];
    for (int i = 0; i < 3; ++i) a_cmd[i] = x[0] * 0.0f;
    if (w.use_control) {
      const bool cmd_ok = tk[3] > 0.5f;
      for (int i = 0; i < 2; ++i) {
        float raw = w.gain[i] * (tk[1 + i] - x[6 + i]);
        raw = fminf(fmaxf(raw, -w.lim[i]), w.lim[i]);
        a_cmd[i] = cmd_ok ? raw : 0.0f;
      }
    }
    float a_eff[3], v[3], wr[3];
    for (int i = 0; i < 3; ++i) {
      a_eff[i] = x[12 + i] + a_cmd[i];
      v[i] = x[6 + i];
      wr[i] = x[9 + i];
    }
    slam::Trig tr;
    slam::rot_entries(x[3], x[4], x[5], tr);
    const float sr = sinf(x[3]), cr = cosf(x[3]);
    const float sp = sinf(x[4]), cp = cosf(x[4]);
    const float cy = cosf(x[5]);
    const float z0 = cy * 0.0f;
    const float tp = sp / cp;
    const float inv_cp = 1.0f / cp;
    const float E[3][3] = {{z0 + 1.0f, sr * tp, cr * tp},
                           {z0, cr, -sr},
                           {z0, sr * inv_cp, cr * inv_cp}};
    const float sec2 = inv_cp * inv_cp;
    const float dE[2][3][3] = {{{z0, cr * tp, -sr * tp},
                                {z0, -sr, -cr},
                                {z0, cr * inv_cp, -sr * inv_cp}},
                               {{z0, sr * sec2, cr * sec2},
                                {z0, z0, z0},
                                {z0, sr * tp * inv_cp, cr * tp * inv_cp}}};
    const float half_dt2 = 0.5f * dt * dt;
    float d[3], wdt[3], x_new[15];
    for (int i = 0; i < 3; ++i) {
      d[i] = v[i] * dt + a_eff[i] * half_dt2;
      wdt[i] = wr[i] * dt;
    }
    for (int i = 0; i < 3; ++i) {
      float acc = 0.0f;
      for (int j = 0; j < 3; ++j) acc = acc + tr.R[i][j] * d[j];
      x_new[i] = x[i] + acc;
      float e = 0.0f;
      for (int j = 0; j < 3; ++j) e = e + E[i][j] * wdt[j];
      x_new[3 + i] = slam::wrap_angle(x[3 + i] + e);
      x_new[6 + i] = v[i] + a_eff[i] * dt;
      x_new[9 + i] = wr[i];
      x_new[12 + i] = x[12 + i];
    }
    if (lane == 0) {   // A's coefficients, row r at Ac[9 r], in a_col's order
      for (int i = 0; i < 3; ++i) {
        for (int k = 0; k < 3; ++k) {
          float acc = 0.0f;
          for (int j = 0; j < 3; ++j) acc = acc + tr.dR[k][i][j] * d[j];
          Ac[i * 9 + k] = acc;                               // A1
          Ac[i * 9 + 3 + k] = tr.R[i][k] * dt;               // A2
          Ac[i * 9 + 6 + k] = tr.R[i][k] * half_dt2;         // A3
          float b1 = z0;
          if (k < 2) {
            b1 = 0.0f;
            for (int j = 0; j < 3; ++j) b1 = b1 + dE[k][i][j] * wdt[j];
          }
          Ac[(3 + i) * 9 + k] = b1;                          // B1
          Ac[(3 + i) * 9 + 3 + k] = E[i][k] * dt;            // B2
        }
        Ac[(6 + i) * 9] = dt;
      }
    }
    __syncwarp();
    const float* P = s_P[warp][cur];
    if (lane < 9) {
      for (int j = 0; j < 15; ++j) {
        float acc = 0.0f;
        for (int t = 0; t < a_terms(lane); ++t)
          acc = acc + Ac[lane * 9 + t] * P[a_col(lane, t) * 15 + j];
        AP[lane * 15 + j] = acc;
      }
    }
    __syncwarp();
    float* Pn = s_P[warp][cur ^ 1];
    if (lane < 15) {
      const int i = lane;
      for (int j = i; j < 15; ++j) {
        float val = P[i * 15 + j];
        if (i < 9) val = val + AP[i * 15 + j];
        if (j < 9) val = val + AP[j * 15 + i];
        if (i < 9 && j < 9) {
          float apa = 0.0f;
          for (int t = 0; t < a_terms(j); ++t)
            apa = apa + AP[i * 15 + a_col(j, t)] * Ac[j * 9 + t];
          val = val + apa;
        }
        if (i == j) val = val + w.q[i] * dt;
        Pn[i * 15 + j] = val;
        Pn[j * 15 + i] = val;
      }
    }
    if (lane == 0)
      for (int i = 0; i < 15; ++i) xs[i] = x_new[i];
    __syncwarp();
    cur ^= 1;
  }

  // ---- 2. sensor updates (exact subspace) -----------------------------------
  for (int s = 0; s < w.n_sens; ++s) {
    const float* Pc = s_P[warp][cur];
    float* Pn = s_P[warp][cur ^ 1];
    bool applied = false;
    switch (w.k[s]) {
      case 1: applied = sensor_update<1>(w, s, lane, tk, xs, Pc, Pn, Ks); break;
      case 2: applied = sensor_update<2>(w, s, lane, tk, xs, Pc, Pn, Ks); break;
      case 3: applied = sensor_update<3>(w, s, lane, tk, xs, Pc, Pn, Ks); break;
      case 4: applied = sensor_update<4>(w, s, lane, tk, xs, Pc, Pn, Ks); break;
      case 5: applied = sensor_update<5>(w, s, lane, tk, xs, Pc, Pn, Ks); break;
      default: applied = sensor_update<6>(w, s, lane, tk, xs, Pc, Pn, Ks); break;
    }
    if (applied) cur ^= 1;
  }

  // ---- 3. write the state out -------------------------------------------------
  const float* P = s_P[warp][cur];
  if (lane < 15) {
    x_out[(size_t)b * 15 + lane] = xs[lane];
    if (pd_out) pd_out[(size_t)b * 15 + lane] = P[lane * 16];
  }
  for (int l = lane; l < 225; l += 32) P_out[(size_t)b * 225 + l] = P[l];
}

}  // namespace

extern "C" int ekf15_tick_launch(int device, void* stream, int B, int rows, const void* wiring,
                                 const void* x_in, const void* P_in, const void* tick,
                                 void* x_out, void* P_out, void* pd_out) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const Wiring w = *static_cast<const Wiring*>(wiring);
  if (B < 1 || w.n_sens < 0 || w.n_sens > kMaxSensors) return (int)cudaErrorInvalidValue;
  for (int s = 0; s < w.n_sens; ++s)
    if (w.k[s] < 1 || w.k[s] > kMaxK || w.row[s] + w.k[s] >= rows)
      return (int)cudaErrorInvalidValue;
  const int blocks = (B + kWarps - 1) / kWarps;
  ekf15_kernel<<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      B, rows, w, (const float*)x_in, (const float*)P_in, (const float*)tick,
      (float*)x_out, (float*)P_out, (float*)pd_out);
  return (int)cudaGetLastError();
}
