// K10: the whole 15-state (robot_localization) EKF fleet tick.
//
// Replaces the TPU kernel smarc_navigation_tpu/ops/ekf15_kernels.py::
// _run_fleet15_jit (pallas_call at :264, body _make_ekf15_kernel and its
// _chol_solve_cols). Contract: this package's
// ops/ekf15_kernels.fleet15_tick_reference, which transcribes the TPU
// kernel's body in its operation order. Every output entry (each x'[i],
// Pn[i][j], K[r][b] and downdated P[i][j]) is computed by one thread with
// the plain version's operations in its order (compiled with -fmad=false,
// so every product is rounded as the plain version rounds it), so the
// kernel is bitwise equal to its plain version.
//
// One block of kThreads (5 warps) per mission; the wiring, x (15), P (15×15,
// double-buffered), the tick row, A's coefficients, AP, the gain K and the
// innovation in the block's shared memory. Warps 0-3 own the matrix
// entries, warp 4 the state vector. Per mission:
//   1. the predict: warp 0 computes the control-shaped acceleration, x'
//      (lane i < 3 takes sin and cos of angle i and wraps x'[3 + i]), R,
//      ∂R, the Euler-rate matrix E and its derivatives, d and ω·dt, and
//      lane 0 stores them as a table; thread l < 81 forms coefficient l of
//      A = F − I (A1, A2, A3 on rows 0-2, B1, B2 on rows 3-5, dt on rows
//      6-8, in a_col's order) from the table; thread e < 135 forms entry e
//      of AP (rows 0-8); thread e < 120 forms upper-triangle entry e of
//      Pn = P + AP + (AP)ᵀ + APAᵀ + q·dt and writes it to (i, j) and (j, i),
//      so P stays exactly symmetric;
//   2. per sensor (k ≤ 6 measured components, its rows of the tick input)
//      whose apply flag is set, a block-uniform branch: threads r < 15 each
//      compute the same k×k Cholesky of S = P[m, m] + diag(r) (same
//      operations, same bits) and solve row r of K = P[:, m] S⁻¹, while
//      warp 4 forms the innovation ν; then thread e < 120 writes
//      upper-triangle entry e of P − ½(dij + dji) to (i, j) and (j, i) of
//      the other buffer while warp 4 forms x' = x + Kν. A sensor whose flag
//      is off is skipped: the TPU kernel's jnp.where(apply, new, old) keeps
//      the old x and P bit for bit, so the next sensor reads what it would
//      read there.
// The sensor wiring (static in the TPU kernel, folded at trace time) is a
// __grid_constant__ struct passed by value, copied to shared memory with the
// state; the kernel dispatches on each sensor's k.
//
// What bounds it on the H100: latency. A tick moves ~1 KB per mission and
// does ~10 kFLOP; the sensor updates form a dependent chain (Cholesky,
// solve, downdate) per sensor. The design gives each mission its own block
// (B blocks: at B=64 on 64 of the 132 SMs), spreads the predict's
// coefficients, AP and Pn and each sensor's downdate over the block's
// threads (one entry each), so the chain per tick is the Cholesky and the
// 15 parallel row solves per applied sensor plus a few short stages
// separated by block barriers, keeps the wiring and every operand in
// shared memory, and reads and writes the state once.

#include <cuda_runtime.h>
#include <math.h>

#include "rot_common.cuh"
#include "slam_common.cuh"

namespace {

constexpr int kThreads = 160;   // warps 0-3: matrix entries; warp 4: the state vector
constexpr int kXWarp = 128;     // first thread of warp 4
constexpr int kMaxSensors = 8;
constexpr int kMaxK = 6;
constexpr int kMaxRows = 4 + kMaxSensors * (kMaxK + 1);

// the predict's table (warp 0 -> the coefficient threads)
constexpr int kTR = 0;      // R (3×3)
constexpr int kTdR = 9;     // ∂R/∂rpy_k [k][i][j]
constexpr int kTE = 36;     // E (3×3)
constexpr int kTdE = 45;    // ∂E/∂roll, ∂E/∂pitch [k][i][j]
constexpr int kTd = 63;     // d = v dt + a dt²/2
constexpr int kTwdt = 66;   // ω dt
constexpr int kTdt = 69;
constexpr int kThdt2 = 70;  // dt²/2
constexpr int kTz0 = 71;    // cos(yaw)·0
constexpr int kTable = 72;

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

// entry e < 120 of the upper triangle, row by row -> (i, j), i <= j
__device__ inline void upper_ij(int e, int& i, int& j) {
  i = 0;
  while (e >= 15 - i) {
    e -= 15 - i;
    ++i;
  }
  j = i + e;
}

// coefficient l = 9 r + t of A (row r, term t in a_col's order) from the table
__device__ float a_coeff(int l, const float* tab) {
  const int r = l / 9, t = l % 9;
  if (r < 3) {
    if (t < 3) {                                             // A1
      float acc = 0.0f;
      for (int j = 0; j < 3; ++j) acc = acc + tab[kTdR + t * 9 + r * 3 + j] * tab[kTd + j];
      return acc;
    }
    if (t < 6) return tab[kTR + r * 3 + (t - 3)] * tab[kTdt];       // A2
    return tab[kTR + r * 3 + (t - 6)] * tab[kThdt2];                // A3
  }
  if (r < 6) {
    const int i = r - 3;
    if (t < 2) {                                             // B1, roll and pitch
      float b1 = 0.0f;
      for (int j = 0; j < 3; ++j) b1 = b1 + tab[kTdE + t * 9 + i * 3 + j] * tab[kTwdt + j];
      return b1;
    }
    if (t == 2) return tab[kTz0];                            // B1, yaw
    if (t < 6) return tab[kTE + i * 3 + (t - 3)] * tab[kTdt];       // B2
    return 0.0f;                                             // no such term
  }
  return t == 0 ? tab[kTdt] : 0.0f;
}

// Warp 0's part of the predict: x' into xs, the table into tab.
__device__ void predict_table(const Wiring& w, const float* tk, float* xs, float* tab, int lane) {
  float x[15];
  for (int i = 0; i < 15; ++i) x[i] = xs[i];
  const float dt = tk[0];
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
  const int i3 = lane < 3 ? lane : 2;                     // this lane's angle
  float sc[6];
  slam::warp_sincos3(i3 == 0 ? x[3] : (i3 == 1 ? x[4] : x[5]), sc);
  slam::Trig tr;
  slam::rot_entries(sc[0], sc[1], sc[2], sc[3], sc[4], sc[5], tr);
  const float sr = sc[0], cr = sc[1], sp = sc[2], cp = sc[3], cy = sc[5];
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
  float d[3], wdt[3];
  for (int i = 0; i < 3; ++i) {
    d[i] = v[i] * dt + a_eff[i] * half_dt2;
    wdt[i] = wr[i] * dt;
  }
  float e3[3];
  for (int i = 0; i < 3; ++i) {
    float e = 0.0f;
    for (int j = 0; j < 3; ++j) e = e + E[i][j] * wdt[j];
    e3[i] = e;
  }
  // lane i < 3 wraps x'[3 + i]
  const float ang =
      slam::wrap_angle(i3 == 0 ? x[3] + e3[0] : (i3 == 1 ? x[4] + e3[1] : x[5] + e3[2]));
  __syncwarp();                          // every lane has read x before it is written
  if (lane < 3) xs[3 + lane] = ang;
  if (lane == 0) {
    for (int i = 0; i < 3; ++i) {
      float acc = 0.0f;
      for (int j = 0; j < 3; ++j) acc = acc + tr.R[i][j] * d[j];
      xs[i] = x[i] + acc;
      xs[6 + i] = v[i] + a_eff[i] * dt;
      xs[9 + i] = wr[i];
      xs[12 + i] = x[12 + i];
    }
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        tab[kTR + i * 3 + j] = tr.R[i][j];
        tab[kTE + i * 3 + j] = E[i][j];
        for (int k = 0; k < 3; ++k) tab[kTdR + k * 9 + i * 3 + j] = tr.dR[k][i][j];
        for (int k = 0; k < 2; ++k) tab[kTdE + k * 9 + i * 3 + j] = dE[k][i][j];
      }
    for (int i = 0; i < 3; ++i) {
      tab[kTd + i] = d[i];
      tab[kTwdt + i] = wdt[i];
    }
    tab[kTdt] = dt;
    tab[kThdt2] = half_dt2;
    tab[kTz0] = z0;
  }
}

// One applied sensor's exact-subspace update from Pc into Pn and x
// (block-wide), its gain into Ks and innovation into nus.
template <int K>
__device__ void sensor_update(const Wiring& w, int s, int tid, int ui, int uj, const float* tk,
                              float* xs, const float* Pc, float* Pn, float* Ks, float* nus) {
  int idx[K];
  for (int a = 0; a < K; ++a) idx[a] = w.idx[s * kMaxK + a];
  if (tid < 15) {                        // row tid of K = P[:, m] S⁻¹
    float S[K][K], L[K][K];
    for (int a = 0; a < K; ++a)
      for (int b = 0; b < K; ++b)
        S[a][b] = Pc[idx[a] * 15 + idx[b]] + (a == b ? w.noise[s * kMaxK + a] : 0.0f);
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
    float y[K], xk[K];
    for (int i = 0; i < K; ++i) {
      float acc = 0.0f;
      for (int p = 0; p < i; ++p) acc = acc + L[i][p] * y[p];
      y[i] = (Pc[tid * 15 + idx[i]] - acc) / L[i][i];
    }
    for (int i = K - 1; i >= 0; --i) {
      float acc = 0.0f;
      for (int j = i + 1; j < K; ++j) acc = acc + L[j][i] * xk[j];
      xk[i] = (y[i] - acc) / L[i][i];
    }
    for (int b = 0; b < K; ++b) Ks[tid * kMaxK + b] = xk[b];
  } else if (tid >= kXWarp && tid < kXWarp + K) {     // the innovation ν[a]
    const int a = tid - kXWarp, c = w.idx[s * kMaxK + a];
    const float d = tk[w.row[s] + a] - xs[c];
    nus[a] = (c >= 3 && c <= 5) ? slam::wrap_angle(d) : d;
  }
  __syncthreads();
  if (tid < 120) {
    const int i = ui, j = uj;
    float dij = 0.0f, dji = 0.0f;
    for (int b = 0; b < K; ++b) dij = dij + Ks[i * kMaxK + b] * Pc[idx[b] * 15 + j];
    for (int b = 0; b < K; ++b) dji = dji + Ks[j * kMaxK + b] * Pc[idx[b] * 15 + i];
    const float val = Pc[i * 15 + j] - 0.5f * (dij + dji);
    Pn[i * 15 + j] = val;
    Pn[j * 15 + i] = val;
  } else if (tid >= kXWarp && tid < kXWarp + 15) {    // x'[r] = x[r] + Σ_b K[r][b] ν[b]
    const int r = tid - kXWarp;
    float acc = 0.0f;
    for (int b = 0; b < K; ++b) acc = acc + Ks[r * kMaxK + b] * nus[b];
    const float x2 = xs[r] + acc;
    xs[r] = (r >= 3 && r <= 5) ? slam::wrap_angle(x2) : x2;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
ekf15_kernel(int rows, const __grid_constant__ Wiring w, const float* __restrict__ x_in,
             const float* __restrict__ P_in, const float* __restrict__ tick,
             float* __restrict__ x_out, float* __restrict__ P_out,
             float* __restrict__ pd_out) {
  __shared__ Wiring s_w;
  __shared__ float s_x[16];
  __shared__ float s_P[2][225];
  __shared__ float s_tk[kMaxRows];
  __shared__ float s_tab[kTable];
  __shared__ float s_A[81];
  __shared__ float s_AP[9 * 15];
  __shared__ float s_K[15 * kMaxK];
  __shared__ float s_nu[kMaxK];
  const int tid = threadIdx.x;
  const size_t b = blockIdx.x;
  int ui = 0, uj = 0;                    // this thread's upper-triangle entry
  if (tid < 120) upper_ij(tid, ui, uj);
  // every load is issued before the first shared store: one memory latency
  constexpr int kWords = sizeof(Wiring) / sizeof(int);
  static_assert(kWords <= kThreads && kMaxRows <= kThreads && 225 <= 2 * kThreads, "loads");
  const int l2 = tid + kThreads;
  const int wv = tid < kWords ? reinterpret_cast<const int*>(&w)[tid] : 0;
  const float xv = tid < 15 ? x_in[b * 15 + tid] : 0.0f;
  const float p0 = P_in[b * 225 + tid];
  const float p1 = l2 < 225 ? P_in[b * 225 + l2] : 0.0f;
  const float tv = tid < rows ? tick[b * rows + tid] : 0.0f;
  if (tid < kWords) reinterpret_cast<int*>(&s_w)[tid] = wv;
  if (tid < 15) s_x[tid] = xv;
  s_P[0][tid] = p0;
  if (l2 < 225) s_P[0][l2] = p1;
  if (tid < rows) s_tk[tid] = tv;
  __syncthreads();
  const Wiring& ws = s_w;

  // ---- 1. predict -------------------------------------------------------------
  if (tid < 32) predict_table(ws, s_tk, s_x, s_tab, tid);
  __syncthreads();
  if (tid < 81) s_A[tid] = a_coeff(tid, s_tab);
  __syncthreads();
  const float* P = s_P[0];
  if (tid < 135) {
    const int i = tid / 15, j = tid % 15;
    float acc = 0.0f;
    for (int t = 0; t < a_terms(i); ++t) acc = acc + s_A[i * 9 + t] * P[a_col(i, t) * 15 + j];
    s_AP[tid] = acc;
  }
  __syncthreads();
  if (tid < 120) {
    const int i = ui, j = uj;
    float val = P[i * 15 + j];
    if (i < 9) val = val + s_AP[i * 15 + j];
    if (j < 9) val = val + s_AP[j * 15 + i];
    if (i < 9 && j < 9) {
      float apa = 0.0f;
      for (int t = 0; t < a_terms(j); ++t) apa = apa + s_AP[i * 15 + a_col(j, t)] * s_A[j * 9 + t];
      val = val + apa;
    }
    if (i == j) val = val + ws.q[i] * s_tk[0];
    s_P[1][i * 15 + j] = val;
    s_P[1][j * 15 + i] = val;
  }
  __syncthreads();
  int cur = 1;

  // ---- 2. sensor updates (exact subspace), applied ones only ---------------
  for (int s = 0; s < ws.n_sens; ++s) {
    if (!(s_tk[ws.row[s] + ws.k[s]] > 0.5f)) continue;   // block-uniform
    const float* Pc = s_P[cur];
    float* Pn = s_P[cur ^ 1];
    switch (ws.k[s]) {
      case 1: sensor_update<1>(ws, s, tid, ui, uj, s_tk, s_x, Pc, Pn, s_K, s_nu); break;
      case 2: sensor_update<2>(ws, s, tid, ui, uj, s_tk, s_x, Pc, Pn, s_K, s_nu); break;
      case 3: sensor_update<3>(ws, s, tid, ui, uj, s_tk, s_x, Pc, Pn, s_K, s_nu); break;
      case 4: sensor_update<4>(ws, s, tid, ui, uj, s_tk, s_x, Pc, Pn, s_K, s_nu); break;
      case 5: sensor_update<5>(ws, s, tid, ui, uj, s_tk, s_x, Pc, Pn, s_K, s_nu); break;
      default: sensor_update<6>(ws, s, tid, ui, uj, s_tk, s_x, Pc, Pn, s_K, s_nu); break;
    }
    cur ^= 1;
  }

  // ---- 3. write the state out -------------------------------------------------
  const float* Pf = s_P[cur];
  if (tid < 15) {
    x_out[b * 15 + tid] = s_x[tid];
    if (pd_out) pd_out[b * 15 + tid] = Pf[tid * 16];
  }
  for (int l = tid; l < 225; l += kThreads) P_out[b * 225 + l] = Pf[l];
}

}  // namespace

extern "C" int ekf15_tick_launch(int device, void* stream, int B, int rows, const void* wiring,
                                 const void* x_in, const void* P_in, const void* tick,
                                 void* x_out, void* P_out, void* pd_out) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const Wiring w = *static_cast<const Wiring*>(wiring);
  if (B < 1 || rows > kMaxRows || w.n_sens < 0 || w.n_sens > kMaxSensors)
    return (int)cudaErrorInvalidValue;
  for (int s = 0; s < w.n_sens; ++s)
    if (w.k[s] < 1 || w.k[s] > kMaxK || w.row[s] + w.k[s] >= rows)
      return (int)cudaErrorInvalidValue;
  ekf15_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      rows, w, (const float*)x_in, (const float*)P_in, (const float*)tick, (float*)x_out,
      (float*)P_out, (float*)pd_out);
  return (int)cudaGetLastError();
}
