// K1: the whole EKF-SLAM data-association stage of one fleet tick, and K11:
// the fleet's exact assignment on its own.
//
// K1 replaces the TPU kernel smarc_navigation_tpu/ops/slam_da_kernels.py::
// da_lanes (pallas_call at :581, body _make_da_kernel, JV core _jv_lanes).
// Contract: ekf_slam.da_stage + the selection of ekf_slam.da_commit's kernel
// branch, i.e. this package's ops/slam_da_kernels.da_lanes_reference.
//
// One thread block per mission. Per mission, in order:
//   1. optional motion predict of the Σ slabs it reads: Spp' = A Spp Aᵀ + R̃,
//      Spl' = A Spl (Σ_ll is untouched by the predict);
//   2. threads over the L landmark slots: the MBES point model h = Rᵀ(lm − p)
//      (or the FLS pixel model chained through the sensor extrinsic), its
//      dim×9 Jacobian written out in closed form, S = H Σ9 Hᵀ + Q, S⁻¹, and the
//      gated Mahalanobis costs of every detection -> (L+M)×M table in shared;
//   3. threads over the M detections: back-projected candidate, its H, S⁻¹, ν;
//   4. exact Jonker-Volgenant assignment in one warp; the argmin breaks ties
//      to the lowest row index, as the reference's jnp.argmin does;
//   5. the sequential capacity-denial prefix and the per-detection selection
//      (H_sel, S⁻¹H, ν, cand, col_to_row, do, add, slot).
// Only rows 0:6 of Σ are read for Spp/Spl (Sll comes from the band when it
// is given), so the same kernel takes the marginal fleet's pose rows (B,8,D)
// in place of Σ (B,D,D): the per-mission stride is an argument.
//
// What bounds it on the H100: latency, not bytes or FLOPs. A mission reads
// ~6 KB of Σ slabs at L=64 and the arithmetic is ~100 kFLOP; the serial parts
// are the JV (≤ M(M+1)/2 Dijkstra steps of one warp) and the selection.
// Design: everything lives in shared memory (~16 KB at L=64, M=8; ~56 KB at
// L=256) and the slot loop spreads over the block; with B=128 missions the
// grid is about one wave on 132 SMs. Built with -fmad=false so the gate and
// cost arithmetic rounds each product like the plain PyTorch version's
// elementwise ops.
//
// K11 replaces smarc_navigation_tpu/ops/slam_da_kernels.py::hungarian_lanes
// (pallas_call at :616, body _make_jv_kernel): the exact JV of an (R, C) cost
// table per mission, one warp per mission on the table staged in shared
// memory, the same device function as K1's step 4 (same duals, same tie
// rule as ops/assignment.hungarian). Bound: latency of the serial Dijkstra
// steps (≤ C(C+1)/2 warp-wide argmins over R rows); the table is read once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kFlsScale = 400.0f / 17.0f;  // px per metre
constexpr float kInf = 1e30f;
constexpr int kThreads = 128;

// par layout (32 floats): [q0,q1,q2, lam, outlier, mh_dist, nl0,nl1,nl2,
//                          rsb00..rsb22 (9-17), tsb0..2 (18-20)]
struct Shared {
  float* R;      // 9   rotation R(rpy)
  float* dR;     // 27  dR/d(roll,pitch,yaw) [k][i][j]
  float* Spp;    // 36  (predicted) pose block
  float* tmp;    // 36
  float* H;      // L*dim*9
  float* Si;     // L*dim*dim
  float* zh;     // L*dim
  float* cost;   // (L+M)*M, row-major [r*M + c]
  float* Hc;     // M*dim*9
  float* Sic;    // M*dim*dim
  float* nuc;    // M*dim
  float* cand;   // M*3
  float* v;      // R rows
  float* minv;   // R
  float* u;      // M
  int* way;      // R
  int* used;     // R
  int* p;        // R+1
  int* sel;      // 4*M: ctr, slot, do, add
};

__host__ __device__ inline size_t shared_floats(int L, int M, int dim) {
  const int R = L + M;
  return 9 + 27 + 36 + 36 + (size_t)L * (dim * 9 + dim * dim + dim) +
         (size_t)R * M + (size_t)M * (dim * 9 + dim * dim + dim + 3) +
         2 * (size_t)R + M + 2 * (size_t)R + (R + 1) + 4 * (size_t)M;
}

__device__ inline Shared carve(float* base, int L, int M, int dim) {
  Shared s;
  const int R = L + M;
  float* f = base;
  s.R = f; f += 9;
  s.dR = f; f += 27;
  s.Spp = f; f += 36;
  s.tmp = f; f += 36;
  s.H = f; f += L * dim * 9;
  s.Si = f; f += L * dim * dim;
  s.zh = f; f += L * dim;
  s.cost = f; f += R * M;
  s.Hc = f; f += M * dim * 9;
  s.Sic = f; f += M * dim * dim;
  s.nuc = f; f += M * dim;
  s.cand = f; f += M * 3;
  s.v = f; f += R;
  s.minv = f; f += R;
  s.u = f; f += M;
  int* i = reinterpret_cast<int*>(f);
  s.way = i; i += R;
  s.used = i; i += R;
  s.p = i; i += R + 1;
  s.sel = i;
  return s;
}

// Point Jacobian column c of the 3x9 [Hp | Ha | Hl] for a base-frame point
// with map offset diff: Hp = -Rᵀ, Ha[i][k] = Σ_j dR[k][j][i] diff[j], Hl = Rᵀ.
__device__ inline void point_model(const float* R, const float* dR,
                                   const float diff[3], float zh[3],
                                   float Hpt[3][9]) {
  for (int i = 0; i < 3; ++i) {
    zh[i] = R[0 * 3 + i] * diff[0] + R[1 * 3 + i] * diff[1] + R[2 * 3 + i] * diff[2];
    for (int k = 0; k < 3; ++k) {
      const float* d = dR + k * 9;
      Hpt[i][3 + k] = d[0 * 3 + i] * diff[0] + d[1 * 3 + i] * diff[1] +
                      d[2 * 3 + i] * diff[2];
    }
    for (int c = 0; c < 3; ++c) {
      Hpt[i][c] = -R[c * 3 + i];
      Hpt[i][6 + c] = R[c * 3 + i];
    }
  }
}

// FLS chain: v = R_fls_base·h + t, z = s·(‖(v0, v2)‖, −v1); H rows are the
// point Jacobian rows weighted by h₂·R_fls_base at v.
__device__ inline void fls_model(const float* par, const float zh3[3],
                                 float Hpt[3][9], float zh[2],
                                 float H[2][9]) {
  const float* rsb = par + 9;
  const float* tsb = par + 18;
  float v[3];
  for (int i = 0; i < 3; ++i)
    v[i] = rsb[i * 3 + 0] * zh3[0] + rsb[i * 3 + 1] * zh3[1] +
           rsb[i * 3 + 2] * zh3[2] + tsb[i];
  const float n = sqrtf(v[0] * v[0] + v[2] * v[2] + 1e-12f);
  const float inv_n = 1.0f / n;
  zh[0] = kFlsScale * n;
  zh[1] = -kFlsScale * v[1];
  float w0[3], w1[3];
  for (int j = 0; j < 3; ++j) {
    w0[j] = kFlsScale * (v[0] * rsb[0 * 3 + j] + v[2] * rsb[2 * 3 + j]) * inv_n;
    w1[j] = -kFlsScale * rsb[1 * 3 + j];
  }
  for (int c = 0; c < 9; ++c) {
    H[0][c] = w0[0] * Hpt[0][c] + w0[1] * Hpt[1][c] + w0[2] * Hpt[2][c];
    H[1][c] = w1[0] * Hpt[0][c] + w1[1] * Hpt[1][c] + w1[2] * Hpt[2][c];
  }
}

template <int DIM>
__device__ inline void inv_sym(float S[DIM][DIM], float Si[DIM][DIM]) {
  if constexpr (DIM == 2) {
    const float det = S[0][0] * S[1][1] - S[0][1] * S[0][1];
    const float inv_det = 1.0f / det;
    Si[0][0] = S[1][1] * inv_det;
    Si[0][1] = -S[0][1] * inv_det;
    Si[1][0] = Si[0][1];
    Si[1][1] = S[0][0] * inv_det;
  } else {
    const float c00 = S[1][1] * S[2][2] - S[1][2] * S[1][2];
    const float c01 = S[0][2] * S[1][2] - S[0][1] * S[2][2];
    const float c02 = S[0][1] * S[1][2] - S[0][2] * S[1][1];
    const float det = S[0][0] * c00 + S[0][1] * c01 + S[0][2] * c02;
    const float inv_det = 1.0f / det;
    Si[0][0] = c00 * inv_det;
    Si[0][1] = c01 * inv_det;
    Si[0][2] = c02 * inv_det;
    Si[1][1] = (S[0][0] * S[2][2] - S[0][2] * S[0][2]) * inv_det;
    Si[1][2] = (S[0][1] * S[0][2] - S[0][0] * S[1][2]) * inv_det;
    Si[2][2] = (S[0][0] * S[1][1] - S[0][1] * S[0][1]) * inv_det;
    Si[1][0] = Si[0][1];
    Si[2][0] = Si[0][2];
    Si[2][1] = Si[1][2];
  }
}

// S = H Σ9 Hᵀ + diag(q) for Σ9 given entry-wise by sig9(c, d).
template <int DIM, typename Sig9>
__device__ inline void innovation(float H[DIM][9], Sig9 sig9,
                                  const float* q, float S[DIM][DIM]) {
  float W[DIM][9];
  for (int a = 0; a < DIM; ++a)
    for (int d = 0; d < 9; ++d) {
      float acc = 0.0f;
      for (int c = 0; c < 9; ++c) acc += H[a][c] * sig9(c, d);
      W[a][d] = acc;
    }
  for (int a = 0; a < DIM; ++a)
    for (int b = a; b < DIM; ++b) {
      float acc = 0.0f;
      for (int d = 0; d < 9; ++d) acc += W[a][d] * H[b][d];
      if (a == b) acc += q[a];
      S[a][b] = acc;
      S[b][a] = acc;
    }
}

// Exact JV over the (R, C) table in shared memory, run by one warp.
__device__ void jv_warp(const float* cost, int R, int C, Shared& s) {
  const int lane = threadIdx.x & 31;
  for (int r = lane; r < R; r += 32) {
    s.v[r] = 0.0f;
    s.p[r] = -1;
  }
  for (int c = lane; c < C; c += 32) s.u[c] = 0.0f;
  if (lane == 0) s.p[R] = -1;
  __syncwarp();
  for (int c = 0; c < C; ++c) {
    for (int r = lane; r < R; r += 32) {
      s.minv[r] = kInf;
      s.way[r] = R;
      s.used[r] = 0;
    }
    if (lane == 0) s.p[R] = c;
    __syncwarp();
    int j0 = R;
    while (true) {
      const int i0 = s.p[j0];
      const float ui0 = s.u[i0];
      float best = 3.0e38f;  // above every slack (unused rows hold < 1e30)
      int besti = R;
      for (int r = lane; r < R; r += 32) {
        if (s.used[r]) continue;
        const float cur = cost[r * C + i0] - ui0 - s.v[r];
        if (cur < s.minv[r]) {
          s.minv[r] = cur;
          s.way[r] = j0;
        }
        const float mv = s.minv[r];
        if (mv < best) {  // rows ascend within a lane: first minimum kept
          best = mv;
          besti = r;
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best, off);
        const int oi = __shfl_xor_sync(0xffffffffu, besti, off);
        if (ob < best || (ob == best && oi < besti)) {
          best = ob;
          besti = oi;
        }
      }
      const float delta = best;
      const int j1 = besti;
      __syncwarp();
      // dual update: used rows' columns gain delta (distinct columns, no
      // races), used rows' potentials drop, unused slacks shrink
      for (int r = lane; r < R; r += 32) {
        if (s.used[r]) {
          s.v[r] -= delta;
          if (s.p[r] >= 0) s.u[s.p[r]] += delta;
        } else {
          s.minv[r] -= delta;
        }
      }
      if (lane == 0) s.u[c] += delta;  // the virtual root row carries column c
      __syncwarp();
      if (lane == 0) s.used[j1] = 1;
      __syncwarp();
      j0 = j1;
      if (s.p[j1] < 0) break;  // reached a free row
    }
    if (lane == 0) {  // augment along the predecessor chain to the root
      int j = j0;
      while (j != R) {
        const int j1 = s.way[j];
        s.p[j] = s.p[j1];
        j = j1;
      }
      s.p[R] = -1;
    }
    __syncwarp();
  }
}

template <bool FLS, bool PREDICT>
__global__ void __launch_bounds__(kThreads)
da_kernel(int L, int M, int D, long long sig_stride, int use_band,
          const float* __restrict__ pose6, const int* __restrict__ n_active,
          const bool* __restrict__ active, const float* __restrict__ lm_pos,
          const float* __restrict__ Sigma, const float* __restrict__ z,
          const bool* __restrict__ z_mask, const float* __restrict__ par,
          const float* __restrict__ A, const float* __restrict__ r_full,
          const float* __restrict__ band,
          int* __restrict__ ctr_out, float* __restrict__ H_sel,
          float* __restrict__ SinvH, float* __restrict__ nu_sel,
          float* __restrict__ cand_out, bool* __restrict__ do_out,
          bool* __restrict__ add_out, int* __restrict__ slot_out) {
  constexpr int DIM = FLS ? 2 : 3;
  extern __shared__ float smem[];
  Shared s = carve(smem, L, M, DIM);
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int R = L + M;
  const float* pose = pose6 + (size_t)b * 6;
  const float* Sg = Sigma + (size_t)b * sig_stride;  // row stride D either way
  const float* zb = z + (size_t)b * M * 3;
  const bool* mb = z_mask + (size_t)b * M;
  const float* Ab = PREDICT ? A + (size_t)b * 36 : nullptr;
  const float lam = par[3], outl = par[4], mh = par[5];

  // --- rotation, its derivatives, the (predicted) pose block -----------------
  if (tid == 0) {
    const float sr = sinf(pose[3]), cr = cosf(pose[3]);
    const float sp = sinf(pose[4]), cp = cosf(pose[4]);
    const float sy = sinf(pose[5]), cy = cosf(pose[5]);
    const float Rm[9] = {cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr,
                         sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr,
                         -sp,     cp * sr,                cp * cr};
    const float dRm[27] = {
        // d/droll
        0.0f, cy * sp * cr + sy * sr, -cy * sp * sr + sy * cr,
        0.0f, sy * sp * cr - cy * sr, -sy * sp * sr - cy * cr,
        0.0f, cp * cr, -cp * sr,
        // d/dpitch
        -cy * sp, cy * cp * sr, cy * cp * cr,
        -sy * sp, sy * cp * sr, sy * cp * cr,
        -cp, -sp * sr, -sp * cr,
        // d/dyaw
        -sy * cp, -sy * sp * sr - cy * cr, -sy * sp * cr + cy * sr,
        cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr,
        0.0f, 0.0f, 0.0f};
    for (int i = 0; i < 9; ++i) s.R[i] = Rm[i];
    for (int i = 0; i < 27; ++i) s.dR[i] = dRm[i];
  }
  if (tid < 36) {
    const int k = tid / 6, j = tid % 6;
    if (PREDICT) {  // tmp = Spp Aᵀ
      float acc = 0.0f;
      for (int l = 0; l < 6; ++l) acc += Sg[k * D + l] * Ab[j * 6 + l];
      s.tmp[tid] = acc;
    } else {
      s.Spp[tid] = Sg[k * D + j];
    }
  }
  __syncthreads();
  if (PREDICT && tid < 36) {  // Spp' = A tmp + R̃
    const int i = tid / 6, j = tid % 6;
    float acc = 0.0f;
    for (int k = 0; k < 6; ++k) acc += Ab[i * 6 + k] * s.tmp[k * 6 + j];
    s.Spp[tid] = acc + r_full[(size_t)b * 36 + tid];
  }
  __syncthreads();

  // --- correspondence against every landmark slot ----------------------------
  for (int l = tid; l < L; l += blockDim.x) {
    const float* lm = lm_pos + ((size_t)b * L + l) * 3;
    const float diff[3] = {lm[0] - pose[0], lm[1] - pose[1], lm[2] - pose[2]};
    float zh3[3], Hpt[3][9];
    point_model(s.R, s.dR, diff, zh3, Hpt);
    float zh[DIM], H[DIM][9];
    if constexpr (FLS) {
      fls_model(par, zh3, Hpt, zh, H);
    } else {
      for (int i = 0; i < DIM; ++i) {
        zh[i] = zh3[i];
        for (int c = 0; c < 9; ++c) H[i][c] = Hpt[i][c];
      }
    }
    const int lc = 6 + 3 * l;
    float Spl[6][3];  // Σ[0:6, lm] (predicted: A Σ[0:6, lm])
    for (int i = 0; i < 6; ++i)
      for (int k = 0; k < 3; ++k) {
        if (PREDICT) {
          float acc = 0.0f;
          for (int j = 0; j < 6; ++j) acc += Ab[i * 6 + j] * Sg[j * D + lc + k];
          Spl[i][k] = acc;
        } else {
          Spl[i][k] = Sg[i * D + lc + k];
        }
      }
    float Sll[3][3];
    for (int a = 0; a < 3; ++a)
      for (int c = 0; c < 3; ++c) {
        if (use_band) {
          const int row = (a < c ? a : c) * 8 + (c > a ? c - a : a - c);
          Sll[a][c] = band[((size_t)b * 24 + row) * L + l];
        } else {
          Sll[a][c] = Sg[(lc + a) * D + lc + c];
        }
      }
    const float* Spp = s.Spp;
    auto sig9 = [&](int c, int d) -> float {
      if (c < 6 && d < 6) return Spp[c * 6 + d];
      if (c < 6) return Spl[c][d - 6];
      if (d < 6) return Spl[d][c - 6];
      return Sll[c - 6][d - 6];
    };
    float S[DIM][DIM], Si[DIM][DIM];
    innovation<DIM>(H, sig9, par, S);
    inv_sym<DIM>(S, Si);
    for (int a = 0; a < DIM; ++a) {
      s.zh[l * DIM + a] = zh[a];
      for (int c = 0; c < 9; ++c) s.H[(l * DIM + a) * 9 + c] = H[a][c];
      for (int c = 0; c < DIM; ++c) s.Si[(l * DIM + a) * DIM + c] = Si[a][c];
    }
    const bool act = active[(size_t)b * L + l];
    for (int m = 0; m < M; ++m) {
      float nu[DIM];
      for (int a = 0; a < DIM; ++a) nu[a] = zb[m * 3 + a] - zh[a];
      float dm = 0.0f;
      for (int a = 0; a < DIM; ++a)
        for (int c = 0; c < DIM; ++c) dm += nu[a] * Si[a][c] * nu[c];
      const bool gate = (dm < lam) && act && mb[m];
      s.cost[l * M + m] = gate ? dm : outl;
    }
  }

  // --- new-landmark candidates ------------------------------------------------
  for (int m = tid; m < M; m += blockDim.x) {
    const float* zm = zb + m * 3;
    float cm[3];
    if constexpr (FLS) {  // pixels -> FLS-frame point s⁻¹·(z0, −z1, 0) -> base -> map
      const float* rsb = par + 9;
      const float* tsb = par + 18;
      const float pf[3] = {zm[0] / kFlsScale, -zm[1] / kFlsScale, 0.0f};
      float pb[3];
      for (int a = 0; a < 3; ++a)
        pb[a] = rsb[0 * 3 + a] * (pf[0] - tsb[0]) + rsb[1 * 3 + a] * (pf[1] - tsb[1]) +
                rsb[2 * 3 + a] * (pf[2] - tsb[2]);
      for (int a = 0; a < 3; ++a)
        cm[a] = s.R[a * 3 + 0] * pb[0] + s.R[a * 3 + 1] * pb[1] +
                s.R[a * 3 + 2] * pb[2] + pose[a];
    } else {
      for (int a = 0; a < 3; ++a)
        cm[a] = s.R[a * 3 + 0] * zm[0] + s.R[a * 3 + 1] * zm[1] +
                s.R[a * 3 + 2] * zm[2] + pose[a];
    }
    const float diff[3] = {cm[0] - pose[0], cm[1] - pose[1], cm[2] - pose[2]};
    float zh3[3], Hpt[3][9];
    point_model(s.R, s.dR, diff, zh3, Hpt);
    float zh[DIM], H[DIM][9];
    if constexpr (FLS) {
      fls_model(par, zh3, Hpt, zh, H);
    } else {
      for (int i = 0; i < DIM; ++i) {
        zh[i] = zh3[i];
        for (int c = 0; c < 9; ++c) H[i][c] = Hpt[i][c];
      }
    }
    const float* Spp = s.Spp;
    const float* nl = par + 6;
    auto sig9c = [&](int c, int d) -> float {
      if (c < 6 && d < 6) return Spp[c * 6 + d];
      if (c >= 6 && c == d) return nl[c - 6];
      return 0.0f;
    };
    float S[DIM][DIM], Si[DIM][DIM];
    innovation<DIM>(H, sig9c, par, S);
    inv_sym<DIM>(S, Si);
    for (int a = 0; a < DIM; ++a) {
      s.nuc[m * DIM + a] = zm[a] - zh[a];
      for (int c = 0; c < 9; ++c) s.Hc[(m * DIM + a) * 9 + c] = H[a][c];
      for (int c = 0; c < DIM; ++c) s.Sic[(m * DIM + a) * DIM + c] = Si[a][c];
    }
    for (int a = 0; a < 3; ++a) s.cand[m * 3 + a] = cm[a];
    for (int c = 0; c < M; ++c) s.cost[(L + m) * M + c] = (c == m) ? mh : outl;
  }
  __syncthreads();

  // --- exact assignment -------------------------------------------------------
  if (tid < 32) jv_warp(s.cost, R, M, s);
  __syncthreads();
  int* ctr = s.sel;
  int* slot = s.sel + M;
  int* dos = s.sel + 2 * M;
  int* adds = s.sel + 3 * M;
  for (int r = tid; r < R; r += blockDim.x)
    if (s.p[r] >= 0) ctr[s.p[r]] = r;
  __syncthreads();

  // --- capacity-denial prefix (sequential over detections) -------------------
  if (tid == 0) {
    const int n_act = n_active[b];
    int cum = 0;
    for (int m = 0; m < M; ++m) {
      const int r = ctr[m];
      const bool is_new = r >= L;
      const int r_clip = r < L - 1 ? r : L - 1;
      const bool can_add = mb[m] && is_new && (n_act + cum < L);
      dos[m] = mb[m] && (can_add || !is_new);
      adds[m] = can_add;
      slot[m] = is_new ? n_act + cum : r_clip;
      cum += can_add ? 1 : 0;
    }
  }
  __syncthreads();

  // --- selection ---------------------------------------------------------------
  for (int m = tid; m < M; m += blockDim.x) {
    const int r = ctr[m];
    const bool is_new = r >= L;
    const int rc = r < L - 1 ? r : L - 1;
    float Hs[DIM][9], Ss[DIM][DIM];
    for (int a = 0; a < DIM; ++a) {
      for (int c = 0; c < 9; ++c)
        Hs[a][c] = is_new ? s.Hc[(m * DIM + a) * 9 + c] : s.H[(rc * DIM + a) * 9 + c];
      for (int c = 0; c < DIM; ++c)
        Ss[a][c] = is_new ? s.Sic[(m * DIM + a) * DIM + c]
                          : s.Si[(rc * DIM + a) * DIM + c];
    }
    const size_t o = (size_t)b * M + m;
    for (int a = 0; a < DIM; ++a) {
      nu_sel[o * DIM + a] = is_new ? s.nuc[m * DIM + a] : zb[m * 3 + a] - s.zh[rc * DIM + a];
      for (int c = 0; c < 9; ++c) {
        float acc = 0.0f;
        for (int k = 0; k < DIM; ++k) acc += Ss[a][k] * Hs[k][c];
        H_sel[(o * DIM + a) * 9 + c] = Hs[a][c];
        SinvH[(o * DIM + a) * 9 + c] = acc;
      }
    }
    for (int a = 0; a < 3; ++a) cand_out[o * 3 + a] = s.cand[m * 3 + a];
    ctr_out[o] = r;
    slot_out[o] = slot[m];
    do_out[o] = dos[m] != 0;
    add_out[o] = adds[m] != 0;
  }
}

template <bool FLS, bool PREDICT>
cudaError_t launch(int B, int L, int M, int D, long long sig_stride, int use_band,
                   cudaStream_t stream,
                   const float* pose6, const int* n_active, const bool* active,
                   const float* lm_pos, const float* Sigma, const float* z,
                   const bool* z_mask, const float* par, const float* A,
                   const float* r_full, const float* band, int* ctr, float* H_sel,
                   float* SinvH, float* nu_sel, float* cand, bool* do_out,
                   bool* add_out, int* slot) {
  const size_t smem = shared_floats(L, M, FLS ? 2 : 3) * sizeof(float);
  auto kern = da_kernel<FLS, PREDICT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<B, kThreads, smem, stream>>>(L, M, D, sig_stride, use_band, pose6, n_active, active,
                                      lm_pos, Sigma, z, z_mask, par, A, r_full,
                                      band, ctr, H_sel, SinvH, nu_sel, cand,
                                      do_out, add_out, slot);
  return cudaGetLastError();
}

// K11: one warp per mission solves its (R, C) table (row-major, [r*C + c]).
__global__ void __launch_bounds__(32)
jv_kernel(int R, int C, const float* __restrict__ cost, int* __restrict__ col_to_row) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  float* tab = smem;
  Shared s;
  float* f = tab + (size_t)R * C;
  s.v = f; f += R;
  s.minv = f; f += R;
  s.u = f; f += C;
  int* i = reinterpret_cast<int*>(f);
  s.way = i; i += R;
  s.used = i; i += R;
  s.p = i;
  const float* cb = cost + (size_t)b * R * C;
  for (int k = lane; k < R * C; k += 32) tab[k] = cb[k];
  __syncwarp();
  jv_warp(tab, R, C, s);
  if (lane == 0) {
    int* out = col_to_row + (size_t)b * C;
    for (int c = 0; c < C; ++c) out[c] = -1;
    for (int r = 0; r < R; ++r)
      if (s.p[r] >= 0) out[s.p[r]] = r;
  }
}

}  // namespace

extern "C" int slam_da_launch(int device, void* stream, int B, int L, int M,
                              int D, int pose_rows, int fls, int predict,
                              int use_band,
                              const void* pose6, const void* n_active,
                              const void* active, const void* lm_pos,
                              const void* Sigma, const void* z,
                              const void* z_mask, const void* par, const void* A,
                              const void* r_full, const void* band, void* ctr,
                              void* H_sel, void* SinvH, void* nu_sel, void* cand,
                              void* do_out, void* add_out, void* slot) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (B < 1 || L < 1 || M < 1) return (int)cudaErrorInvalidValue;
  if (pose_rows && !use_band) return (int)cudaErrorInvalidValue;  // Sll needs the band
  const long long sig_stride = pose_rows ? 8LL * D : (long long)D * D;
  auto st = static_cast<cudaStream_t>(stream);
#define SLAM_DA_ARGS                                                          \
  B, L, M, D, sig_stride, use_band, st, (const float*)pose6, (const int*)n_active,        \
      (const bool*)active, (const float*)lm_pos, (const float*)Sigma,         \
      (const float*)z, (const bool*)z_mask, (const float*)par,                \
      (const float*)A, (const float*)r_full, (const float*)band, (int*)ctr,   \
      (float*)H_sel, (float*)SinvH, (float*)nu_sel, (float*)cand,             \
      (bool*)do_out, (bool*)add_out, (int*)slot
  if (fls)
    e = predict ? launch<true, true>(SLAM_DA_ARGS) : launch<true, false>(SLAM_DA_ARGS);
  else
    e = predict ? launch<false, true>(SLAM_DA_ARGS) : launch<false, false>(SLAM_DA_ARGS);
#undef SLAM_DA_ARGS
  return (int)e;
}

extern "C" int hungarian_lanes_launch(int device, void* stream, int B, int R, int C,
                                      const void* cost, void* col_to_row) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (B < 1 || C < 1 || C > R) return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)R * C + 2 * (size_t)R + C) * sizeof(float) +
                      (3 * (size_t)R + 1) * sizeof(int);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(jv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  jv_kernel<<<B, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      R, C, (const float*)cost, (int*)col_to_row);
  return (int)cudaGetLastError();
}
