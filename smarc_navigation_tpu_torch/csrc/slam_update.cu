// K2 / K3: the EKF-SLAM sequential measurement update of one tick: the
// first phase of the streamed schedule, and the one-kernel schedule.
//
// Replaces the TPU kernels smarc_navigation_tpu/ops/slam_kernels.py::
// sequential_update_fleet (K2, pallas_call at :791, body
// _make_update_kernel_fleet) and ::sequential_update (K3, pallas_call at
// :213, body _update_kernel). K3 is K2 at B=1 with no predict, no
// landmark-position init and no band. Contract: the dense in-place "full"
// update of ekf_slam.da_commit (upd_dense), preceded by _fleet_predict's Σ
// transform when a8 is given — this package's
// ops/slam_kernels.sequential_update_fleet_reference.
//
// Factor form, Σ in device memory:
//   Σ_j (the covariance seen by update j) = Σ' + Act − Σ_{k<j} U_kᵀ V_k,
//   U_k = K_kᵀ = (S⁻¹H)_k rows_k, V_k = H_k rows_k (dim × D each),
// where Σ' is the motion-predicted Σ (pose rows P = Ã Σ[0:6,:], the 6×6
// block Ã Σ66 Ãᵀ + R̃) and Act the new-landmark diagonal blocks (added onto
// rows/cols that are zero by the padding invariant, as the TPU kernel
// does). Update j needs only the nine (pose, slot) rows of Σ_j, assembled
// per column from Σ' minus the earlier factors. After the M updates,
// μ_out = μ + (cand on added slots) + Σ_j ν_jᵀ U_j with one angle wrap, and
// every entry of the new Σ is ½(s_ic + s_ci), s = Σ' + Act − UᵀV, both
// products taken with the same fmaf sequence (so Σ_out is exactly
// symmetric); the (24, L) landmark band is computed by the same entry
// function.
//
// Streamed schedule, phase 1 (``phase1_kernel``, Sigma_out null): a grid
// of (column tile, mission) blocks writes U, V, μ, the band, the predicted
// pose rows P and Act's diagonal; K12 (csrc/slam_downdate.cu) then writes
// Σ_out over tiles with the same entry arithmetic. Update j at column c
// reads column c of Σ', the earlier factors at column c, and the earlier
// factors at the ≤ 6 + 3M pivot indices (pose rows 0-5, each update's
// three slot rows), and the factors at the pivots depend on the pivots
// alone. So in every block two warps step through the M updates at the
// pivot columns (a lane per pivot, looping past 64 pivots) and publish each
// step;
// four warps take the block's 126 columns and two halo columns, a thread
// per column, each update as soon as the pivot step before it is out. The
// halo serves the band entries (i, i+d) that reach past the block's last
// slot (tiles are a multiple of 3 wide, so a slot's three columns never
// straddle two blocks). Everything the block reads from device memory is
// loaded up front into the block's working set: shared memory, or, where
// the set outgrows it (on the H100, M > 26 at dim 3, M > 31 at dim 2), the
// block's slice of a device scratch buffer — slower, the same arithmetic.
// The first phase 1 ran one block per mission with a barrier after each
// update (128 blocks at the L=64 headline, 32 at L=256, one at B=1):
// 263.6 µs at D=774, B=32 (NVIDIA H100 80GB HBM3, 700.00 W),
// nearly all of it load latency on a few SMs.
//
// One-kernel schedule (``update_kernel``, Sigma_out given): one block per
// mission, U and V in global scratch, the whole downdate in the same block
// (0.43 ms at the L=64 headline, 8.06 ms at D=774 on that card). It stays
// as it was written first, the yardstick: phase 1 and K12 take every
// product as an explicit fmaf in the order its contracted `+=`/`-=` chains
// take them (the build keeps -fmad=true), so the schedules give the same
// bits.
//
// What bounds phase 1 on the H100: latency. Its bytes (the 6 + 3M pivot
// rows of Σ, Σ's pose rows, U and V out) are ~1 % of the downdate's; the
// factors are ~2·M·dim·9 FMAs per column and update step. A block's time
// is its loads, the predict of the pose rows, the chain of M pivot steps
// (a named barrier each) and the band; the grid is B × ⌈D/126⌉ blocks.

#include <cuda_runtime.h>
#include <stdint.h>

#include "slam_common.cuh"

namespace {

constexpr int kThreads = 256;  // one-kernel schedule: one block per mission
constexpr int kTile = 126;     // phase 1: the columns a block owns (a multiple of 3)
constexpr int kCols = 128;     // ... plus two halo columns; one thread per column
constexpr int kPivLanes = 64;  // ... and two warps for the 6 + 3M pivot columns
constexpr int kP1Threads = kCols + kPivLanes;
static_assert(kTile % 3 == 0 && kCols == kTile + 2, "phase-1 tiles align on landmark slots");

// ---------------------------------------------------------------------------
// one-kernel schedule: one block per mission (the yardstick, as it was)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
update_kernel(int D, int M, int dim, int L,
              const float* __restrict__ Sigma, const float* __restrict__ mu,
              const float* __restrict__ H_sel, const float* __restrict__ SinvH,
              const float* __restrict__ nu, const int* __restrict__ lm_ix,
              const bool* __restrict__ do_, const bool* __restrict__ add,
              const float* __restrict__ new_lm_cov, const float* __restrict__ cand,
              const float* __restrict__ a8, float* __restrict__ P,
              float* __restrict__ U, float* __restrict__ V,
              float* __restrict__ Sigma_out, float* __restrict__ mu_out,
              float* __restrict__ band_out) {
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int K = M * dim;
  const float* S = Sigma + (size_t)b * D * D;
  const float* a8b = a8 ? a8 + (size_t)b * 128 : nullptr;
  float* Pb = a8 ? P + (size_t)b * 6 * D : nullptr;
  float* Ub = U + (size_t)b * K * D;
  float* Vb = V + (size_t)b * K * D;
  const int* lmb = lm_ix + (size_t)b * M;
  const bool* dob = do_ + (size_t)b * M;
  const bool* addb = add + (size_t)b * M;

  // --- motion predict: pose rows of Σ' = Ã Σ Ãᵀ + R̃ ---------------------------
  // a8 rows 0:6: cols 0:6 = A, cols 8:14 = R̃ (identity A / zero R̃ when the
  // odometry is invalid, which makes this an exact no-op on those rows).
  if (a8b) {
    for (int idx = tid; idx < 6 * D; idx += blockDim.x) {
      const int i = idx / D, c = idx % D;
      float acc = 0.0f;
      if (c >= 6) {
        for (int k = 0; k < 6; ++k) acc += a8b[i * 16 + k] * S[k * D + c];
      } else {
        for (int k = 0; k < 6; ++k) {
          float t = 0.0f;  // (Σ66 Aᵀ)[k][c]
          for (int l = 0; l < 6; ++l) t += S[k * D + l] * a8b[c * 16 + l];
          acc += a8b[i * 16 + k] * t;
        }
        acc += a8b[i * 16 + 8 + c];
      }
      Pb[i * D + c] = acc;
    }
    __syncthreads();
  }
  // Σ'(i, c): predicted pose rows, their transpose in the pose columns
  auto sp = [&](int i, int c) -> float {
    if (Pb) {
      if (i < 6) return Pb[i * D + c];
      if (c < 6) return Pb[c * D + i];
    }
    return S[(size_t)i * D + c];
  };
  // new-landmark diagonal blocks activated by updates 0..last
  auto act = [&](int i, int c, int last) -> float {
    float a = 0.0f;
    if (i != c) return a;
    for (int k = 0; k <= last; ++k) {
      const int o = i - lmb[k];
      if (addb[k] && o >= 0 && o < 3) a += new_lm_cov[o];
    }
    return a;
  };

  // --- M sequential updates in measurement order -------------------------------
  for (int j = 0; j < M; ++j) {
    const int lmj = lmb[j];
    const float* Gj = SinvH + ((size_t)b * M + j) * dim * 9;
    const float* Hj = H_sel + ((size_t)b * M + j) * dim * 9;
    for (int c = tid; c < D; c += blockDim.x) {
      if (!dob[j]) {
        for (int d = 0; d < dim; ++d) {
          Ub[(j * dim + d) * D + c] = 0.0f;
          Vb[(j * dim + d) * D + c] = 0.0f;
        }
        continue;
      }
      float rows[9];
      for (int r = 0; r < 9; ++r) {
        const int i = r < 6 ? r : lmj + r - 6;
        float val = sp(i, c) + act(i, c, j);
        for (int k = 0; k < j; ++k) {
          if (!dob[k]) continue;
          for (int d = 0; d < dim; ++d)
            val -= Ub[(k * dim + d) * D + i] * Vb[(k * dim + d) * D + c];
        }
        rows[r] = val;
      }
      for (int d = 0; d < dim; ++d) {
        float kt = 0.0f, vt = 0.0f;
        for (int r = 0; r < 9; ++r) {
          kt += Gj[d * 9 + r] * rows[r];
          vt += Hj[d * 9 + r] * rows[r];
        }
        Ub[(j * dim + d) * D + c] = kt;
        Vb[(j * dim + d) * D + c] = vt;
      }
    }
    __syncthreads();
  }

  // --- μ: landmark init on added slots, the gains' innovations, one wrap -------
  for (int c = tid; c < D; c += blockDim.x) {
    float m = mu[(size_t)b * D + c];
    if (cand) {
      for (int k = 0; k < M; ++k) {
        const int o = c - lmb[k];
        if (addb[k] && o >= 0 && o < 3) m += cand[((size_t)b * M + k) * 3 + o];
      }
    }
    for (int k = 0; k < M; ++k) {
      if (!dob[k]) continue;
      for (int d = 0; d < dim; ++d)
        m += nu[((size_t)b * M + k) * dim + d] * Ub[(k * dim + d) * D + c];
    }
    if (c >= 3 && c < 6) m = slam::wrap_angle(m);
    mu_out[(size_t)b * D + c] = m;
  }

  // --- the new Σ: entry (i, c) = ½(s_ic + s_ci), s = Σ' + Act − UᵀV ------------
  const int last = M - 1;
  auto entry = [&](int i, int c) -> float {
    float s_ic = sp(i, c) + act(i, c, last);
    float s_ci = sp(c, i) + act(c, i, last);
    for (int k = 0; k < M; ++k) {
      if (!dob[k]) continue;
      for (int d = 0; d < dim; ++d) {
        const float* u = Ub + (k * dim + d) * D;
        const float* v = Vb + (k * dim + d) * D;
        s_ic = fmaf(-u[i], v[c], s_ic);
        s_ci = fmaf(-u[c], v[i], s_ci);
      }
    }
    return 0.5f * (s_ic + s_ci);
  };
  float* So = Sigma_out + (size_t)b * D * D;
  for (int idx = tid; idx < D * D; idx += blockDim.x) So[idx] = entry(idx / D, idx % D);

  // --- landmark block-diagonal band of the new Σ -------------------------------
  if (band_out) {
    for (int idx = tid; idx < 24 * L; idx += blockDim.x) {
      const int row = idx / L, l = idx % L;
      const int a = row / 8, d = row % 8;
      float val = 0.0f;
      if (d < 3) {
        const int i = 6 + 3 * l + a;
        val = entry(i, i + d < D - 1 ? i + d : D - 1);
      }
      band_out[(size_t)b * 24 * L + idx] = val;
    }
  }
}

// ---------------------------------------------------------------------------
// streamed schedule, phase 1: a grid of (column tile, mission) blocks
// ---------------------------------------------------------------------------

// μ_out[c]: landmark init on added slots, the gains' innovations, one wrap;
// u(r) is factor row r at column c
template <class FU>
__device__ __forceinline__ float mu_entry(float m, int c, int M, int dim, const int* lmb,
                                          const bool* dob, const bool* addb,
                                          const float* candb, const float* nub, FU u) {
  if (candb) {
    for (int k = 0; k < M; ++k) {
      const int o = c - lmb[k];
      if (addb[k] && o >= 0 && o < 3) m += candb[k * 3 + o];
    }
  }
  for (int k = 0; k < M; ++k) {
    if (!dob[k]) continue;
    for (int d = 0; d < dim; ++d) m = fmaf(nub[k * dim + d], u(k * dim + d), m);
  }
  if (c >= 3 && c < 6) m = slam::wrap_angle(m);
  return m;
}

// the predicted pose rows 0-5 of Σ' at column c (s(k, col) reads the raw
// Σ[k][col]): the one-kernel predict's arithmetic, its Σ66 Ãᵀ column taken
// once
template <class FS>
__device__ __forceinline__ void predict_col(FS s, const float* a8b, int c, float* out) {
  if (c >= 6) {
    float sc[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) sc[k] = s(k, c);
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < 6; ++k) acc = fmaf(a8b[i * 16 + k], sc[k], acc);
      out[i] = acc;
    }
    return;
  }
  float t[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    t[k] = 0.0f;
#pragma unroll
    for (int l = 0; l < 6; ++l) t[k] = fmaf(s(k, l), a8b[c * 16 + l], t[k]);
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < 6; ++k) acc = fmaf(a8b[i * 16 + k], t[k], acc);
    out[i] = acc + a8b[i * 16 + 8 + c];
  }
}

// where a phase-1 block keeps what it stages and computes (offsets in 4-byte
// words; the float4-read sections 16-byte aligned)
struct P1Layout {
  int npv;  // the pivot columns' stride, 6 + 3M rounded up to 4
  int upose, uslot, gh, sp, spp, ut, vt, vpv, pp, pt, act, pact, nub, candb, a8b, nlc;
  int lmb, piv, klist, nbefore, flags;
  int floats;  // the whole set, in 4-byte words, a multiple of 4
  size_t bytes;
  __host__ __device__ static int r4(int n) { return (n + 3) & ~3; }
  __host__ __device__ P1Layout(int M, int dim) {
    const int K = M * dim, np = 6 + 3 * M;
    npv = r4(np);
    int o = 0;
    upose = o; o += K * 8;         // U at the pose pivots, K × 8 (two pad)
    uslot = o; o += K * M * 4;     // U at update j's slot pivots, K × M × 4 (one pad)
    gh = o; o += 2 * K * 12;       // S⁻¹H then H rows, each padded to 12
    sp = o; o += r4(np * kCols);   // Σ' at (pivot row, block column)
    spp = o; o += r4(np * np);     // Σ' at (pivot row, pivot column)
    ut = o; o += K * kCols;        // the factors at the block's columns
    vt = o; o += K * kCols;
    vpv = o; o += K * npv;         // V at the pivot columns
    pp = o; o += r4(6 * np);       // predicted pose rows at the pivot columns
    pt = o; o += 6 * kCols;        // ... at the block's columns
    act = o; o += kCols;           // the columns' activation after the last update
    pact = o; o += npv;            // the pivots' activation so far
    nub = o; o += r4(K);
    candb = o; o += r4(3 * M);
    a8b = o; o += 128;
    nlc = o; o += 4;
    lmb = o; o += M;               // ints
    piv = o; o += np;              // the pivots' state indices
    klist = o; o += K;             // the factor rows of the applied updates, in order
    nbefore = o; o += M + 1;       // how many of them precede update j
    flags = o;                     // do, add
    floats = r4(o + (2 * M + 3) / 4);
    bytes = 4 * (size_t)floats;
  }
};

// one column's step j: the nine rows of Σ_j at the column from Σ' (base(q),
// plus Act where the pivot is the column) minus the earlier factors, then
// K_jᵀ and V_j there — the one-kernel schedule's fmaf sequence, the applied
// updates' factor rows in order (vown(kd): V row kd at the column)
template <int DIM, class FB, class FV>
__device__ __forceinline__ void column_step(int j, int M, int col, float act_j, const int* piv,
                                            const int* klist, int nb, FB base, FV vown,
                                            const float* upose, const float* uslot,
                                            const float* gh, float* kt, float* vt) {
  float rows[9];
#pragma unroll
  for (int r = 0; r < 9; ++r) {
    const int q = r < 6 ? r : 3 * j + r;  // pivot 6 + 3j + (r - 6)
    rows[r] = base(q) + (piv[q] == col ? act_j : 0.0f);
  }
  for (int t = 0; t < nb; ++t) {
    const int kd = klist[t];
    const float v = vown(kd);
    const float4 p = *reinterpret_cast<const float4*>(upose + kd * 8);
    const float2 p2 = *reinterpret_cast<const float2*>(upose + kd * 8 + 4);
    const float4 sl = *reinterpret_cast<const float4*>(uslot + (kd * M + j) * 4);
    rows[0] = fmaf(-p.x, v, rows[0]);
    rows[1] = fmaf(-p.y, v, rows[1]);
    rows[2] = fmaf(-p.z, v, rows[2]);
    rows[3] = fmaf(-p.w, v, rows[3]);
    rows[4] = fmaf(-p2.x, v, rows[4]);
    rows[5] = fmaf(-p2.y, v, rows[5]);
    rows[6] = fmaf(-sl.x, v, rows[6]);
    rows[7] = fmaf(-sl.y, v, rows[7]);
    rows[8] = fmaf(-sl.z, v, rows[8]);
  }
#pragma unroll
  for (int d = 0; d < DIM; ++d) {
    const float* g = gh + (j * DIM + d) * 12;
    const float* h = gh + ((M + j) * DIM + d) * 12;
    float gr[12], hr[12];
#pragma unroll
    for (int u = 0; u < 3; ++u) {
      const float4 g4 = *reinterpret_cast<const float4*>(g + 4 * u);
      const float4 h4 = *reinterpret_cast<const float4*>(h + 4 * u);
      gr[4 * u] = g4.x, gr[4 * u + 1] = g4.y, gr[4 * u + 2] = g4.z, gr[4 * u + 3] = g4.w;
      hr[4 * u] = h4.x, hr[4 * u + 1] = h4.y, hr[4 * u + 2] = h4.z, hr[4 * u + 3] = h4.w;
    }
    float k_ = 0.0f, v_ = 0.0f;
#pragma unroll
    for (int r = 0; r < 9; ++r) {
      k_ = fmaf(gr[r], rows[r], k_);
      v_ = fmaf(hr[r], rows[r], v_);
    }
    kt[d] = k_;
    vt[d] = v_;
  }
}

// the activation update j adds on the diagonal at column c (the next term of
// the one-kernel schedule's act(c, c, j) sum)
__device__ __forceinline__ float activation_step(float a, int c, int j, const int* lmb,
                                                 const bool* addb, const float* new_lm_cov) {
  const int o = c - lmb[j];
  return (addb[j] && o >= 0 && o < 3) ? a + new_lm_cov[o] : a;
}

template <int DIM, bool SPILL>
__global__ void __launch_bounds__(kP1Threads)
phase1_kernel(int D, int M, int L,
              const float* __restrict__ Sigma, const float* __restrict__ mu,
              const float* __restrict__ H_sel, const float* __restrict__ SinvH,
              const float* __restrict__ nu, const int* __restrict__ lm_ix,
              const bool* __restrict__ do_, const bool* __restrict__ add,
              const float* __restrict__ new_lm_cov, const float* __restrict__ cand,
              const float* __restrict__ a8, float* __restrict__ P,
              float* __restrict__ U, float* __restrict__ V,
              float* __restrict__ mu_out, float* __restrict__ band_out,
              float* __restrict__ act_out, float* spill) {
  // the working set: dynamic shared memory (known as such to the compiler,
  // which then issues shared loads), or the block's slice of the device
  // scratch where it does not fit there
  extern __shared__ float4 sm4[];
  __shared__ int done_step;  // pivot steps published
  const P1Layout ly(M, DIM);
  float* sm = SPILL ? spill + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * ly.floats
                    : reinterpret_cast<float*>(sm4);
  const int K = M * DIM, np = 6 + 3 * M, npv = ly.npv;
  float* upose = sm + ly.upose;
  float* uslot = sm + ly.uslot;
  float* gh = sm + ly.gh;
  float* SP = sm + ly.sp;
  float* SPP = sm + ly.spp;
  float* UT = sm + ly.ut;
  float* VT = sm + ly.vt;
  float* VPV = sm + ly.vpv;
  float* PP = sm + ly.pp;
  float* PT = sm + ly.pt;
  float* ACT = sm + ly.act;
  float* PACT = sm + ly.pact;
  float* nub = sm + ly.nub;
  float* candb = sm + ly.candb;
  float* a8b = sm + ly.a8b;
  float* nlc = sm + ly.nlc;
  int* lmb = reinterpret_cast<int*>(sm + ly.lmb);
  int* piv = reinterpret_cast<int*>(sm + ly.piv);
  int* klist = reinterpret_cast<int*>(sm + ly.klist);
  int* nbefore = reinterpret_cast<int*>(sm + ly.nbefore);
  volatile int* done = &done_step;
  bool* dob = reinterpret_cast<bool*>(sm + ly.flags);
  bool* addb = dob + M;

  const int b = blockIdx.y, tid = threadIdx.x;
  const int c0 = blockIdx.x * kTile;
  const float* S = Sigma + (size_t)b * D * D;

  // the block's slots for the band: a thread per (slot, row a) of those
  // whose columns the block owns
  const int end = c0 + kTile < D ? c0 + kTile : D;
  const int l_lo = c0 > 6 ? (c0 - 6) / 3 : 0;
  const int l_hi = end > 6 ? ((end - 6) / 3 < L ? (end - 6) / 3 : L) : 0;
  const bool banded = band_out && tid < 3 * (l_hi - l_lo);
  const int bi = 6 + 3 * (l_lo + tid / 3) + tid % 3;  // the band thread's row i

  // --- the mission's update data and the pivots (pose rows 0-5, then each
  // update's three slot rows, clamped: a skipped update's slot may lie past
  // the state); the band's Σ entries and μ, loaded early --------------------------
  for (int e = tid; e < K * 12; e += kP1Threads) {
    const int row = e / 12, r = e % 12;
    gh[e] = r < 9 ? SinvH[((size_t)b * K + row) * 9 + r] : 0.0f;
    gh[K * 12 + e] = r < 9 ? H_sel[((size_t)b * K + row) * 9 + r] : 0.0f;
  }
  for (int e = tid; e < K; e += kP1Threads) nub[e] = nu[(size_t)b * K + e];
  if (cand)
    for (int e = tid; e < 3 * M; e += kP1Threads) candb[e] = cand[(size_t)b * 3 * M + e];
  if (a8)
    for (int e = tid; e < 128; e += kP1Threads) a8b[e] = a8[(size_t)b * 128 + e];
  for (int e = tid; e < M; e += kP1Threads) {
    lmb[e] = lm_ix[(size_t)b * M + e];
    dob[e] = do_[(size_t)b * M + e];
    addb[e] = add[(size_t)b * M + e];
  }
  if (tid < 3) nlc[tid] = new_lm_cov[tid];
  for (int q = tid; q < np; q += kP1Threads) {
    int i = q;
    if (q >= 6) {
      i = lm_ix[(size_t)b * M + (q - 6) / 3] + (q - 6) % 3;
      i = i < 0 ? 0 : (i > D - 1 ? D - 1 : i);
    }
    piv[q] = i;
  }
  if (tid == 0) {
    int n = 0;
    for (int j = 0; j < M; ++j) {
      nbefore[j] = n;
      if (do_[(size_t)b * M + j])
        for (int d = 0; d < DIM; ++d) klist[n++] = j * DIM + d;
    }
    nbefore[M] = n;
    *done = 0;
  }
  float band_s[6];  // Σ' at (i, i+d) and (i+d, i): the raw Σ away from the pose rows
  if (banded) {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const int cc = bi + d < D - 1 ? bi + d : D - 1;
      band_s[d] = S[(size_t)bi * D + cc];
      band_s[3 + d] = S[(size_t)cc * D + bi];
    }
  }
  const float mu_c = tid < kCols && c0 + tid < D ? mu[(size_t)b * D + c0 + tid] : 0.0f;
  __syncthreads();

  // --- the raw Σ at (pivot, pivot), a warp per row, and at (pivot, block
  // column), a thread per column, loads in flight together ------------------------
  if (tid >= kCols) {
    for (int qr = (tid - kCols) / 32; qr < np; qr += kPivLanes / 32)
      for (int qc = tid % 32; qc < np; qc += 32) SPP[qr * np + qc] = S[(size_t)piv[qr] * D + piv[qc]];
  } else if (c0 + tid < D) {
    constexpr int kBatch = 8;
    for (int q0 = 0; q0 < np; q0 += kBatch) {
      float v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (q0 + u < np) v[u] = S[(size_t)piv[q0 + u] * D + c0 + tid];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (q0 + u < np) SP[(q0 + u) * kCols + tid] = v[u];
    }
  }
  __syncthreads();

  // --- Σ' there: the predicted pose rows (their transpose in the pose
  // columns); rows 0-5 of SPP and SP hold Σ's raw pose rows. Each thread
  // patches the column it works on, the pose columns after the barrier that
  // publishes the pivots' pose rows. (A skipped update's pivots, clamped,
  // may land in the pose rows; their entries are never read.) ------------------
  if (a8) {
    if (tid < kCols) {
      if (c0 + tid < D) {
        float out[6];
        predict_col([&](int k, int col) { return col < 6 ? SPP[k * np + col] : SP[k * kCols + tid]; },
                    a8b, c0 + tid, out);
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          PT[i * kCols + tid] = out[i];
          SP[i * kCols + tid] = out[i];
        }
      }
    } else {
      for (int q = tid - kCols; q < np; q += kPivLanes) {
        float out[6];
        predict_col([&](int k, int col) { return SPP[k * np + (col < 6 ? col : q)]; }, a8b,
                    piv[q], out);
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          PP[i * np + q] = out[i];
          if (q >= 6) SPP[i * np + q] = out[i];
        }
      }
    }
    __syncthreads();
    const int q = tid - kCols;
    if (tid < 6 && c0 == 0) {
      for (int qr = 6; qr < np; ++qr) SP[qr * kCols + tid] = PP[tid * np + qr];
    } else if (q >= 0 && q < 6) {
#pragma unroll
      for (int i = 0; i < 6; ++i) SPP[i * np + q] = PP[i * np + q];
      for (int qr = 6; qr < np; ++qr) SPP[qr * np + q] = PP[q * np + qr];
    }
  }

  // --- the M updates: two warps step through them at the pivot columns and
  // publish each step; the block's columns follow one step behind ----------------
  if (tid >= kCols) {
    for (int j = 0; j < M; ++j) {
      for (int q = tid - kCols; q < np; q += kPivLanes) {  // pivot q stays with one lane
        const int col = piv[q];
        const float act = activation_step(j ? PACT[q] : 0.0f, col, j, lmb, addb, nlc);
        PACT[q] = act;
        if (!dob[j]) continue;
        float kt[DIM], vt[DIM];
        column_step<DIM>(j, M, col, act, piv, klist, nbefore[j],
                         [&](int qr) { return SPP[qr * np + q]; },
                         [&](int kd) { return VPV[kd * npv + q]; }, upose, uslot, gh, kt, vt);
#pragma unroll
        for (int d = 0; d < DIM; ++d) {
          const int kd = j * DIM + d;
          VPV[kd * npv + q] = vt[d];
          if (q < 6) upose[kd * 8 + q] = kt[d];
          else uslot[(kd * M + (q - 6) / 3) * 4 + (q - 6) % 3] = kt[d];
        }
      }
      asm volatile("bar.sync 1, %0;" ::"n"(kPivLanes));
      if (tid == kCols) {
        __threadfence_block();
        *done = j + 1;
      }
    }
  } else if (c0 + tid < D) {
    const int x = tid, c = c0 + x;
    float act = 0.0f;
    for (int j = 0; j < M; ++j) {
      act = activation_step(act, c, j, lmb, addb, nlc);
      if (!dob[j]) {
#pragma unroll
        for (int d = 0; d < DIM; ++d) {
          const int kd = j * DIM + d;
          UT[kd * kCols + x] = 0.0f;
          VT[kd * kCols + x] = 0.0f;
          if (x < kTile) {
            U[((size_t)b * K + kd) * D + c] = 0.0f;
            V[((size_t)b * K + kd) * D + c] = 0.0f;
          }
        }
        continue;
      }
      while (*done < j) __nanosleep(32);
      __threadfence_block();
      float kt[DIM], vt[DIM];
      column_step<DIM>(j, M, c, act, piv, klist, nbefore[j],
                       [&](int qr) { return SP[qr * kCols + x]; },
                       [&](int kd) { return VT[kd * kCols + x]; }, upose, uslot, gh, kt, vt);
#pragma unroll
      for (int d = 0; d < DIM; ++d) {
        const int kd = j * DIM + d;
        UT[kd * kCols + x] = kt[d];
        VT[kd * kCols + x] = vt[d];
        if (x < kTile) {  // the owned columns (the halo's belong to the next block)
          U[((size_t)b * K + kd) * D + c] = kt[d];
          V[((size_t)b * K + kd) * D + c] = vt[d];
        }
      }
    }
    ACT[x] = act;
    if (x < kTile) {  // the owned columns' outputs
      mu_out[(size_t)b * D + c] =
          mu_entry(mu_c, c, M, DIM, lmb, dob, addb, cand ? candb : nullptr, nub,
                   [&](int r) { return UT[r * kCols + x]; });
      act_out[(size_t)b * D + c] = act;
      if (a8)
        for (int i = 0; i < 6; ++i) P[((size_t)b * 6 + i) * D + c] = PT[i * kCols + x];
    }
  }

  // --- the band of the slots whose columns the block owns: a thread per
  // (slot, row a), its three entries (i, i+d) -------------------------------------
  if (band_out) {
    __syncthreads();
    if (banded) {
      // the one-kernel entry's two chains for each of the three entries, interleaved over
      // the applied updates' factor rows in order
      const int l = l_lo + tid / 3, a = tid % 3, i = bi, xi = i - c0;
      int xc[3];
      float s_ic[3], s_ci[3];
#pragma unroll
      for (int d = 0; d < 3; ++d) {  // Act(i, cc) is column i's activation where cc = i
        const int cc = i + d < D - 1 ? i + d : D - 1;
        const float act = cc == i ? ACT[xi] : 0.0f;
        xc[d] = cc - c0;
        s_ic[d] = band_s[d] + act;
        s_ci[d] = band_s[3 + d] + act;
      }
      const int nk = nbefore[M];
      for (int t = 0; t < nk; ++t) {
        const int r = klist[t];
        const float ui = UT[r * kCols + xi], vi = VT[r * kCols + xi];
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          s_ic[d] = fmaf(-ui, VT[r * kCols + xc[d]], s_ic[d]);
          s_ci[d] = fmaf(-UT[r * kCols + xc[d]], vi, s_ci[d]);
        }
      }
      float* out = band_out + ((size_t)b * 24 + a * 8) * L + l;
#pragma unroll
      for (int d = 0; d < 3; ++d) out[d * L] = 0.5f * (s_ic[d] + s_ci[d]);
      for (int d = 3; d < 8; ++d) out[d * L] = 0.0f;
    }
  }
}

// the shared memory a block may opt into on the device (cached)
int smem_optin(int device) {
  static int optin[64];
  if (!optin[device] &&
      cudaDeviceGetAttribute(&optin[device], cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
          cudaSuccess)
    return 0;
  return optin[device];
}

// whether phase 1's working set at (M, dim) fits in a block's shared memory
// beside the kernel's own word (done_step)
bool phase1_fits(int device, int M, int dim) {
  return P1Layout(M, dim).bytes + 16 <= (size_t)smem_optin(device);
}

// raise the dynamic shared memory a phase-1 kernel may take, per device; it
// only grows, so a graph's earlier nodes keep what they were launched with
template <int DIM>
cudaError_t phase1_smem(int device, size_t smem) {
  static size_t set[64];
  if (smem <= 48 * 1024 || smem <= set[device]) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      phase1_kernel<DIM, false>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) set[device] = smem;
  return e;
}

}  // namespace

// the 4-byte words of device scratch phase 1 needs for B missions at (D, M,
// dim): 0 where its working set fits in shared memory, else one slice per
// block; negative on an invalid argument
extern "C" long long slam_update_phase1_scratch(int device, int B, int D, int M, int dim) {
  if (device < 0 || device >= 64 || B < 1 || D < 9 || M < 1 || (dim != 2 && dim != 3)) return -1;
  if (phase1_fits(device, M, dim)) return 0;
  return (long long)B * ((D + kTile - 1) / kTile) * P1Layout(M, dim).floats;
}

extern "C" int slam_update_launch(int device, void* stream, int B, int D, int M,
                                  int dim, int L, const void* Sigma,
                                  const void* mu, const void* H_sel,
                                  const void* SinvH, const void* nu,
                                  const void* lm_ix, const void* do_,
                                  const void* add, const void* new_lm_cov,
                                  const void* cand, const void* a8, void* P,
                                  void* U, void* V, void* Sigma_out,
                                  void* mu_out, void* band_out, void* act_out,
                                  void* scratch) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (B < 1 || B > 65535 || D < 9 || D != 6 + 3 * L || M < 1 || (dim != 2 && dim != 3))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Sigma_out) {  // the one-kernel schedule
    update_kernel<<<B, kThreads, 0, st>>>(
        D, M, dim, L, (const float*)Sigma, (const float*)mu, (const float*)H_sel,
        (const float*)SinvH, (const float*)nu, (const int*)lm_ix, (const bool*)do_,
        (const bool*)add, (const float*)new_lm_cov, (const float*)cand, (const float*)a8,
        (float*)P, (float*)U, (float*)V, (float*)Sigma_out, (float*)mu_out,
        (float*)band_out);
    return (int)cudaGetLastError();
  }
  if (!act_out) return (int)cudaErrorInvalidValue;  // phase 1 writes Act's diagonal
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  // the working set in shared memory, or in the caller's scratch
  // (slam_update_phase1_scratch words) where it does not fit
  const bool fits = phase1_fits(device, M, dim);
  if (!fits && !scratch) return (int)cudaErrorInvalidValue;
  const size_t smem = fits ? P1Layout(M, dim).bytes : 0;
  e = dim == 3 ? phase1_smem<3>(device, smem) : phase1_smem<2>(device, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((D + kTile - 1) / kTile, B);
  auto kernel = dim == 3 ? (fits ? phase1_kernel<3, false> : phase1_kernel<3, true>)
                         : (fits ? phase1_kernel<2, false> : phase1_kernel<2, true>);
  kernel<<<grid, kP1Threads, smem, st>>>(
      D, M, L, (const float*)Sigma, (const float*)mu, (const float*)H_sel, (const float*)SinvH,
      (const float*)nu, (const int*)lm_ix, (const bool*)do_, (const bool*)add,
      (const float*)new_lm_cov, (const float*)cand, (const float*)a8, (float*)P, (float*)U,
      (float*)V, (float*)mu_out, (float*)band_out, (float*)act_out,
      fits ? nullptr : (float*)scratch);
  return (int)cudaGetLastError();
}
