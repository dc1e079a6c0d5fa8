// K2 / K3: the EKF-SLAM sequential measurement update of one tick, and the
// first phase of K2's streamed schedule.
//
// Replaces the TPU kernels smarc_navigation_tpu/ops/slam_kernels.py::
// sequential_update_fleet (K2, pallas_call at :791, body
// _make_update_kernel_fleet) and ::sequential_update (K3, pallas_call at
// :213, body _update_kernel). K3 is this kernel at B=1 with no predict, no
// landmark-position init and no band. Contract: the dense in-place "full"
// update of ekf_slam.da_commit (upd_dense), preceded by _fleet_predict's Σ
// transform when a8 is given — this package's
// ops/slam_kernels.sequential_update_fleet_reference.
//
// One thread block per mission, Σ in device memory, factor form:
//   Σ_j (the covariance seen by update j) = Σ' + Act − Σ_{k<j} U_kᵀ V_k,
//   U_k = K_kᵀ = (S⁻¹H)_k rows_k, V_k = H_k rows_k (dim × D each),
// where Σ' is the motion-predicted Σ (pose rows P = A Σ[0:6,:] and the
// 6×6 block A Σ66 Aᵀ + R̃, built once in scratch) and Act the new-landmark
// diagonal blocks (added onto rows/cols that are zero by the padding
// invariant, as the TPU kernel does). Update j needs only the nine (pose,
// slot) rows of Σ_j, assembled per column from Σ' minus the earlier factors;
// U_j and V_j go to global scratch, so the kernel is correct for any D.
// After the M updates, μ_out = μ + (cand on added slots) + Σ_j ν_jᵀ U_j with
// one angle wrap, and every entry of the new Σ is ½(s_ic + s_ci),
// s = Σ' + Act − UᵀV, both products taken with the same fmaf sequence (so
// Σ_out is exactly symmetric); the (24, L) landmark band is computed by the
// same entry function.
// One-kernel schedule (Sigma_out given): the block also writes every entry
// of Σ_out. Streamed schedule, phase 1 (Sigma_out null): the block stops
// before the downdate and writes U, V, μ, the band, the predicted pose rows
// and Act's diagonal; K12 (csrc/slam_downdate.cu) then writes Σ_out with the
// same entry arithmetic over a grid of (tile pair, mission) blocks, so the
// two schedules agree bit for bit.
//
// Bytes: Σ is read in the final pass (twice, the second read transposed and
// mostly served by L1/L2) and written once: ~2 × 157 KB per mission at
// D=198, ~40 MB per fleet tick at B=128 (~12 µs at HBM3 bandwidth), plus 9
// rows per update. The in-place alternative rewrites Σ for each of the M
// updates (~8× the bytes). The downdate's 2·M·dim FMAs per entry (~2 MFLOP
// per mission) are far below the compute roof.
// What bounds it on the H100: load latency, not bytes. One 256-thread block
// per mission leaves each SM with 8 warps, and every Σ entry of the downdate
// reads 2·M·dim U/V values from L1/L2; the measured call (~0.43 ms at the
// L=64 headline on an NVIDIA H100 80GB HBM3 at 700.00 W) is far above the
// byte floor. At L=256 (D=774, B=32: 32 blocks on 132 SMs) the one-kernel
// downdate is the whole cost (8.06 ms on that card), which is what the
// streamed schedule's tiled K12 removes (phase 1 + K12: 0.40 ms).

#include <cuda_runtime.h>
#include <stdint.h>

#include "slam_common.cuh"

namespace {

constexpr int kThreads = 256;

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
              float* __restrict__ band_out, float* __restrict__ act_out) {
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
  if (Sigma_out) {  // one-kernel schedule: the whole downdate here
    float* So = Sigma_out + (size_t)b * D * D;
    for (int idx = tid; idx < D * D; idx += blockDim.x) So[idx] = entry(idx / D, idx % D);
  } else {  // streamed phase 1: what K12 needs besides U, V and P
    for (int c = tid; c < D; c += blockDim.x) act_out[(size_t)b * D + c] = act(c, c, last);
  }

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

}  // namespace

extern "C" int slam_update_launch(int device, void* stream, int B, int D, int M,
                                  int dim, int L, const void* Sigma,
                                  const void* mu, const void* H_sel,
                                  const void* SinvH, const void* nu,
                                  const void* lm_ix, const void* do_,
                                  const void* add, const void* new_lm_cov,
                                  const void* cand, const void* a8, void* P,
                                  void* U, void* V, void* Sigma_out,
                                  void* mu_out, void* band_out, void* act_out) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (B < 1 || D < 9 || M < 1 || (dim != 2 && dim != 3))
    return (int)cudaErrorInvalidValue;
  if (!Sigma_out && !act_out) return (int)cudaErrorInvalidValue;  // phase 1 needs Act
  update_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      D, M, dim, L, (const float*)Sigma, (const float*)mu, (const float*)H_sel,
      (const float*)SinvH, (const float*)nu, (const int*)lm_ix,
      (const bool*)do_, (const bool*)add, (const float*)new_lm_cov,
      (const float*)cand, (const float*)a8, (float*)P, (float*)U, (float*)V,
      (float*)Sigma_out, (float*)mu_out, (float*)band_out, (float*)act_out);
  return (int)cudaGetLastError();
}
