// K4: the EKF-SLAM fleet update under the reference's own covariance
// semantics — the 9×9 (pose, matched landmark) marginal writeback.
//
// Replaces the TPU kernel smarc_navigation_tpu/ops/slam_kernels.py::
// sequential_update_marginal_fleet (pallas_call at :1124, body
// _make_marginal_kernel_fleet). Contract: this package's
// ops/slam_kernels.sequential_update_marginal_fleet_reference.
//
// Under marginal semantics the cross-landmark covariance blocks stay zero,
// so a mission's whole covariance is its pose rows P = Σ[0:6, :] (carried as
// (8, D), rows 6:8 padding) plus the (24, L) landmark block-diagonal band.
// One block per mission keeps all of it in shared memory (P 6·D, band 24·L
// and μ D floats: 46 KB at L=256) and, in order:
//   1. with a8, the motion predict of the pose rows: lanes ≥ 6 become
//      A·P[:, c], the 6×6 block (A Σ66) Aᵀ + R̃ (an identity a8 with zero R̃
//      leaves P bit for bit);
//   2. the M updates in measurement order, each on the 9×9 marginal:
//      Σ9 from the P columns {0:6, lm:lm+3}, its landmark rows' pose block
//      read as the transpose of the pose-row cross block (the reference
//      kernel's documented ulp-level divergence from the dense path), the
//      landmark block from the band slot (diag(new_lm_cov) for an add);
//      Kᵀ = S⁻¹H·Σ9, V = H·Σ9, Σ9' = Σ9 − (Kᵀ)ᵀV; P's nine columns and the
//      band slot are SET from Σ9'; μ's nine entries gain νᵀKᵀ (+ cand on an
//      add) and the attitude is wrapped after every update;
//   3. P rows, μ and the band are written out once.
//
// What bounds it on the H100: latency. At L=256, B=32 it moves ~3.4 MB
// (about 1 µs at 3.35 TB/s) and does ~20 kFLOP per mission; each update is a
// chain of four dependent 9×9-sized steps separated by block barriers. The
// design keeps every step in shared memory so the chain pays barrier and
// shared-memory latency only, with one global read and write of the state.

#include <cuda_runtime.h>
#include <stdint.h>

#include "slam_common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
marginal_kernel(int D, int L, int M, int dim,
                const float* __restrict__ P_in, const float* __restrict__ mu_in,
                const float* __restrict__ H_sel, const float* __restrict__ SinvH,
                const float* __restrict__ nu, const int* __restrict__ lm_ix,
                const bool* __restrict__ do_, const bool* __restrict__ add,
                const float* __restrict__ new_lm_cov, const float* __restrict__ cand,
                const float* __restrict__ band_in, const float* __restrict__ a8,
                float* __restrict__ P_out, float* __restrict__ mu_out,
                float* __restrict__ band_out) {
  extern __shared__ float smem[];
  float* P = smem;             // 6 × D pose rows
  float* bnd = P + 6 * D;      // 24 × L band
  float* mu = bnd + 24 * L;    // D
  __shared__ float t6[36];     // (A Σ66) of the predict
  __shared__ float s9[81], s9n[81];
  __shared__ float kv[54];     // Kᵀ rows 0:dim (×9), V rows at 27
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const float* Pb = P_in + (size_t)b * 8 * D;
  float* Po = P_out + (size_t)b * 8 * D;

  for (int k = tid; k < 6 * D; k += blockDim.x) P[k] = Pb[k];
  for (int k = tid; k < 2 * D; k += blockDim.x) Po[6 * D + k] = Pb[6 * D + k];
  for (int k = tid; k < 24 * L; k += blockDim.x) bnd[k] = band_in[(size_t)b * 24 * L + k];
  for (int k = tid; k < D; k += blockDim.x) mu[k] = mu_in[(size_t)b * D + k];
  __syncthreads();

  // --- 1. motion predict of the pose rows -------------------------------------
  if (a8) {
    const float* a = a8 + (size_t)b * 128;  // rows of 16: A at cols 0:6, R̃ at 8:14
    if (tid < 36) {
      const int i = tid / 6, l = tid % 6;
      float acc = 0.0f;
      for (int k = 0; k < 6; ++k) acc += a[i * 16 + k] * P[k * D + l];
      t6[tid] = acc;
    }
    __syncthreads();
    if (tid < 36) {  // the 6×6 block from t6 (read before this barrier)
      const int i = tid / 6, c = tid % 6;
      float acc = 0.0f;
      for (int l = 0; l < 6; ++l) acc += t6[i * 6 + l] * a[c * 16 + l];
      P[i * D + c] = acc + a[i * 16 + 8 + c];
    }
    for (int c = 6 + tid; c < D; c += blockDim.x) {  // one thread per column
      float old[6];
      for (int k = 0; k < 6; ++k) old[k] = P[k * D + c];
      for (int i = 0; i < 6; ++i) {
        float acc = 0.0f;
        for (int k = 0; k < 6; ++k) acc += a[i * 16 + k] * old[k];
        P[i * D + c] = acc;
      }
    }
    __syncthreads();
  }

  // --- 2. sequential 9×9 marginal updates --------------------------------------
  const float* nl = new_lm_cov;
  for (int j = 0; j < M; ++j) {
    const size_t o = (size_t)b * M + j;
    if (!do_[o]) continue;  // uniform over the block
    const int lm = lm_ix[o];
    const int slot = (lm - 6) / 3;
    const bool ad = add[o];
    auto sel = [&](int r) { return r < 6 ? r : lm + r - 6; };

    if (tid < 81) {  // Σ9
      const int r = tid / 9, c = tid % 9;
      float v;
      if (r < 6) {
        v = P[r * D + sel(c)];
      } else if (c < 6) {
        v = P[c * D + sel(r)];  // transpose of the pose-row cross block
      } else {
        const int a_ = r - 6, c_ = c - 6;
        if (ad) {
          v = a_ == c_ ? nl[a_] : 0.0f;
        } else {
          const int row = (a_ < c_ ? a_ : c_) * 8 + (a_ < c_ ? c_ - a_ : a_ - c_);
          v = bnd[row * L + slot];
        }
      }
      s9[tid] = v;
    }
    __syncthreads();
    if (tid < 2 * dim * 9) {  // Kᵀ = S⁻¹H Σ9 and V = H Σ9
      const int which = tid / (dim * 9), rem = tid % (dim * 9);
      const int d = rem / 9, c = rem % 9;
      const float* g = (which ? H_sel : SinvH) + (o * dim + d) * 9;
      float acc = 0.0f;
      for (int r = 0; r < 9; ++r) acc += g[r] * s9[r * 9 + c];
      kv[which * 27 + d * 9 + c] = acc;
    }
    __syncthreads();
    if (tid < 81) {  // Σ9' = Σ9 − (Kᵀ)ᵀ V
      const int r = tid / 9, c = tid % 9;
      float acc = 0.0f;
      for (int d = 0; d < dim; ++d) acc += kv[d * 9 + r] * kv[27 + d * 9 + c];
      s9n[tid] = s9[tid] - acc;
    } else if (tid < 90) {  // μ += νᵀKᵀ (+ cand on an add), attitude wrapped
      const int c = tid - 81;
      float dmu = 0.0f;
      for (int d = 0; d < dim; ++d) dmu += nu[o * dim + d] * kv[d * 9 + c];
      if (c >= 6 && ad) dmu += cand[o * 3 + (c - 6)];
      float m = mu[sel(c)] + dmu;
      if (c >= 3 && c < 6) m = slam::wrap_angle(m);
      mu[sel(c)] = m;
    }
    __syncthreads();
    if (tid < 54) {  // P rows 0:6 at the nine columns (SET)
      const int i = tid / 9, c = tid % 9;
      P[i * D + sel(c)] = s9n[i * 9 + c];
    } else if (tid < 78) {  // band slot (SET): row a*8+d <- Σ9'[6+a, 6+min(a+d, 2)]
      const int row = tid - 54, a_ = row / 8, d = row % 8;
      const int c = a_ + d < 2 ? a_ + d : 2;
      bnd[row * L + slot] = s9n[(6 + a_) * 9 + 6 + c];
    }
    __syncthreads();
  }

  // --- 3. write the state out -------------------------------------------------
  for (int k = tid; k < 6 * D; k += blockDim.x) Po[k] = P[k];
  for (int k = tid; k < 24 * L; k += blockDim.x) band_out[(size_t)b * 24 * L + k] = bnd[k];
  for (int k = tid; k < D; k += blockDim.x) mu_out[(size_t)b * D + k] = mu[k];
}

}  // namespace

extern "C" int slam_marginal_launch(int device, void* stream, int B, int D, int M,
                                    int dim, int L, const void* P_in,
                                    const void* mu_in, const void* H_sel,
                                    const void* SinvH, const void* nu,
                                    const void* lm_ix, const void* do_,
                                    const void* add, const void* new_lm_cov,
                                    const void* cand, const void* band_in,
                                    const void* a8, void* P_out, void* mu_out,
                                    void* band_out) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (B < 1 || L < 1 || D != 6 + 3 * L || M < 1 || (dim != 2 && dim != 3))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(7 * D + 24 * L) * sizeof(float);
  if (smem > 40 * 1024) {  // past the default, with the static arrays beside it
    e = cudaFuncSetAttribute(marginal_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  marginal_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      D, L, M, dim, (const float*)P_in, (const float*)mu_in, (const float*)H_sel,
      (const float*)SinvH, (const float*)nu, (const int*)lm_ix, (const bool*)do_,
      (const bool*)add, (const float*)new_lm_cov, (const float*)cand,
      (const float*)band_in, (const float*)a8, (float*)P_out, (float*)mu_out,
      (float*)band_out);
  return (int)cudaGetLastError();
}
