// K9: the whole EKF-localization fleet tick.
//
// Replaces the TPU kernel smarc_navigation_tpu/ops/loc_kernels.py::fleet_tick
// (pallas_call at :326, body _make_tick_kernel; the reference's
// models/ekf_localization.py::run_fleet launches the same body at :357).
// Contract: this package's ops/loc_kernels.fleet_tick_reference, which
// transcribes the TPU kernel's body in its operation order; this file keeps
// that order (compiled with -fmad=false, so every product is rounded as the
// plain version rounds it).
//
// One warp per mission, kWarps missions per block, the map (N × [x y z mask])
// in shared memory. Per mission:
//   1. the absolute-attitude predict, computed by every lane alike (lane 0
//      writes μ and Σ to the warp's shared slots);
//   2. for each of the M detections in order: every lane takes the slots
//      n ≡ lane (mod 32) and computes diff, ẑ, H, W = HΣ, the symmetric S,
//      its cofactor inverse (det clamped at 1e-30), ν, d, −½(d + log det)
//      and the gates; a warp max picks the best score and a warp min the
//      first slot reaching it (argmax's rule); the owning lane broadcasts the
//      winner's H angle block, S⁻¹ and ν by shuffle; every lane forms K = ΣHᵀS⁻¹
//      and μ'; lane l < 36 forms Σ'[l] = Σ[l] − (KH)Σ from K and H in shared
//      memory;
//   3. the no-input gate: a mission without IMU + DVL contact gets its input
//      μ and Σ back unchanged.
//
// What bounds it on the H100: latency. A tick moves ~1.7 KB per mission and
// does ~1 kFLOP per map slot and detection; the M updates form a dependent
// chain of warp reductions and broadcasts. The design keeps each mission in
// one warp so the chain needs no block barrier, only warp shuffles and
// __syncwarp, and reads the state from global memory once and writes it once.

#include <cuda_runtime.h>
#include <math.h>

#include "rot_common.cuh"
#include "slam_common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr float kNeg = -3.0e38f;
constexpr float kHalfPi = 1.57079632679489661923f;

__global__ void __launch_bounds__(kWarps * 32)
loc_tick_kernel(int B, int N, int M, const float* __restrict__ mu_in,
                const float* __restrict__ sig_in, const float* __restrict__ tick,
                const float* __restrict__ z, const float4* __restrict__ map4,
                const float* __restrict__ par, float* __restrict__ mu_out,
                float* __restrict__ sig_out, int* __restrict__ match_out,
                float* __restrict__ sigd_out) {
  extern __shared__ float4 smap[];          // N map rows [x y z mask]
  __shared__ float s_sig[kWarps][36];
  __shared__ float s_mu[kWarps][8];
  __shared__ float s_kh[kWarps][36];        // K (6×3) at 0, Hb (3×6) at 18
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int k = threadIdx.x; k < N; k += blockDim.x) smap[k] = map4[k];
  __syncthreads();
  const int b = blockIdx.x * kWarps + warp;
  if (b >= B) return;                       // no block barrier below
  float* sg = s_sig[warp];
  float* ms = s_mu[warp];
  float* kh = s_kh[warp];

  float qd[3], rd[6];
  for (int i = 0; i < 3; ++i) qd[i] = par[i];
  for (int i = 0; i < 6; ++i) rd[i] = par[3 + i];
  const float lam = par[9], eps = par[10];
  const float* tk = tick + (size_t)b * 8;
  const bool have = tk[6] > 0.5f;

  // ---- 1. motion predict (every lane alike) ---------------------------------
  {
    float rpy[3], db[3], mu[6], sig[36];
    for (int i = 0; i < 3; ++i) { rpy[i] = tk[i]; db[i] = tk[3 + i]; }
    for (int i = 0; i < 6; ++i) mu[i] = mu_in[(size_t)b * 6 + i];
    for (int i = 0; i < 36; ++i) sig[i] = sig_in[(size_t)b * 36 + i];
    slam::Trig tr;
    slam::rot_entries(rpy[0], rpy[1], rpy[2], tr);
    float mu6[6];
    for (int i = 0; i < 3; ++i) {
      float acc = 0.0f;
      for (int j = 0; j < 3; ++j) acc = acc + tr.R[i][j] * db[j];
      mu6[i] = mu[i] + acc;
      mu6[3 + i] = slam::wrap_angle(rpy[i]);
    }
    float J[3][3], T[3][3], U[3][3], UJt[3][3];
    for (int i = 0; i < 3; ++i)
      for (int k = 0; k < 3; ++k) {
        float acc = 0.0f;
        for (int j = 0; j < 3; ++j) acc = acc + tr.dR[k][i][j] * db[j];
        J[i][k] = acc;
      }
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        float t = 0.0f, u = 0.0f;
        for (int k = 0; k < 3; ++k) {
          t = t + J[i][k] * sig[(3 + k) * 6 + j];
          u = u + J[i][k] * sig[(3 + k) * 6 + 3 + j];
        }
        T[i][j] = t;
        U[i][j] = u;
      }
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        float acc = 0.0f;
        for (int k = 0; k < 3; ++k) acc = acc + U[i][k] * J[j][k];
        UJt[i][j] = acc;
      }
    if (lane == 0) {
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) {
          const float s = sig[i * 6 + j];
          sg[i * 6 + j] = ((s + T[i][j]) + T[j][i]) + UJt[i][j];
          sg[i * 6 + 3 + j] = s * 0.0f;
          sg[(3 + i) * 6 + j] = s * 0.0f;
          sg[(3 + i) * 6 + 3 + j] = s * 0.0f;
        }
      for (int i = 0; i < 6; ++i) sg[i * 7] = sg[i * 7] + rd[i];
      for (int i = 0; i < 6; ++i) ms[i] = mu6[i];
    }
    __syncwarp();
  }

  // ---- 2. M sequential greedy-ML updates ------------------------------------
  for (int m = 0; m < M; ++m) {
    const float* zz = z + ((size_t)b * M + m) * 4;
    const float z0 = zz[0], z1 = zz[1], z2 = zz[2];
    const bool zvalid = zz[3] > 0.5f;
    float mu[6], sig[36];
    for (int i = 0; i < 6; ++i) mu[i] = ms[i];
    for (int i = 0; i < 36; ++i) sig[i] = sg[i];
    slam::Trig tr;
    slam::rot_entries(mu[3], mu[4], mu[5], tr);
    const float tpre = tanf(slam::wrap_angle(kHalfPi + mu[5]));

    // this lane's best slot: score, index, H angle block, S⁻¹ (6), ν
    float best = -INFINITY;
    int best_n = N;
    float bHa[9], bSi[6], bnu[3];
    for (int i = 0; i < 9; ++i) bHa[i] = 0.0f;
    for (int i = 0; i < 6; ++i) bSi[i] = 0.0f;
    for (int i = 0; i < 3; ++i) bnu[i] = 0.0f;
    for (int n = lane; n < N; n += 32) {
      const float4 lm = smap[n];
      const float diff[3] = {lm.x - mu[0], lm.y - mu[1], lm.z - mu[2]};
      float zh[3], Ha[3][3], Hp[3][3];
      for (int i = 0; i < 3; ++i) {
        float acc = 0.0f;
        for (int j = 0; j < 3; ++j) acc = acc + tr.R[j][i] * diff[j];
        zh[i] = acc;
        for (int k = 0; k < 3; ++k) {
          float a = 0.0f;
          for (int j = 0; j < 3; ++j) a = a + tr.dR[k][j][i] * diff[j];
          Ha[i][k] = a;
        }
        for (int j = 0; j < 3; ++j) Hp[i][j] = -tr.R[j][i];
      }
      float W[3][6];
      for (int a = 0; a < 3; ++a)
        for (int d = 0; d < 6; ++d) {
          float acc = 0.0f;
          for (int c = 0; c < 6; ++c)
            acc = acc + (c < 3 ? Hp[a][c] : Ha[a][c - 3]) * sig[c * 6 + d];
          W[a][d] = acc;
        }
      float S[3][3];
      for (int a = 0; a < 3; ++a)
        for (int bb = a; bb < 3; ++bb) {
          float s = 0.0f;
          for (int d = 0; d < 6; ++d) s = s + W[a][d] * (d < 3 ? Hp[bb][d] : Ha[bb][d - 3]);
          if (a == bb) s = s + qd[a];
          S[a][bb] = s;
          S[bb][a] = s;
        }
      const float c00 = S[1][1] * S[2][2] - S[1][2] * S[1][2];
      const float c01 = S[0][2] * S[1][2] - S[0][1] * S[2][2];
      const float c02 = S[0][1] * S[1][2] - S[0][2] * S[1][1];
      float det = S[0][0] * c00 + S[0][1] * c01 + S[0][2] * c02;
      det = fmaxf(det, 1e-30f);
      const float inv_det = 1.0f / det;
      float Si[3][3];
      Si[0][0] = c00 * inv_det;
      Si[0][1] = c01 * inv_det;
      Si[0][2] = c02 * inv_det;
      Si[1][1] = (S[0][0] * S[2][2] - S[0][2] * S[0][2]) * inv_det;
      Si[1][2] = (S[0][1] * S[0][2] - S[0][0] * S[1][2]) * inv_det;
      Si[2][2] = (S[0][0] * S[1][1] - S[0][1] * S[0][1]) * inv_det;
      Si[1][0] = Si[0][1];
      Si[2][0] = Si[0][2];
      Si[2][1] = Si[1][2];
      const float nu[3] = {z0 - zh[0], z1 - zh[1], z2 - zh[2]};
      float dm = 0.0f;
      for (int a = 0; a < 3; ++a)
        for (int bb = 0; bb < 3; ++bb) dm = dm + nu[a] * Si[a][bb] * nu[bb];
      const float logpsi = -0.5f * (dm + logf(det));
      const bool pregate = eps > fabsf((lm.x - mu[0]) + (mu[1] - lm.y) / tpre);
      const bool ok = (lm.w > 0.5f) && pregate && (dm < lam) && zvalid;
      const float score = ok ? logpsi : kNeg;
      if (score > best) {                     // slots rise: keeps the first max
        best = score;
        best_n = n;
        for (int i = 0; i < 3; ++i)
          for (int k = 0; k < 3; ++k) bHa[i * 3 + k] = Ha[i][k];
        bSi[0] = Si[0][0]; bSi[1] = Si[0][1]; bSi[2] = Si[0][2];
        bSi[3] = Si[1][1]; bSi[4] = Si[1][2]; bSi[5] = Si[2][2];
        for (int i = 0; i < 3; ++i) bnu[i] = nu[i];
      }
    }
    // warp max of the score, then the first slot that reaches it
    float gmax = best;
    for (int o = 16; o > 0; o >>= 1) gmax = fmaxf(gmax, __shfl_xor_sync(0xffffffffu, gmax, o));
    int gix = (best == gmax) ? best_n : N;
    for (int o = 16; o > 0; o >>= 1) gix = min(gix, __shfl_xor_sync(0xffffffffu, gix, o));
    const bool upd = gmax > 0.5f * kNeg;
    const int src = gix & 31;
    float Hb[3][6], Sib[3][3], nub[3];
    for (int i = 0; i < 3; ++i)
      for (int k = 0; k < 3; ++k) Hb[i][3 + k] = __shfl_sync(0xffffffffu, bHa[i * 3 + k], src);
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) Hb[i][j] = -tr.R[j][i];
    {
      float s6[6];
      for (int i = 0; i < 6; ++i) s6[i] = __shfl_sync(0xffffffffu, bSi[i], src);
      Sib[0][0] = s6[0]; Sib[0][1] = s6[1]; Sib[0][2] = s6[2];
      Sib[1][1] = s6[3]; Sib[1][2] = s6[4]; Sib[2][2] = s6[5];
      Sib[1][0] = s6[1]; Sib[2][0] = s6[2]; Sib[2][1] = s6[4];
    }
    for (int i = 0; i < 3; ++i) nub[i] = __shfl_sync(0xffffffffu, bnu[i], src);

    // K = Σ Hᵀ S⁻¹ (6×3), μ' (every lane alike)
    float HS[6][3], K[6][3], mu_new[6];
    for (int c = 0; c < 6; ++c)
      for (int bb = 0; bb < 3; ++bb) {
        float acc = 0.0f;
        for (int a = 0; a < 3; ++a) acc = acc + Hb[a][c] * Sib[a][bb];
        HS[c][bb] = acc;
      }
    for (int i = 0; i < 6; ++i)
      for (int bb = 0; bb < 3; ++bb) {
        float acc = 0.0f;
        for (int c = 0; c < 6; ++c) acc = acc + sig[i * 6 + c] * HS[c][bb];
        K[i][bb] = acc;
      }
    for (int i = 0; i < 6; ++i) {
      float acc = 0.0f;
      for (int bb = 0; bb < 3; ++bb) acc = acc + K[i][bb] * nub[bb];
      mu_new[i] = mu[i] + (upd ? acc : 0.0f);
    }
    for (int i = 3; i < 6; ++i) mu_new[i] = upd ? slam::wrap_angle(mu_new[i]) : mu_new[i];
    if (lane == 0) {
      for (int i = 0; i < 6; ++i)
        for (int bb = 0; bb < 3; ++bb) kh[i * 3 + bb] = K[i][bb];
      for (int a = 0; a < 3; ++a)
        for (int c = 0; c < 6; ++c) kh[18 + a * 6 + c] = Hb[a][c];
    }
    __syncwarp();
    // Σ' = Σ − (KH)Σ: entries l = lane and l = lane + 32 (lanes 0-3)
    float snew[2] = {0.0f, 0.0f};
    for (int r = 0; r < 2; ++r) {
      const int l = lane + 32 * r;
      if (l >= 36) break;
      const int i = l / 6, j = l % 6;
      float KH[6];
      for (int c = 0; c < 6; ++c) {
        float acc = 0.0f;
        for (int bb = 0; bb < 3; ++bb) acc = acc + kh[i * 3 + bb] * kh[18 + bb * 6 + c];
        KH[c] = acc;
      }
      float delta = 0.0f;
      for (int c = 0; c < 6; ++c) delta = delta + KH[c] * sg[c * 6 + j];
      snew[r] = sg[l] - (upd ? delta : 0.0f);
    }
    __syncwarp();
    sg[lane] = snew[0];
    if (lane < 4) sg[lane + 32] = snew[1];
    if (lane == 0) {
      for (int i = 0; i < 6; ++i) ms[i] = mu_new[i];
      match_out[(size_t)b * M + m] = upd ? gix : -1;
    }
    __syncwarp();
  }

  // ---- 3. no-input rebroadcast: the whole tick is discarded -----------------
  if (lane < 6) {
    mu_out[(size_t)b * 6 + lane] = have ? ms[lane] : mu_in[(size_t)b * 6 + lane];
    if (sigd_out)
      sigd_out[(size_t)b * 6 + lane] = have ? sg[lane * 7] : sig_in[(size_t)b * 36 + lane * 7];
  }
  for (int l = lane; l < 36; l += 32)
    sig_out[(size_t)b * 36 + l] = have ? sg[l] : sig_in[(size_t)b * 36 + l];
}

}  // namespace

extern "C" int loc_tick_launch(int device, void* stream, int B, int N, int M,
                               const void* mu_in, const void* sig_in, const void* tick,
                               const void* z, const void* map4, const void* par,
                               void* mu_out, void* sig_out, void* match_out,
                               void* sigd_out) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (B < 1 || M < 1 || N < 1 || N > 2048) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)N * sizeof(float4);
  const int blocks = (B + kWarps - 1) / kWarps;
  loc_tick_kernel<<<blocks, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      B, N, M, (const float*)mu_in, (const float*)sig_in, (const float*)tick,
      (const float*)z, (const float4*)map4, (const float*)par, (float*)mu_out,
      (float*)sig_out, (int*)match_out, (float*)sigd_out);
  return (int)cudaGetLastError();
}
