// K9: the whole EKF-localization fleet tick.
//
// Replaces the TPU kernel smarc_navigation_tpu/ops/loc_kernels.py::fleet_tick
// (pallas_call at :326, body _make_tick_kernel; the reference's
// models/ekf_localization.py::run_fleet launches the same body at :357).
// Contract: this package's ops/loc_kernels.fleet_tick_reference, which
// transcribes the TPU kernel's body in its operation order; each output
// entry here keeps that order (compiled with -fmad=false, so every product
// is rounded as the plain version rounds it).
//
// One block of kThreads (2 warps) per mission, its map (N × [x y z mask])
// and detections (M × [z valid]) in shared memory, read in one load phase.
// Per mission:
//   1. the absolute-attitude predict, once: warp 0 forms μ and the nine
//      pose-block entries of Σ, one per lane (lane i < 3 takes sin and cos
//      of rpy[i]), while warp 1 lists the valid detections, writes match −1
//      for the others, and forms the first round's R(μ), ∂R and the
//      pre-gate's tangent (lanes 0-3 take the sines, cosines and tangent);
//   2. for each valid detection in order (the invalid ones are skipped: see
//      below), each thread
//      takes the slots n ≡ tid (mod kThreads) (one slot at N = 64) and
//      computes diff, ẑ, H, W = HΣ, the symmetric S, its cofactor inverse
//      (det clamped at 1e-30), ν, d, −½(d + log det) and the gates; a warp
//      reduction takes the largest score (as an order-preserving integer
//      key) and then the smallest slot reaching it, and one shared-memory
//      round does the same across the two warps (jnp.argmax's rule); the
//      winning thread leaves its H angle block, S⁻¹ and ν in shared memory;
//      when a slot was associated, threads 0-17 form the 18 entries of
//      K = ΣHᵀS⁻¹, then warp 0 forms the 36 entries of Σ' = Σ − (KH)Σ into
//      the other buffer while warp 1 forms μ' (one entry per lane) and,
//      when a valid detection follows, its round's R(μ'), ∂R and tangent; a
//      valid detection that associated nothing leaves Σ and gives μ' = μ + 0;
//   3. the no-input gate: a mission without IMU + DVL contact gets its input
//      μ and Σ back unchanged. When none of its detections is valid either,
//      the whole tick is skipped and the inputs are copied out; otherwise
//      the rounds still run, because the TPU kernel and the plain version
//      report the matches of such a mission (found on the predicted state).
// Skipping an invalid detection is bitwise the plain version's result (its
// round leaves Σ − 0 = Σ and μ + 0 = μ and matches −1) but for one detail:
// μ + 0 turns a −0.0 entry into +0.0. torch.equal and every check compare
// the two zeros as equal.
//
// What bounds it on the H100: latency. A tick moves ~1.7 KB per mission and
// does ~1 kFLOP per map slot and valid detection; the updates form a
// dependent chain of a block-wide argmax then the gain and Σ'. The design
// gives each mission its own block (B blocks: at B=64 on 64 of the 132
// SMs) and one slot per thread, computes every shared quantity (the
// predict, the rotation and tangent of each round, K, μ', Σ') once and
// spreads its entries and its sines and cosines over threads, overlaps the
// next round's rotation with Σ', and skips the rounds (and the ticks) whose
// result the TPU kernel throws away.

#include <cuda_runtime.h>
#include <math.h>

#include "rot_common.cuh"
#include "slam_common.cuh"

namespace {

constexpr int kThreads = 64;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN = 2048;
constexpr int kMaxM = 512;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNeg = -3.0e38f;
constexpr float kHalfPi = 1.57079632679489661923f;

// a round's rotation table: R (9), ∂R/∂rpy_k [k][i][j] (27), tan(π/2 + yaw)
constexpr int kTrig = 40;
// a warp's best slot: key, slot, H angle block (9), S⁻¹ (6: 00 01 02 11 12 22), ν (3)
constexpr int kBest = 20;
// the block's inputs in shared memory: μ (6), Σ (36), tick row (8), parameters (16)
constexpr int kInMu = 0, kInSig = 6, kInTick = 42, kInPar = 50, kIn = 66;

// float -> unsigned key with the same order (−0 and +0 made equal first)
__device__ inline unsigned order_key(float f) {
  const unsigned u = __float_as_uint(f + 0.0f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ inline float key_float(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// n floats (a multiple of 4) from 16-byte aligned shared memory into registers
template <int n>
__device__ inline void load4(const float* src, float* dst) {
  for (int q = 0; q < n / 4; ++q) {
    const float4 v = reinterpret_cast<const float4*>(src)[q];
    dst[4 * q] = v.x;
    dst[4 * q + 1] = v.y;
    dst[4 * q + 2] = v.z;
    dst[4 * q + 3] = v.w;
  }
}

// Called by all 32 lanes of a warp, lane i < 3 holding attitude angle a
// (roll, pitch, yaw): R, ∂R and tan(wrap(π/2 + yaw)) into a round's table.
// Lanes 0-2 take the sines and cosines, lane 3 the tangent.
__device__ void trig_table(float a, int lane, float* trig) {
  const float u = slam::wrap_angle(kHalfPi + __shfl_sync(kFull, a, 2));
  const float arg = lane == 3 ? u : a;
  float sc[6];
  slam::warp_sincos3(arg, sc);
  const float tpre = __shfl_sync(kFull, tanf(arg), 3);
  if (lane != 0) return;
  slam::Trig tr;
  slam::rot_entries(sc[0], sc[1], sc[2], sc[3], sc[4], sc[5], tr);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      trig[i * 3 + j] = tr.R[i][j];
      for (int k = 0; k < 3; ++k) trig[9 + k * 9 + i * 3 + j] = tr.dR[k][i][j];
    }
  trig[36] = tpre;
}

// Warp 0: the absolute-attitude predict of μ and Σ (identity position
// block, the ∂(R(rpy)·Δ)/∂rpy coupling, zero orientation rows); lane
// l < 9 forms pose-block entry (l / 3, l % 3) and its three zero partners.
__device__ void predict(int lane, const float* in, float* mu, float* sg) {
  const float* tk = in + kInTick;
  const float* sig = in + kInSig;
  const float* par = in + kInPar;
  const int i3 = lane < 3 ? lane : 2;
  const float a = tk[i3];
  float sc[6];
  slam::warp_sincos3(a, sc);
  slam::Trig tr;
  slam::rot_entries(sc[0], sc[1], sc[2], sc[3], sc[4], sc[5], tr);
  const float wa = slam::wrap_angle(a);
  float db[3], J[3][3];
  for (int i = 0; i < 3; ++i) db[i] = tk[3 + i];
  for (int i = 0; i < 3; ++i)
    for (int k = 0; k < 3; ++k) {
      float acc = 0.0f;
      for (int j = 0; j < 3; ++j) acc = acc + tr.dR[k][i][j] * db[j];
      J[i][k] = acc;
    }
  if (lane < 9) {
    const int i = lane / 3, j = lane % 3;
    float Ji[3], Jj[3];
    for (int k = 0; k < 3; ++k) {
      Ji[k] = i == 0 ? J[0][k] : (i == 1 ? J[1][k] : J[2][k]);
      Jj[k] = j == 0 ? J[0][k] : (j == 1 ? J[1][k] : J[2][k]);
    }
    float tij = 0.0f, tji = 0.0f, u[3];
    for (int k = 0; k < 3; ++k) {
      tij = tij + Ji[k] * sig[(3 + k) * 6 + j];
      tji = tji + Jj[k] * sig[(3 + k) * 6 + i];
    }
    for (int c = 0; c < 3; ++c) {
      float acc = 0.0f;
      for (int k = 0; k < 3; ++k) acc = acc + Ji[k] * sig[(3 + k) * 6 + 3 + c];
      u[c] = acc;
    }
    float ujt = 0.0f;
    for (int k = 0; k < 3; ++k) ujt = ujt + u[k] * Jj[k];
    const float s = sig[i * 6 + j];
    const float val = ((s + tij) + tji) + ujt;
    const float z = s * 0.0f;
    sg[i * 6 + j] = i == j ? val + par[3 + i] : val;
    sg[i * 6 + 3 + j] = z;
    sg[(3 + i) * 6 + j] = z;
    sg[(3 + i) * 6 + 3 + j] = i == j ? z + par[6 + i] : z;
  }
  if (lane < 3) {
    float acc = 0.0f;
    for (int j = 0; j < 3; ++j)
      acc = acc + (i3 == 0 ? tr.R[0][j] : (i3 == 1 ? tr.R[1][j] : tr.R[2][j])) * db[j];
    mu[lane] = in[kInMu + lane] + acc;
    mu[3 + lane] = wa;
  }
}

// Warp 1 after a valid detection's round: μ' (lane i < 6 forms entry i)
// and, when a valid detection follows, its round's rotation table.
__device__ void next_mu(int lane, bool upd, const float* K, const float* nub, float* mu,
                        float* trig, bool more) {
  const int i = lane < 6 ? lane : 5;
  float acc = 0.0f;
  if (upd)
    for (int bb = 0; bb < 3; ++bb) acc = acc + K[i * 3 + bb] * nub[bb];
  float mi = mu[i] + (upd ? acc : 0.0f);
  if (upd && i >= 3) mi = slam::wrap_angle(mi);
  __syncwarp();                          // every lane has read μ before it is written
  if (lane < 6) mu[lane] = mi;
  if (more) trig_table(__shfl_sync(kFull, mi, lane < 3 ? 3 + lane : 5), lane, trig);
}

__global__ void __launch_bounds__(kThreads)
loc_tick_kernel(int N, int M, const float* __restrict__ mu_in,
                const float* __restrict__ sig_in, const float* __restrict__ tick,
                const float4* __restrict__ z4, const float4* __restrict__ map4,
                const float* __restrict__ par, float* __restrict__ mu_out,
                float* __restrict__ sig_out, int* __restrict__ match_out,
                float* __restrict__ sigd_out) {
  extern __shared__ float4 s_dyn[];          // N map rows, then M detections
  float4* smap = s_dyn;
  float4* sz = s_dyn + N;
  __shared__ float s_in[kIn];
  __shared__ __align__(16) float s_mu[8];
  __shared__ __align__(16) float s_sig[2][36];
  __shared__ __align__(16) float s_trig[kTrig];
  __shared__ float s_best[kWarps][kBest];
  __shared__ float s_K[18];
  __shared__ float s_Hb[18];
  __shared__ int s_round[kMaxM];             // the valid detections, in order
  __shared__ int s_nvalid;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t b = blockIdx.x;
  const float* in_mu = s_in + kInMu;
  const float* in_sig = s_in + kInSig;
  const float* tk = s_in + kInTick;
  const float* spar = s_in + kInPar;

  // ---- 0. one load phase: the first slot, detection and inputs of each
  // thread are all loaded before the first shared store (one memory latency)
  const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float4 mp = tid < N ? map4[tid] : zero4;
  const float4 zt = tid < M ? z4[b * M + tid] : zero4;
  float vin[2];
  for (int r = 0; r < 2; ++r) {
    const int k = tid + r * kThreads;
    const float* src = k < kInSig ? mu_in + b * 6 + k
                     : k < kInTick ? sig_in + b * 36 + (k - kInSig)
                     : k < kInPar ? tick + b * 8 + (k - kInTick) : par + (k - kInPar);
    vin[r] = k < kIn ? *src : 0.0f;
  }
  if (tid < N) smap[tid] = mp;
  if (tid < M) sz[tid] = zt;
  for (int r = 0; r < 2; ++r)
    if (tid + r * kThreads < kIn) s_in[tid + r * kThreads] = vin[r];
  bool valid = tid < M && zt.w > 0.5f;
  for (int k = tid + kThreads; k < N; k += kThreads) smap[k] = map4[k];
  for (int k = tid + kThreads; k < M; k += kThreads) {
    const float4 zz = z4[b * M + k];
    sz[k] = zz;
    valid = valid || zz.w > 0.5f;
  }
  const bool any_valid = __syncthreads_or(valid);
  const bool have = tk[6] > 0.5f;

  if (!have && !any_valid) {                 // nothing of the tick is kept
    if (tid < 6) {
      mu_out[b * 6 + tid] = in_mu[tid];
      if (sigd_out) sigd_out[b * 6 + tid] = in_sig[tid * 7];
    }
    if (tid < 36) sig_out[b * 36 + tid] = in_sig[tid];
    for (int m = tid; m < M; m += kThreads) match_out[b * M + m] = -1;
    return;
  }

  // ---- 1. predict (warp 0); valid detections, first rotation table (warp 1) --
  if (warp == 0) {
    predict(lane, s_in, s_mu, s_sig[0]);
  } else if (warp == 1) {
    int n = 0;
    for (int c = 0; c < M; c += 32) {
      const int m = c + lane;
      const bool v = m < M && sz[m].w > 0.5f;
      const unsigned bal = __ballot_sync(kFull, v);
      if (v) s_round[n + __popc(bal & ((1u << lane) - 1u))] = m;
      else if (m < M) match_out[b * M + m] = -1;
      n += __popc(bal);
    }
    if (lane == 0) s_nvalid = n;
    if (n > 0) trig_table(slam::wrap_angle(tk[lane < 3 ? lane : 2]), lane, s_trig);
  }
  __syncthreads();
  const float qd[3] = {spar[0], spar[1], spar[2]};
  const float lam = spar[9], eps = spar[10];

  // ---- 2. the sequential greedy-ML updates of the valid detections ----------
  int cur = 0;
  const int nvalid = s_nvalid;
  for (int r = 0; r < nvalid; ++r) {
    const int m = s_round[r];
    const float4 zm = sz[m];
    const float* sg = s_sig[cur];
    {
      // μ, Σ and the rotation table by 16-byte shared loads
      float mu[8], sig[36], tt[kTrig], R[3][3], dR[3][3][3];
      load4<8>(s_mu, mu);
      load4<36>(sg, sig);
      load4<kTrig>(s_trig, tt);
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) {
          R[i][j] = tt[i * 3 + j];
          for (int k = 0; k < 3; ++k) dR[k][i][j] = tt[9 + k * 9 + i * 3 + j];
        }
      const float tpre = tt[36];

      // this thread's best slot: score, index, H angle block, S⁻¹ (6), ν
      float best = -INFINITY;
      int best_n = N;
      float bHa[9], bSi[6], bnu[3];
      for (int i = 0; i < 9; ++i) bHa[i] = 0.0f;
      for (int i = 0; i < 6; ++i) bSi[i] = 0.0f;
      for (int i = 0; i < 3; ++i) bnu[i] = 0.0f;
      for (int n = tid; n < N; n += kThreads) {
        const float4 lm = smap[n];
        const float diff[3] = {lm.x - mu[0], lm.y - mu[1], lm.z - mu[2]};
        float zh[3], Ha[3][3], Hp[3][3];
        for (int i = 0; i < 3; ++i) {
          float acc = 0.0f;
          for (int j = 0; j < 3; ++j) acc = acc + R[j][i] * diff[j];
          zh[i] = acc;
          for (int k = 0; k < 3; ++k) {
            float a = 0.0f;
            for (int j = 0; j < 3; ++j) a = a + dR[k][j][i] * diff[j];
            Ha[i][k] = a;
          }
          for (int j = 0; j < 3; ++j) Hp[i][j] = -R[j][i];
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
        const float nu[3] = {zm.x - zh[0], zm.y - zh[1], zm.z - zh[2]};
        float dm = 0.0f;
        for (int a = 0; a < 3; ++a)
          for (int bb = 0; bb < 3; ++bb) dm = dm + nu[a] * Si[a][bb] * nu[bb];
        const float logpsi = -0.5f * (dm + logf(det));
        const bool pregate = eps > fabsf((lm.x - mu[0]) + (mu[1] - lm.y) / tpre);
        const bool ok = (lm.w > 0.5f) && pregate && (dm < lam);
        const float score = ok ? logpsi : kNeg;
        if (score > best) {                   // slots rise: keeps the first max
          best = score;
          best_n = n;
          for (int i = 0; i < 3; ++i)
            for (int k = 0; k < 3; ++k) bHa[i * 3 + k] = Ha[i][k];
          bSi[0] = Si[0][0]; bSi[1] = Si[0][1]; bSi[2] = Si[0][2];
          bSi[3] = Si[1][1]; bSi[4] = Si[1][2]; bSi[5] = Si[2][2];
          for (int i = 0; i < 3; ++i) bnu[i] = nu[i];
        }
      }
      // the warp's largest score, then the first slot that reaches it
      const unsigned key = order_key(best);
      const unsigned wkey = __reduce_max_sync(kFull, key);
      const unsigned wix = __reduce_min_sync(kFull, key == wkey ? (unsigned)best_n : (unsigned)N);
      float* wb = s_best[warp];
      if (lane == 0) {
        wb[0] = __uint_as_float(wkey);
        wb[1] = __int_as_float((int)wix);
      }
      if ((unsigned)best_n == wix && best_n < N) {
        for (int i = 0; i < 9; ++i) wb[2 + i] = bHa[i];
        for (int i = 0; i < 6; ++i) wb[11 + i] = bSi[i];
        for (int i = 0; i < 3; ++i) wb[17 + i] = bnu[i];
      }
    }
    __syncthreads();

    // the block's largest score and first slot over the warps' (uniform)
    unsigned gkey = 0u;
    for (int w = 0; w < kWarps; ++w) gkey = max(gkey, __float_as_uint(s_best[w][0]));
    int gix = N, src = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int ix = __float_as_int(s_best[w][1]);
      if (__float_as_uint(s_best[w][0]) == gkey && ix < gix) {
        gix = ix;
        src = w;
      }
    }
    const bool upd = key_float(gkey) > 0.5f * kNeg;
    const bool more = r + 1 < nvalid;
    const float* wb = s_best[src];
    if (tid == 0) match_out[b * M + m] = upd ? gix : -1;
    if (upd) {
      if (tid < 18) {
        // Hb (3×6) = [−Rᵀ | H angle block]; K[i][bb] = Σ_c Σ[i][c] HS[c][bb]
        float Hb[3][6], Sib[3][3];
        for (int a = 0; a < 3; ++a)
          for (int k = 0; k < 3; ++k) {
            Hb[a][k] = -s_trig[k * 3 + a];
            Hb[a][3 + k] = wb[2 + a * 3 + k];
          }
        Sib[0][0] = wb[11]; Sib[0][1] = wb[12]; Sib[0][2] = wb[13];
        Sib[1][1] = wb[14]; Sib[1][2] = wb[15]; Sib[2][2] = wb[16];
        Sib[1][0] = wb[12]; Sib[2][0] = wb[13]; Sib[2][1] = wb[15];
        const int i = tid / 3, bb = tid % 3;
        float HS[6];
        for (int c = 0; c < 6; ++c) {
          float acc = 0.0f;
          for (int a = 0; a < 3; ++a) acc = acc + Hb[a][c] * Sib[a][bb];
          HS[c] = acc;
        }
        float acc = 0.0f;
        for (int c = 0; c < 6; ++c) acc = acc + sg[i * 6 + c] * HS[c];
        s_K[tid] = acc;
        const int a = tid / 6, c = tid % 6;
        s_Hb[tid] = c < 3 ? -s_trig[c * 3 + a] : wb[2 + a * 3 + (c - 3)];
      }
      __syncthreads();
      if (warp == 0) {
        // Σ' = Σ − (KH)Σ: entries l = lane and l = lane + 32 (lanes 0-3)
        float* sn = s_sig[cur ^ 1];
        for (int l = lane; l < 36; l += 32) {
          const int i = l / 6, j = l % 6;
          float KH[6];
          for (int c = 0; c < 6; ++c) {
            float acc = 0.0f;
            for (int bb = 0; bb < 3; ++bb) acc = acc + s_K[i * 3 + bb] * s_Hb[bb * 6 + c];
            KH[c] = acc;
          }
          float delta = 0.0f;
          for (int c = 0; c < 6; ++c) delta = delta + KH[c] * sg[c * 6 + j];
          sn[l] = sg[l] - delta;
        }
      } else if (warp == 1) {
        next_mu(lane, true, s_K, wb + 17, s_mu, s_trig, more);
      }
      cur ^= 1;
    } else if (warp == 1) {                  // nothing associated: μ + 0, Σ kept
      next_mu(lane, false, s_K, wb + 17, s_mu, s_trig, more);
    }
    __syncthreads();
  }

  // ---- 3. no-input gate: the whole tick is discarded -------------------------
  const float* mo = have ? s_mu : in_mu;
  const float* so = have ? s_sig[cur] : in_sig;
  if (tid < 6) {
    mu_out[b * 6 + tid] = mo[tid];
    if (sigd_out) sigd_out[b * 6 + tid] = so[tid * 7];
  }
  if (tid < 36) sig_out[b * 36 + tid] = so[tid];
}

}  // namespace

extern "C" int loc_tick_launch(int device, void* stream, int B, int N, int M,
                               const void* mu_in, const void* sig_in, const void* tick,
                               const void* z, const void* map4, const void* par,
                               void* mu_out, void* sig_out, void* match_out,
                               void* sigd_out) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (B < 1 || M < 1 || M > kMaxM || N < 1 || N > kMaxN) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(N + M) * sizeof(float4);
  loc_tick_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      N, M, (const float*)mu_in, (const float*)sig_in, (const float*)tick, (const float4*)z,
      (const float4*)map4, (const float*)par, (float*)mu_out, (float*)sig_out,
      (int*)match_out, (float*)sigd_out);
  return (int)cudaGetLastError();
}
