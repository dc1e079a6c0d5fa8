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
// Per mission, in order:
//   1. with a8, the motion predict of the pose rows: columns ≥ 6 become
//      A·P[:, c], the 6×6 block (A Σ66) Aᵀ + R̃ (an identity a8 with zero R̃
//      leaves P bit for bit);
//   2. the M updates in measurement order, each on the 9×9 marginal:
//      Σ9 from the P columns {0:6, lm:lm+3}, its landmark rows' pose block
//      read as the transpose of the pose-row cross block (the reference
//      kernel's documented ulp-level divergence from the dense path), the
//      landmark block from the band slot (diag(new_lm_cov) for an add);
//      Kᵀ = S⁻¹H·Σ9, V = H·Σ9, Σ9' = Σ9 − (Kᵀ)ᵀV; P's nine columns and the
//      band slot are SET from Σ9'; μ's nine entries gain νᵀKᵀ (+ cand on an
//      add) and the attitude is wrapped after every update.
// An applied update whose lm_ix is not a landmark offset (6 + 3·slot,
// slot < L) is skipped.
//
// What bounds it on the H100: latency. At L=256, B=32 it moves ~3.4 MB
// (about 1 µs at 3.35 TB/s) and does ~20 kFLOP per mission, but the M
// updates are a chain of dependent 9×9-sized steps. The chain touches only
// the pose block, the 3 columns, band slot and 3 μ entries of each applied
// update; everything else of the state is the predict A·P[:, c] or a copy.
// So the grid is (1 + tiles, B):
//   - block x = 0 of mission b holds the chain. All its threads stage every
//     update's operands (H_sel, S⁻¹H, ν, cand), the pose block, A and R̃ with
//     cp.async in one round trip, beside the update flags; then, dependent
//     on lm_ix, the touched columns (loaded and predicted by the thread that
//     loads them), band slots and μ entries in a second, while threads
//     32-67 predict the pose block and warp 0 lists the applied updates in
//     order. No device load is left inside the M-update loop: three warps
//     run it, each update two steps of one entry per thread, separated by a
//     named barrier. Warp 0 writes the pose block, μ[0:6] and the touched
//     entries;
//   - blocks x ≥ 1 share the rest over all SMs: one thread per column of
//     P (rows 0:6 predicted or copied, rows 6:8 copied, μ copied) and one
//     per (8-row group, slot) of the band, each skipping what the chain
//     writes (its mission's applied slots, read from do/lm_ix), so that no
//     element is written by two blocks. Rows 6:8 are copied at every column.
// A touched column's predict is the same fmaf chain in the chain block as a
// column's in a bulk block, and every product is an explicit fmaf in the
// order of the single-block kernel this design replaced (built with FMA
// contraction on), so the results are that kernel's bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "slam_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ inline void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ inline void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// The band rows a*8 + d of a slot that the chain reads: the 3×3 landmark
// block's upper triangle, (a, b ≥ a) at row a*8 + b − a; the other 18 rows
// (d > 2 − a) are SET to row (a, 2) by every update, so the chain keeps the
// six and writes the copies out at the end.
__device__ inline int tri(int a, int b) {  // (min, max) -> 0..5
  const int lo = a < b ? a : b, hi = a < b ? b : a;
  return lo == 0 ? hi : (lo == 1 ? 2 + hi : 5);
}
__device__ inline int tri_row(int t) {  // 0..5 -> band row
  return t < 3 ? t : (t < 5 ? 8 + t - 3 : 16);
}

// the chain block's shared layout (floats, then ints)
struct Chain {
  float* A;     // 36: A (6×6, row-major)
  float* Rt;    // 36: R̃
  float* PP;    // 36: the pose block as staged
  float* PPn;   // 36: the pose block, predicted (with a8)
  float* mu6;   // 6
  float* nl;    // 3
  float* kv;    // 54: Kᵀ rows at 0, V rows at 27
  float* Hs;    // M·dim·9, as in H_sel
  float* Ss;    // M·dim·9, as in S⁻¹H
  float* nus;   // M·dim
  float* cands; // M·3
  float* W;     // M·18: P[0:6, lm:lm+3] (predicted with a8), [i*3 + c]
  float* BS;    // M·6: the band slot's six entries (tri)
  float* muL;   // M·3
  int* lm;      // M: applied update's lm_ix, else -1
  int* alias;   // M: first applied update on the same landmark
  int* ad;      // M: add flag
  int* seq;     // M + 1: the applied updates in order, j | alias << 10 | add << 20; count at M
};

__host__ __device__ inline size_t chain_floats(int M, int dim) {
  return 36 * 4 + 6 + 3 + 54 + (size_t)M * (2 * dim * 9 + dim + 3 + 18 + 6 + 3);
}

__host__ __device__ inline size_t shared_bytes(int M, int L, int dim) {
  const size_t chain = (chain_floats(M, dim) + 4 * (size_t)M + 1) * 4;
  const size_t bulk = (36 + (size_t)(L + 31) / 32) * 4;
  return chain > bulk ? chain : bulk;
}

__device__ inline Chain carve(float* f, int M, int dim) {
  Chain c;
  c.A = f; f += 36;
  c.Rt = f; f += 36;
  c.PP = f; f += 36;
  c.PPn = f; f += 36;
  c.mu6 = f; f += 6;
  c.nl = f; f += 3;
  c.kv = f; f += 54;
  c.Hs = f; f += M * dim * 9;
  c.Ss = f; f += M * dim * 9;
  c.nus = f; f += M * dim;
  c.cands = f; f += M * 3;
  c.W = f; f += M * 18;
  c.BS = f; f += M * 6;
  c.muL = f; f += M * 3;
  int* i = reinterpret_cast<int*>(f);
  c.lm = i; i += M;
  c.alias = i; i += M;
  c.ad = i; i += M;
  c.seq = i;
  return c;
}

__device__ inline bool landmark_offset(int lm, int D) {
  return lm >= 6 && lm + 2 < D && (lm - 6) % 3 == 0;
}

// slam::wrap_angle's value bit for bit, its fmodf(x, 2π) taken exactly
// without the library loop where |x| < 4π: x − 2π on [2π, 4π), x + 2π on
// (−4π, −2π] (both exact: Sterbenz), x between.
__device__ inline float wrap_angle_near(float a) {
  const float two_pi = 2.0f * slam::kPi;
  const float x = a + slam::kPi;
  float r = x >= two_pi ? x - two_pi : (x <= -two_pi ? x + two_pi : x);
  if (!(x > -2.0f * two_pi && x < 2.0f * two_pi)) r = fmodf(x, two_pi);
  if (r != 0.0f && r < 0.0f) r += two_pi;
  return r - slam::kPi;
}

constexpr int kChain = 96;  // threads of the update chain: named barrier 1

__device__ inline void chain_sync() { asm volatile("bar.sync 1, 96;\n" ::: "memory"); }

// The M updates in order on threads 0-95 of block x = 0, each update two
// steps separated by a named barrier, one entry per thread per step:
//   - Kᵀ = S⁻¹H Σ9 and V = H Σ9 (2·dim·9 entries): Σ9's column c read straight
//     from the pose block, the update's columns (its landmark rows' pose
//     block the transpose of the pose-row cross block) and its band slot
//     (diag(new_lm_cov) on an add);
//   - Σ9' = Σ9 − (Kᵀ)ᵀ V SET into P's nine columns (54) and the band slot's six
//     entries, μ += νᵀKᵀ (+ cand on an add) with the attitude wrapped (9);
//     each entry reads and writes only its own location.
// Every thread loads valid addresses; only the entries that exist store.
template <int DIM>
__device__ void update_chain(const Chain& s, float* W, float* PP, int M, int tid) {
  constexpr int NOP = DIM * 9;
  // Kᵀ/V entry tid (< 2·NOP): which (S⁻¹H 0, H 1), d, c
  const bool has_kv = tid < 2 * NOP;
  const int kt = has_kv ? tid : 0;
  const int kwhich = kt / NOP, kd = (kt % NOP) / 9, kc = kt % 9;
  const bool klo = kc < 6;
  int kboff[3];
#pragma unroll
  for (int q = 0; q < 3; ++q) kboff[q] = klo ? 0 : tri(q, kc - 6);
  const float* gbase = (kwhich ? s.Hs : s.Ss) + kd * 9;
  float* kvdst = s.kv + kwhich * 27 + kd * 9 + kc;
  // Σ9' entry tid (< 60): 54 of P's rows (r, c), 6 of the band slot; μ entry
  // tid − 60 (< 9); cls: 0 the pose block, 1 the update's columns, 2 its slot
  const bool has_se = tid < 60, has_mu = tid >= 60 && tid < 69;
  int sr, sc;
  if (tid < 54) {
    sr = tid / 9;
    sc = tid % 9;
  } else {
    const int q = tid < 60 ? tid - 54 : 5, a_ = q < 3 ? 0 : (q < 5 ? 1 : 2);
    sr = 6 + a_;
    sc = 6 + (q < 3 ? q : (q < 5 ? q - 2 : 2));
  }
  const int scls = sr >= 6 ? 2 : (sc >= 6 ? 1 : 0);
  const int soff = sr >= 6 ? tri(sr - 6, sc - 6) : (sc >= 6 ? sr * 3 + sc - 6 : sr * 6 + sc);
  const int mc = has_mu ? tid - 60 : 0;
  const float nl0 = s.nl[0], nl1 = s.nl[1], nl2 = s.nl[2];
  const int n = s.seq[M];
  int next = n > 0 ? s.seq[0] : 0;
  float g[9];  // this thread's row of S⁻¹H or H, loaded one update ahead
#pragma unroll
  for (int r = 0; r < 9; ++r) g[r] = gbase[(next & 0x3ff) * NOP + r];
  for (int k = 0; k < n; ++k) {
    const int cur = next;
    if (k + 1 < n) next = s.seq[k + 1];
    const int j = cur & 0x3ff, w = (cur >> 10) & 0x3ff;
    const bool ad = (cur >> 20) != 0;
    float* Wj = W + w * 18;
    float* Bj = s.BS + w * 6;
    {  // Kᵀ / V
      const float* Wc = Wj + (klo ? kc * 3 : kc - 6);
      float col[9];
#pragma unroll
      for (int r = 0; r < 6; ++r) col[r] = klo ? PP[r * 6 + kc] : Wc[r * 3];
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const float xw = Wc[q], xb = Bj[kboff[q]];
        const float nq = q == 0 ? nl0 : (q == 1 ? nl1 : nl2);
        col[6 + q] = klo ? xw : (ad ? (q == kc - 6 ? nq : 0.0f) : xb);
      }
      float acc = 0.0f;
#pragma unroll
      for (int r = 0; r < 9; ++r) acc = fmaf(g[r], col[r], acc);
      if (has_kv) *kvdst = acc;
    }
    chain_sync();
#pragma unroll
    for (int r = 0; r < 9; ++r) g[r] = gbase[(next & 0x3ff) * NOP + r];  // the next update's
    {  // Σ9' and μ
      float* dst = (scls == 0 ? PP : (scls == 1 ? Wj : Bj)) + soff;
      const float x = *dst;
      const float nr = sr == 6 ? nl0 : (sr == 7 ? nl1 : nl2);
      const float old = scls == 2 && ad ? (sr == sc ? nr : 0.0f) : x;
      float acc = 0.0f;
#pragma unroll
      for (int d = 0; d < DIM; ++d) acc = fmaf(s.kv[d * 9 + sr], s.kv[27 + d * 9 + sc], acc);
      float* mdst = mc < 6 ? s.mu6 + mc : s.muL + w * 3 + mc - 6;
      const float mold = *mdst;
      const float mcand = s.cands[j * 3 + (mc >= 6 ? mc - 6 : 0)];
      float dmu = 0.0f;
#pragma unroll
      for (int d = 0; d < DIM; ++d) dmu = fmaf(s.nus[j * DIM + d], s.kv[d * 9 + mc], dmu);
      if (mc >= 6 && ad) dmu += mcand;
      float m = mold + dmu;
      if (mc >= 3 && mc < 6) m = wrap_angle_near(m);
      if (has_se) *dst = old - acc;
      if (has_mu) *mdst = m;
    }
    chain_sync();
  }
}

// Mission b's update chain in block x = 0: all its threads stage the
// operands (two dependent round trips) and predict the touched pose rows,
// then warp 0 alone runs the M updates and writes out what the chain owns.
__device__ void chain_block(int b, int D, int L, int M, int dim, const float* P_in,
                            const float* mu_in, const float* H_sel, const float* SinvH,
                            const float* nu, const int* lm_ix, const bool* do_,
                            const bool* add, const float* new_lm_cov, const float* cand,
                            const float* band_in, const float* a8, float* P_out,
                            float* mu_out, float* band_out, float* smem) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31;
  Chain s = carve(smem, M, dim);
  const float* Pb = P_in + (size_t)b * 8 * D;
  const size_t ob = (size_t)b * M;
  const int nop = dim * 9;

  // --- round trip 1: the flags first, then every update's operands, the pose
  // block, A, R̃ ------------------------------------------------------------------
  for (int j = tid; j < M; j += nt) {
    const int l = lm_ix[ob + j];
    s.lm[j] = do_[ob + j] && landmark_offset(l, D) ? l : -1;
    s.ad[j] = add[ob + j] ? 1 : 0;
  }
  for (int k = tid; k < M * nop; k += nt) {
    cp_async4(&s.Hs[k], H_sel + ob * nop + k);
    cp_async4(&s.Ss[k], SinvH + ob * nop + k);
  }
  for (int k = tid; k < M * dim; k += nt) cp_async4(&s.nus[k], nu + ob * dim + k);
  for (int k = tid; k < M * 3; k += nt) cp_async4(&s.cands[k], cand + ob * 3 + k);
  for (int k = tid; k < 36; k += nt) {
    cp_async4(&s.PP[k], Pb + (k / 6) * D + k % 6);
    if (a8) {
      const float* a = a8 + (size_t)b * 128 + (k / 6) * 16 + k % 6;
      cp_async4(&s.A[k], a);
      cp_async4(&s.Rt[k], a + 8);
    }
  }
  if (tid < 6) cp_async4(&s.mu6[tid], mu_in + (size_t)b * D + tid);
  if (tid < 3) cp_async4(&s.nl[tid], new_lm_cov + tid);
  cp_async_wait_all();
  __syncthreads();

  // --- round trip 2, dependent on lm_ix: each applied update's columns, loaded
  // into registers and predicted (A·P[:, c], the same fmaf chain as a bulk
  // block's) by threads 96.., its band slot and μ entries by cp.async;
  // meanwhile threads 32-67 predict the pose block, warp 0 orders the
  // applied updates -----------------------------------------------------------
  float* PP = a8 ? s.PPn : s.PP;
  if (tid >= kChain) {
    for (int t = tid - kChain; t < M * 12; t += nt - kChain) {
      if (t < M * 3) {  // column c of update j: P[0:6, lm + c]
        const int j = t / 3, c = t % 3, lm = s.lm[j];
        if (lm < 0) continue;
        float x[6];
        for (int k = 0; k < 6; ++k) x[k] = Pb[k * D + lm + c];
        for (int i = 0; i < 6; ++i) {
          float v = x[i];
          if (a8) {
            v = 0.0f;
            for (int k = 0; k < 6; ++k) v = fmaf(s.A[i * 6 + k], x[k], v);
          }
          s.W[j * 18 + i * 3 + c] = v;
        }
      } else {  // band slot entry or μ entry q of update j
        const int j = (t - M * 3) / 9, q = (t - M * 3) % 9, lm = s.lm[j];
        if (lm < 0) continue;
        if (q < 6)
          cp_async4(&s.BS[j * 6 + q], band_in + ((size_t)b * 24 + tri_row(q)) * L + (lm - 6) / 3);
        else
          cp_async4(&s.muL[j * 3 + q - 6], mu_in + (size_t)b * D + lm + q - 6);
      }
    }
  } else if (tid >= 32 && tid < 68) {
    if (a8) {  // (A Σ66) Aᵀ + R̃ at (i, c)
      const int i = (tid - 32) / 6, c = (tid - 32) % 6;
      float t6[6];
      for (int l = 0; l < 6; ++l) {
        float acc = 0.0f;
        for (int k = 0; k < 6; ++k) acc = fmaf(s.A[i * 6 + k], s.PP[k * 6 + l], acc);
        t6[l] = acc;
      }
      float acc = 0.0f;
      for (int l = 0; l < 6; ++l) acc = fmaf(t6[l], s.A[c * 6 + l], acc);
      s.PPn[i * 6 + c] = acc + s.Rt[i * 6 + c];
    }
  } else if (tid < 32) {  // alias: the first applied update on the same landmark
    int n = 0;            // applied updates in earlier chunks
    for (int j0 = 0; j0 < M; j0 += 32) {
      const int j = j0 + lane;
      const int lm = j < M ? s.lm[j] : -1;
      const unsigned same = __match_any_sync(kFull, lm >= 0 ? lm : -1 - j);
      int a = j0 + __ffs(same) - 1;
      if (lm >= 0)
        for (int q = 0; q < j0; ++q)
          if (s.lm[q] == lm) {
            a = q;
            break;
          }
      if (j < M) s.alias[j] = a;
      const unsigned app = __ballot_sync(kFull, lm >= 0);
      if (lm >= 0) s.seq[n + __popc(app & ((1u << lane) - 1u))] = j | a << 10 | s.ad[j] << 20;
      n += __popc(app);
    }
    if (lane == 0) s.seq[M] = n;
  }
  cp_async_wait_all();
  __syncthreads();

  // --- 2. the M updates on three warps, an entry per thread per step ---------
  if (tid >= kChain) return;
  if (dim == 3)
    update_chain<3>(s, s.W, PP, M, tid);
  else
    update_chain<2>(s, s.W, PP, M, tid);
  if (tid >= 32) return;

  // --- write out what the chain owns -----------------------------------------
  float* Po = P_out + (size_t)b * 8 * D;
  for (int k = lane; k < 36; k += 32) Po[(k / 6) * D + k % 6] = PP[k];
  if (lane < 6) mu_out[(size_t)b * D + lane] = s.mu6[lane];
  for (int j = lane; j < M; j += 32) {
    const int lm = s.lm[j];
    if (lm < 0 || s.alias[j] != j) continue;
    for (int q = 0; q < 18; ++q) Po[(q / 3) * D + lm + q % 3] = s.W[j * 18 + q];
    for (int row = 0; row < 24; ++row) {  // row a*8+d <- (a, min(a + d, 2))
      const int a_ = row / 8, d_ = row % 8;
      band_out[((size_t)b * 24 + row) * L + (lm - 6) / 3] =
          s.BS[j * 6 + tri(a_, a_ + d_ < 2 ? a_ + d_ : 2)];
    }
    for (int q = 0; q < 3; ++q) mu_out[(size_t)b * D + lm + q] = s.muL[j * 3 + q];
  }
}

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
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  if (blockIdx.x == 0) {
    chain_block(b, D, L, M, dim, P_in, mu_in, H_sel, SinvH, nu, lm_ix, do_, add,
                new_lm_cov, cand, band_in, a8, P_out, mu_out, band_out, smem);
    return;
  }

  // --- the rest of mission b: predict or copy, skipping what the chain owns ----
  float* A = smem;                                  // 36
  unsigned* mask = reinterpret_cast<unsigned*>(smem + 36);  // touched slots
  const int item = (blockIdx.x - 1) * blockDim.x + tid;
  const float* Pb = P_in + (size_t)b * 8 * D;
  float* Po = P_out + (size_t)b * 8 * D;
  const bool is_col = item < D;
  const bool is_band = !is_col && item < D + 3 * L;
  float x[8];
  float m = 0.0f;
  int g = 0, l = 0;
  if (is_col) {  // issued before the barrier: in flight while the mask is built
    for (int i = 0; i < 8; ++i) x[i] = Pb[i * D + item];
    m = mu_in[(size_t)b * D + item];
  } else if (is_band) {
    g = (item - D) / L;
    l = (item - D) % L;
    for (int q = 0; q < 8; ++q) x[q] = band_in[((size_t)b * 24 + g * 8 + q) * L + l];
  }
  if (a8 && tid < 36) A[tid] = a8[(size_t)b * 128 + (tid / 6) * 16 + tid % 6];
  for (int w = tid; w < (L + 31) / 32; w += blockDim.x) {
    unsigned bits = 0u;
    for (int j = 0; j < M; ++j) {
      const int lm = lm_ix[(size_t)b * M + j];
      if (!do_[(size_t)b * M + j] || !landmark_offset(lm, D)) continue;
      const int slot = (lm - 6) / 3;
      if (slot >> 5 == w) bits |= 1u << (slot & 31);
    }
    mask[w] = bits;
  }
  __syncthreads();
  if (is_col) {
    Po[6 * D + item] = x[6];
    Po[7 * D + item] = x[7];
    if (item < 6) return;  // the pose block and μ[0:6] are the chain's
    const int slot = (item - 6) / 3;
    if ((mask[slot >> 5] >> (slot & 31)) & 1u) return;
    for (int i = 0; i < 6; ++i) {
      float v = x[i];
      if (a8) {
        v = 0.0f;
        for (int k = 0; k < 6; ++k) v = fmaf(A[i * 6 + k], x[k], v);
      }
      Po[i * D + item] = v;
    }
    mu_out[(size_t)b * D + item] = m;
  } else if (is_band) {
    if ((mask[l >> 5] >> (l & 31)) & 1u) return;
    for (int q = 0; q < 8; ++q) band_out[((size_t)b * 24 + g * 8 + q) * L + l] = x[q];
  }
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
  if (B < 1 || B > 65535 || L < 1 || D != 6 + 3 * L || M < 1 || M > 1023 ||
      (dim != 2 && dim != 3))
    return (int)cudaErrorInvalidValue;
  const size_t smem = shared_bytes(M, L, dim);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(marginal_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(1 + (D + 3 * L + kThreads - 1) / kThreads, B);
  marginal_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      D, L, M, dim, (const float*)P_in, (const float*)mu_in, (const float*)H_sel,
      (const float*)SinvH, (const float*)nu, (const int*)lm_ix, (const bool*)do_,
      (const bool*)add, (const float*)new_lm_cov, (const float*)cand,
      (const float*)band_in, (const float*)a8, (float*)P_out, (float*)mu_out,
      (float*)band_out);
  return (int)cudaGetLastError();
}
