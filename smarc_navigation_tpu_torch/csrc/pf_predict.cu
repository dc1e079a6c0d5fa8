// K5 / K6: the fused particle-filter predict with per-tick pose moments.
//
// Replaces the TPU kernels smarc_navigation_tpu/ops/pf_kernels.py::
// predict_call_multi (K5, pallas_call at :820, body _make_kernel_multi) and
// ::predict_call (K6, pallas_call at :865, body _kernel). Contract: this
// package's ops/pf_kernels.predict_call_multi_reference — per real tick t
// (nticks of the K parameter rows): yaw += wz·dt [+ noise], wrapped;
// x/y += R(roll, pitch, yaw)·v·dt [+ noise]; z/roll/pitch substituted from
// odometry once any odometry has arrived; the 8 moment sums of the new bank
// (x, y, x², y², xy, sin yaw, cos yaw, count) per block of 1024 particles.
// Rows of ticks [nticks, K) are written as zeros. The generator's particle
// index is idx_off + j: a particle shard passes its first global index
// (the reference offsets each shard's seeds by its global chunk index,
// particle_filter.py:527-535, 552-560), so a sharded bank draws the
// unsharded bank's noise column for column.
//
// The 256-thread blocks walk the 1024-particle groups (a persistent grid up
// to two ticks, else a block per group; see launch_one); a block's thread
// takes particles k·256 + tid (k < 4) of its group, so loads, stores and the
// per-tick moment reduction keep the layout and order of the one-block-per-
// group kernel before it, and the (K, 8, groups) partials their order. While
// a group steps through its ticks in registers, the block's next group's six
// rows are already on their way into the block's shared-memory stage, free
// again once the rows sit in registers (cp.async, 16-byte copies where n and
// the bank's alignment allow, else 4-byte); stores go out from registers and
// drain while the next group computes. The K parameter rows, the per-tick
// roll/pitch cos/sin and the per-tick generator keys sit in shared memory,
// computed while the first group's copy is in flight; each tick's constants
// are read once per tick. Per tick each block reduces its moment sums with
// warp shuffles into the partials buffer (no float atomics: a run reproduces
// itself bit for bit). The template flags <NXY, NYAW> compile the zero-std
// noise rows out, as the TPU kernel's trace-time flags do. K6 is the same
// kernel instantiated for K = 1 (KFIX), so the per-tick and the multi-tick
// paths share one op order and give bitwise equal banks. The yaw wrap takes
// an exact conditional ±2π (Sterbenz) wherever |yaw + π| < 4π, bitwise
// fmodf's floored modulo, and fmodf itself only past that. The Box-Muller
// log and sin/cos (pf_rng.cuh) and the yaw's sin/cos run on the
// special-function unit (~2^-21 absolute), which took the tick loop from
// ~8.8 to ~6.7 µs per tick of 2^20 particles. Built with -fmad=false: every
// product rounds, as in the plain version's elementwise ops.
//
// What bounds it on the H100: at the main path's 10 ticks the instructions of
// the tick loop, not the bytes. A call moves 48 MiB at N = 2^20 (the bank
// read and written once), ~15 µs at 3.35 TB/s, whatever the tick count; per
// tick each particle whose yaw noise is on draws two uniforms (mix32 twice
// each; together 30 shifts, xors and adds on the integer ALU, 18.8 µs at
// its 64 lanes per SM over 10 ticks, and 8 IMADs on the FMA pipe beside ~50
// float ops, 10.3 µs), a log, a sqrt, a cos and a sin/cos, and shares a
// block reduction: the least time is the ALU's 18.8 µs. On an NVIDIA H100
// 80GB HBM3 at 700 W, N = 2^20: 73.0-74.0 µs at 10 ticks (the kernel before
// it: 97.5-98.3), K6 18.1-18.2 µs (20.9-21.0).

#include <cuda_runtime.h>
#include <stdint.h>

#include "pf_rng.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPPT = 4;                      // particles per thread
constexpr int kGroup = kThreads * kPPT;      // particles per group = per partial
constexpr int kRows = 6;
constexpr int kStageBytes = kRows * kGroup * (int)sizeof(float);  // one group's six rows
constexpr int kMaxK = 64;
constexpr float kPi = 3.14159265358979323846f;

__device__ inline float wrap_angle(float a) {
  // floored modulo, as jnp.mod / torch.remainder: mod(a + π, 2π) − π. For
  // |x| < 4π the remainder is x − 2π (x ≥ 2π), x, or x + 2π, each exact by
  // Sterbenz's lemma where fmodf's quotient is ±1, so the sign fix-up below
  // sees fmodf's bits; past that fmodf itself.
  const float two_pi = 2.0f * kPi;
  const float x = a + kPi;
  float r;
  if (fabsf(x) < 2.0f * two_pi) {
    r = x >= two_pi ? x - two_pi : (x <= -two_pi ? x + two_pi : x);
  } else {
    r = fmodf(x, two_pi);
  }
  if (r < 0.0f) r += two_pi;  // r != 0 && r < 0: −0 stays
  return r - kPi;
}

__device__ inline void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}

__device__ inline void cp_async4(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}

__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ inline void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

// Start copying group g's six rows into the shared-memory stage (zero past n).
template <bool VEC>
__device__ inline void stage_group(float* dst, const float* __restrict__ parts, int n, int g) {
  const int base = g * kGroup;
  const int tid = threadIdx.x;
  if (VEC) {  // n % 4 == 0 and 16-byte rows: a 16-byte chunk per thread and row
    const int j = base + 4 * tid;
    const bool ok = j < n;
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      cp_async16(dst + r * kGroup + 4 * tid, parts + (size_t)r * n + (ok ? j : 0), ok ? 16 : 0);
  } else {
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int k = 0; k < kPPT; ++k) {
        const int j = base + k * kThreads + tid;
        const bool ok = j < n;
        cp_async4(dst + r * kGroup + k * kThreads + tid, parts + (size_t)r * n + (ok ? j : 0),
                  ok ? 4 : 0);
      }
  }
}

template <bool NXY, bool NYAW, int KFIX, bool VEC>
__global__ void __launch_bounds__(kThreads)
predict_kernel(int n, int K_, int nticks, int idx_off, const float* __restrict__ parts,
               const float* __restrict__ par16, const int* __restrict__ seeds,
               float* __restrict__ out, float* __restrict__ sums) {
  const int K = KFIX > 0 ? KFIX : K_;
  extern __shared__ float4 stage4[];         // the next group's six rows, in flight
  float* stage = reinterpret_cast<float*>(stage4);
  __shared__ float sp[kMaxK * 16];
  __shared__ float strig[kMaxK * 4];         // cos roll, sin roll, cos pitch, sin pitch
  __shared__ uint32_t skey[kMaxK * 4];       // generator keys of draws 0..3
  __shared__ float red[kThreads / 32][8];
  const int tid = threadIdx.x;
  const int P = (n + kGroup - 1) / kGroup;   // groups = partials

  int g = blockIdx.x;
  if (g < P) stage_group<VEC>(stage, parts, n, g);
  cp_async_commit();
  for (int i = tid; i < nticks * 16; i += kThreads) sp[i] = par16[i];
  __syncthreads();
  for (int t = tid; t < nticks; t += kThreads) {
    const float roll = sp[t * 16 + 4], pitch = sp[t * 16 + 5];
    strig[t * 4 + 0] = cosf(roll);
    strig[t * 4 + 1] = sinf(roll);
    strig[t * 4 + 2] = cosf(pitch);
    strig[t * 4 + 3] = sinf(pitch);
    const uint32_t seed = (uint32_t)seeds[t];
    for (int d = 0; d < 4; ++d) skey[t * 4 + d] = pf_rng::draw_key(seed, (uint32_t)d);
  }

  for (; g < P; g += gridDim.x) {
    cp_async_wait<0>();                      // group g's rows have landed
    __syncthreads();
    const int base = g * kGroup;
    const float count = (float)min(kGroup, n - base);
    float x[kPPT], y[kPPT], z[kPPT], ro[kPPT], pi[kPPT], yw[kPPT];
#pragma unroll
    for (int k = 0; k < kPPT; ++k) {
      const int e = k * kThreads + tid;
      x[k] = stage[0 * kGroup + e];
      y[k] = stage[1 * kGroup + e];
      z[k] = stage[2 * kGroup + e];
      ro[k] = stage[3 * kGroup + e];
      pi[k] = stage[4 * kGroup + e];
      yw[k] = stage[5 * kGroup + e];
    }
    __syncthreads();                         // every thread has its rows: refill the stage
    if (g + gridDim.x < P) stage_group<VEC>(stage, parts, n, g + gridDim.x);
    cp_async_commit();

    for (int t = 0; t < nticks; ++t) {
      const float* p = sp + t * 16;
      const float cr = strig[t * 4 + 0], sr = strig[t * 4 + 1];
      const float cp = strig[t * 4 + 2], s_p = strig[t * 4 + 3];
      const float scale = p[11];
      const float dyaw = p[3];
      const float sd_x = NXY ? p[7] * scale : 0.0f;
      const float sd_y = NXY ? p[8] * scale : 0.0f;
      const float sd_w = NYAW ? p[9] * scale : 0.0f;
      const float v0 = p[0], v1 = p[1], v2 = p[2];
      const uint32_t k0 = skey[t * 4 + 0], k1 = skey[t * 4 + 1];
      const uint32_t k2 = skey[t * 4 + 2], k3 = skey[t * 4 + 3];
      const bool subst = p[12] > 0.5f;
      float acc[7] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int k = 0; k < kPPT; ++k) {
        const int j = base + k * kThreads + tid;
        float nx = 0.0f, ny = 0.0f, nw = 0.0f, unused;
        const uint32_t gi = (uint32_t)idx_off + (uint32_t)j;  // the generator's particle index
        if (NXY) pf_rng::normal_pair(k0, k1, gi, &nx, &ny);
        if (NYAW) pf_rng::normal_pair(k2, k3, gi, &nw, &unused);
        float yaw = yw[k] + dyaw;
        if (NYAW) yaw = yaw + nw * sd_w;
        yaw = wrap_angle(yaw);
        float sy, cy;
        __sincosf(yaw, &sy, &cy);  // |yaw| <= π: ~2^-21 absolute
        float xn = x[k] + (cy * cp) * v0 + (cy * s_p * sr - sy * cr) * v1 +
                   (cy * s_p * cr + sy * sr) * v2;
        float yn = y[k] + (sy * cp) * v0 + (sy * s_p * sr + cy * cr) * v1 +
                   (sy * s_p * cr - cy * sr) * v2;
        if (NXY) {
          xn = xn + nx * sd_x;
          yn = yn + ny * sd_y;
        }
        x[k] = xn;
        y[k] = yn;
        yw[k] = yaw;
        if (subst) {
          z[k] = p[6];
          ro[k] = p[4];
          pi[k] = p[5];
        }
        if (j < n) {
          acc[0] += xn;
          acc[1] += yn;
          acc[2] += xn * xn;
          acc[3] += yn * yn;
          acc[4] += xn * yn;
          acc[5] += sy;
          acc[6] += cy;
        }
      }
      pf_rng::block_moments<kThreads>(acc, count, red, sums + (size_t)t * 8 * P + g, P);
    }
    for (int t = nticks; t < K; ++t)
      if (tid < 8) sums[((size_t)t * 8 + tid) * P + g] = 0.0f;

#pragma unroll
    for (int k = 0; k < kPPT; ++k) {
      const int j = base + k * kThreads + tid;
      if (j >= n) continue;
      out[j] = x[k];
      out[(size_t)n + j] = y[k];
      out[2 * (size_t)n + j] = z[k];
      out[3 * (size_t)n + j] = ro[k];
      out[4 * (size_t)n + j] = pi[k];
      out[5 * (size_t)n + j] = yw[k];
    }
  }
  cp_async_wait<0>();
}

// The grid for n particles and nticks ticks. Up to two ticks the kernel is
// bound by the bank's bytes: a persistent grid (every block the card holds at
// once, or fewer where the same number of rounds covers the groups) walks
// the groups, so one group's copy runs under another's ticks and stores.
// From three ticks on it is bound by the tick loop's instructions: a block per
// group, so the card's block scheduler evens the groups out over the SMs as
// blocks finish (the loop runs once; its prefetch is idle). Measured on an
// NVIDIA H100 80GB HBM3 at 700 W, N = 2^20: K6 18.1 µs persistent, 19.6 a
// block per group; 10 ticks 76.5 persistent, 72.8 a block per group. The
// occupancy is cached per instantiation and device.
template <bool NXY, bool NYAW, int KFIX, bool VEC>
cudaError_t launch_one(int device, cudaStream_t s, int n, int K, int nticks, int idx_off,
                       const float* parts, const float* par16, const int* seeds, float* out,
                       float* sums) {
  static int per_sm[64] = {0}, sms[64] = {0};
  auto kern = predict_kernel<NXY, NYAW, KFIX, VEC>;
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (per_sm[device] == 0) {
    cudaError_t e = cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return e;
    int occ = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, kThreads, kStageBytes);
    if (e != cudaSuccess) return e;
    per_sm[device] = occ > 0 ? occ : 1;
  }
  const int P = (n + kGroup - 1) / kGroup;
  const int cap = per_sm[device] * sms[device];
  const int rounds = (P + cap - 1) / cap;
  const int blocks = nticks <= 2 ? (P + rounds - 1) / rounds : P;
  kern<<<blocks, kThreads, kStageBytes, s>>>(n, K, nticks, idx_off, parts, par16, seeds, out,
                                             sums);
  return cudaGetLastError();
}

template <int KFIX, bool VEC>
cudaError_t launch(bool nxy, bool nyaw, int device, cudaStream_t s, int n, int K,
                   int nticks, int idx_off, const float* parts, const float* par16,
                   const int* seeds, float* out, float* sums) {
  if (nxy && nyaw)
    return launch_one<true, true, KFIX, VEC>(device, s, n, K, nticks, idx_off, parts, par16,
                                             seeds, out, sums);
  if (nxy)
    return launch_one<true, false, KFIX, VEC>(device, s, n, K, nticks, idx_off, parts, par16,
                                              seeds, out, sums);
  if (nyaw)
    return launch_one<false, true, KFIX, VEC>(device, s, n, K, nticks, idx_off, parts, par16,
                                              seeds, out, sums);
  return launch_one<false, false, KFIX, VEC>(device, s, n, K, nticks, idx_off, parts, par16,
                                             seeds, out, sums);
}

}  // namespace

extern "C" int pf_predict_launch(int device, void* stream, int n, int K, int nticks,
                                 int nxy, int nyaw, int single, int idx_off, const void* parts,
                                 const void* par16, const void* seeds, void* out,
                                 void* sums) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (n < 1 || K < 1 || K > kMaxK || nticks < 0 || nticks > K || (single && K != 1) ||
      idx_off < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* pp = (const float*)parts;
  const float* pr = (const float*)par16;
  const int* sd = (const int*)seeds;
  float* o = (float*)out;
  float* sm = (float*)sums;
  // 16-byte copies need every row 16-byte aligned: n % 4 == 0 and the bank too
  const bool vec = n % 4 == 0 && (reinterpret_cast<uintptr_t>(parts) & 15) == 0;
  if (single)
    e = vec ? launch<1, true>(nxy, nyaw, device, s, n, K, nticks, idx_off, pp, pr, sd, o, sm)
            : launch<1, false>(nxy, nyaw, device, s, n, K, nticks, idx_off, pp, pr, sd, o, sm);
  else
    e = vec ? launch<0, true>(nxy, nyaw, device, s, n, K, nticks, idx_off, pp, pr, sd, o, sm)
            : launch<0, false>(nxy, nyaw, device, s, n, K, nticks, idx_off, pp, pr, sd, o, sm);
  return (int)e;
}
