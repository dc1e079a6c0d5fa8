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
// Rows of ticks [nticks, K) are written as zeros.
//
// One thread per 4 particles (strided by the block width, so loads and
// stores are coalesced), 256 threads per block. A particle's six values are
// loaded once, stepped through all nticks ticks in registers and stored
// once; the K parameter rows, the per-tick roll/pitch cos/sin and the
// per-tick generator keys sit in shared memory. Per tick each block reduces
// its moment sums with warp shuffles into a (K, 8, n_blocks) partials
// buffer (no float atomics: a run reproduces itself bit for bit). The
// template flags <NXY, NYAW> compile the zero-std noise rows out, as the
// TPU kernel's trace-time flags do. K6 is the same kernel instantiated for
// K = 1 (KFIX), so the per-tick and the multi-tick paths share one op order
// and give bitwise equal banks. Built with -fmad=false: every product
// rounds, as in the plain version's elementwise ops.
//
// What bounds it on the H100: device memory. A call moves 48 MiB at N = 2^20
// (the bank read and written once), ~15 µs at 3.35 TB/s, whatever the tick
// count; per tick each particle costs ~60 integer ops of generator (when
// its noise is on), two sincosf, a logf and a block reduction, so calls
// with many noisy ticks lean towards the ALUs, not the bytes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pf_rng.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPPT = 4;                      // particles per thread
constexpr int kGroup = kThreads * kPPT;      // particles per block = per partial
constexpr int kMaxK = 64;
constexpr float kPi = 3.14159265358979323846f;

__device__ inline float wrap_angle(float a) {
  // floored modulo, as jnp.mod / torch.remainder: mod(a + π, 2π) − π
  const float two_pi = 2.0f * kPi;
  const float x = a + kPi;
  float r = fmodf(x, two_pi);
  if (r != 0.0f && (r < 0.0f) != (two_pi < 0.0f)) r += two_pi;
  return r - kPi;
}

template <bool NXY, bool NYAW, int KFIX>
__global__ void __launch_bounds__(kThreads)
predict_kernel(int n, int K_, int nticks, const float* __restrict__ parts,
               const float* __restrict__ par16, const int* __restrict__ seeds,
               float* __restrict__ out, float* __restrict__ sums) {
  const int K = KFIX > 0 ? KFIX : K_;
  __shared__ float sp[kMaxK * 16];
  __shared__ float strig[kMaxK * 4];         // cos roll, sin roll, cos pitch, sin pitch
  __shared__ uint32_t skey[kMaxK * 4];       // generator keys of draws 0..3
  __shared__ float red[kThreads / 32][8];
  const int tid = threadIdx.x;
  const int P = gridDim.x;

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
  __syncthreads();

  const int base = blockIdx.x * kGroup;
  const float count = (float)min(kGroup, n - base);
  float x[kPPT], y[kPPT], z[kPPT], ro[kPPT], pi[kPPT], yw[kPPT];
#pragma unroll
  for (int k = 0; k < kPPT; ++k) {
    const int j = base + k * kThreads + tid;
    const bool ok = j < n;
    x[k] = ok ? parts[j] : 0.0f;
    y[k] = ok ? parts[(size_t)n + j] : 0.0f;
    z[k] = ok ? parts[2 * (size_t)n + j] : 0.0f;
    ro[k] = ok ? parts[3 * (size_t)n + j] : 0.0f;
    pi[k] = ok ? parts[4 * (size_t)n + j] : 0.0f;
    yw[k] = ok ? parts[5 * (size_t)n + j] : 0.0f;
  }

  for (int t = 0; t < nticks; ++t) {
    const float* p = sp + t * 16;
    const float cr = strig[t * 4 + 0], sr = strig[t * 4 + 1];
    const float cp = strig[t * 4 + 2], s_p = strig[t * 4 + 3];
    const float scale = p[11];
    const bool subst = p[12] > 0.5f;
    float acc[7] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < kPPT; ++k) {
      const int j = base + k * kThreads + tid;
      float nx = 0.0f, ny = 0.0f, nw = 0.0f, unused;
      if (NXY) pf_rng::normal_pair(skey[t * 4 + 0], skey[t * 4 + 1], (uint32_t)j, &nx, &ny);
      if (NYAW) pf_rng::normal_pair(skey[t * 4 + 2], skey[t * 4 + 3], (uint32_t)j, &nw, &unused);
      float yaw = yw[k] + p[3];
      if (NYAW) yaw = yaw + nw * (p[9] * scale);
      yaw = wrap_angle(yaw);
      float sy, cy;
      sincosf(yaw, &sy, &cy);
      float xn = x[k] + (cy * cp) * p[0] + (cy * s_p * sr - sy * cr) * p[1] +
                 (cy * s_p * cr + sy * sr) * p[2];
      float yn = y[k] + (sy * cp) * p[0] + (sy * s_p * sr + cy * cr) * p[1] +
                 (sy * s_p * cr - cy * sr) * p[2];
      if (NXY) {
        xn = xn + nx * (p[7] * scale);
        yn = yn + ny * (p[8] * scale);
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
    pf_rng::block_moments<kThreads>(acc, count, red,
                                    sums + (size_t)t * 8 * P + blockIdx.x, P);
  }
  for (int t = nticks; t < K; ++t)
    if (tid < 8) sums[((size_t)t * 8 + tid) * P + blockIdx.x] = 0.0f;

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

template <int KFIX>
cudaError_t launch(bool nxy, bool nyaw, dim3 grid, cudaStream_t s, int n, int K,
                   int nticks, const float* parts, const float* par16,
                   const int* seeds, float* out, float* sums) {
  if (nxy && nyaw)
    predict_kernel<true, true, KFIX><<<grid, kThreads, 0, s>>>(n, K, nticks, parts, par16, seeds, out, sums);
  else if (nxy)
    predict_kernel<true, false, KFIX><<<grid, kThreads, 0, s>>>(n, K, nticks, parts, par16, seeds, out, sums);
  else if (nyaw)
    predict_kernel<false, true, KFIX><<<grid, kThreads, 0, s>>>(n, K, nticks, parts, par16, seeds, out, sums);
  else
    predict_kernel<false, false, KFIX><<<grid, kThreads, 0, s>>>(n, K, nticks, parts, par16, seeds, out, sums);
  return cudaGetLastError();
}

}  // namespace

// parts (6, n), par16 (K, 16), seeds (K,), out (6, n), sums (K, 8, ceil(n/1024));
// single != 0 selects the K = 1 instantiation (K6).
extern "C" int pf_predict_launch(int device, void* stream, int n, int K, int nticks,
                                 int nxy, int nyaw, int single, const void* parts,
                                 const void* par16, const void* seeds, void* out,
                                 void* sums) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (n < 1 || K < 1 || K > kMaxK || nticks < 0 || nticks > K || (single && K != 1))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((n + kGroup - 1) / kGroup);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* pp = (const float*)parts;
  const float* pr = (const float*)par16;
  const int* sd = (const int*)seeds;
  float* o = (float*)out;
  float* sm = (float*)sums;
  e = single ? launch<1>(nxy, nyaw, grid, s, n, K, nticks, pp, pr, sd, o, sm)
             : launch<0>(nxy, nyaw, grid, s, n, K, nticks, pp, pr, sd, o, sm);
  return (int)e;
}
