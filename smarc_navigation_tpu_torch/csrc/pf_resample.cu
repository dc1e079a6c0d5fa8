// K7 / K8: systematic-resample ancestor expansion + bank gather, and the
// x/y/yaw resample jitter with the post-resample pose moments.
//
// Replaces the TPU kernels smarc_navigation_tpu/ops/pf_kernels.py::
// expand_gather_call (K7, pallas_call at :562, body _make_resample_kernel,
// driven by systematic_resample_gather) and ::jitter_moments_call (K8,
// pallas_call at :472, body _jitter_kernel). Contract: this package's
// ops/pf_kernels.expand_gather_call_reference / jitter_moments_call_reference:
// output slot j takes ancestor i = min{i : m_cum[i] > j}
// (resampling._expand_blocks), every row is gathered, and with a jitter
// x/y/yaw get sd·N(0,1) from the generator keyed on (seed, seed_off + j) and
// the block's 8 moment sums are written to an (8, n_blocks) partials buffer.
//
// One thread per 4 output slots (strided by the block width), 256 threads
// per block. The TPU kernel expands ancestors through per-block windows, a
// one-hot matrix on the MXU and a ladder of window widths with an exact
// fallback for weights whose ancestors spread past the widest window. Here
// each slot binary-searches m_cum (4 MiB at N = 2^20, resident in the 50 MB
// L2), which is exact for every weight vector, degenerate ones included, so
// there is no window, no ladder and no fallback branch. K7 with a jitter and
// K8 are one template with the same jitter device code and the same
// reduction, so K7(jitter) equals K8(K7(no jitter)) bit for bit (the port's
// form of the TPU's "the jitter stream does not depend on the branch").
// Built with -fmad=false.
//
// What bounds it on the H100: the gather. The bank is read at ancestor
// positions (monotone, so neighbouring slots read neighbouring or equal
// addresses) and written once: 48 MiB at N = 2^20, ~15 µs at 3.35 TB/s. The
// 20-step dependent search through L2 per slot adds latency that enough
// resident warps hide; K8 alone is one streaming pass.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pf_rng.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPPT = 4;
constexpr int kGroup = kThreads * kPPT;

// smallest i in [0, n) with m_cum[i] > j (m_cum is monotone and ends at n)
__device__ __forceinline__ int ancestor(const int* __restrict__ m_cum, int n, int j) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(m_cum + mid) > j) hi = mid;
    else lo = mid + 1;
  }
  return lo;
}

template <bool GATHER, bool JITTER>
__global__ void __launch_bounds__(kThreads)
resample_kernel(int n, int rows, const int* __restrict__ m_cum,
                const float* __restrict__ parts, const float* __restrict__ sd3,
                const int* __restrict__ seed, int seed_off,
                float* __restrict__ out, float* __restrict__ sums) {
  __shared__ float red[kThreads / 32][8];
  const int tid = threadIdx.x;
  const int base = blockIdx.x * kGroup;
  uint32_t k0 = 0, k1 = 0, k2 = 0, k3 = 0;
  float sdx = 0.0f, sdy = 0.0f, sdw = 0.0f;
  if (JITTER) {
    const uint32_t s = (uint32_t)seed[0];
    k0 = pf_rng::draw_key(s, 0u);
    k1 = pf_rng::draw_key(s, 1u);
    k2 = pf_rng::draw_key(s, 2u);
    k3 = pf_rng::draw_key(s, 3u);
    sdx = sd3[0];
    sdy = sd3[1];
    sdw = sd3[2];
  }
  float acc[7] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < kPPT; ++k) {
    const int j = base + k * kThreads + tid;
    if (j >= n) continue;
    const int i = GATHER ? ancestor(m_cum, n, j) : j;
    for (int r = 0; r < rows; ++r) {
      if (JITTER && (r == 0 || r == 1 || r == 5)) continue;
      out[(size_t)r * n + j] = parts[(size_t)r * n + i];
    }
    float x = parts[i], y = parts[(size_t)n + i], yaw = parts[5 * (size_t)n + i];
    if (JITTER) {
      const uint32_t idx = (uint32_t)(seed_off + j);
      float nx, ny, nw, unused;
      pf_rng::normal_pair(k0, k1, idx, &nx, &ny);
      pf_rng::normal_pair(k2, k3, idx, &nw, &unused);
      x = x + nx * sdx;
      y = y + ny * sdy;
      yaw = yaw + nw * sdw;
      out[j] = x;
      out[(size_t)n + j] = y;
      out[5 * (size_t)n + j] = yaw;
      float sy, cy;
      sincosf(yaw, &sy, &cy);
      acc[0] += x;
      acc[1] += y;
      acc[2] += x * x;
      acc[3] += y * y;
      acc[4] += x * y;
      acc[5] += sy;
      acc[6] += cy;
    }
  }
  if (JITTER)
    pf_rng::block_moments<kThreads>(acc, (float)min(kGroup, n - base), red,
                                    sums + blockIdx.x, gridDim.x);
}

// the generator's raw uniforms, for holding it against its torch version
__global__ void uniforms_kernel(int n, uint32_t key, int seed_off, float* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j < n) out[j] = pf_rng::uniform(key, (uint32_t)(seed_off + j));
}

}  // namespace

// out (n,) = uniforms of draw `draw` under `seed` for particles seed_off + [0, n)
extern "C" int pf_uniforms_launch(int device, void* stream, int n, int seed,
                                  int seed_off, int draw, void* out) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (n < 1 || draw < 0) return (int)cudaErrorInvalidValue;
  const uint32_t key = pf_rng::draw_key((uint32_t)seed, (uint32_t)draw);
  uniforms_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(n, key, seed_off, (float*)out);
  return (int)cudaGetLastError();
}

// parts/out (rows, n) with rows 6 or 8; m_cum (n,) int32 (gather != 0);
// sd3 (3,) f32, seed (1,) int32, sums (8, ceil(n/1024)) (jitter != 0).
// gather=1, jitter=0|1: K7; gather=0, jitter=1: K8.
extern "C" int pf_resample_launch(int device, void* stream, int n, int rows,
                                  int gather, int jitter, const void* m_cum,
                                  const void* parts, const void* sd3,
                                  const void* seed, int seed_off, void* out,
                                  void* sums) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (n < 1 || (rows != 6 && rows != 8) || (!gather && !jitter))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((n + kGroup - 1) / kGroup);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* mc = (const int*)m_cum;
  const float* pp = (const float*)parts;
  const float* sd = (const float*)sd3;
  const int* sp = (const int*)seed;
  float* o = (float*)out;
  float* sm = (float*)sums;
  if (gather && jitter)
    resample_kernel<true, true><<<grid, kThreads, 0, s>>>(n, rows, mc, pp, sd, sp, seed_off, o, sm);
  else if (gather)
    resample_kernel<true, false><<<grid, kThreads, 0, s>>>(n, rows, mc, pp, sd, sp, seed_off, o, sm);
  else
    resample_kernel<false, true><<<grid, kThreads, 0, s>>>(n, rows, mc, pp, sd, sp, seed_off, o, sm);
  return (int)cudaGetLastError();
}
