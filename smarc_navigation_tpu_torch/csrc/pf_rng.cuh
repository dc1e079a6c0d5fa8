// Counter-based random numbers of the particle-filter kernels (K5-K8).
//
// Replaces the TPU hardware PRNG of smarc_navigation_tpu/ops/pf_kernels.py
// (pltpu.prng_seed / prng_random_bits, seeded per VMEM chunk). Here a draw
// is a pure function of (seed, global particle index, draw index), never of
// a block or chunk id, so the stream does not depend on the launch shape.
// The same functions are written in torch integer ops in
// ops/pf_kernels.py (_mix32, uniforms, normals3); the uniforms agree bit for
// bit, the Box-Muller normals to the special-function unit's log and
// sin/cos (__logf, __sincosf: ~2^-21 absolute error on these arguments)
// against torch.log/cos/sin.
//
// Hash: two rounds of a xorshift-multiply 32-bit bijection; only low 32-bit
// products, xors and shifts, so the torch version needs no 64-bit high
// words. Uniform: the top 24 bits, (b + 0.5) / 2^24, in (0, 1).

#pragma once

#include <stdint.h>

namespace pf_rng {

constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr float kTwoPi = 6.28318530717958647692f;

__host__ __device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// per-(seed, draw) key; computed once per tick, not per particle
__host__ __device__ __forceinline__ uint32_t draw_key(uint32_t seed, uint32_t draw) {
  return mix32(seed + kGolden * (draw + 1u));
}

__device__ __forceinline__ float uniform(uint32_t key, uint32_t idx) {
  const uint32_t b = mix32(mix32(idx ^ key) + key);
  return (float)(b >> 8) * (1.0f / 16777216.0f) + (0.5f / 16777216.0f);
}

// Box-Muller over the draws keyed ka (radius) and kb (angle); the log and
// the sine and cosine on the special-function unit (one instruction each in
// place of libm's ~20-30). Near u = 1, |log u| is below __logf's absolute
// error, which may then come out positive: the clamp keeps the radius's
// argument at 0 there (elsewhere it changes no bit).
__device__ __forceinline__ void normal_pair(uint32_t ka, uint32_t kb,
                                            uint32_t idx, float* c, float* s) {
  const float r = sqrtf(fmaxf(-2.0f * __logf(uniform(ka, idx)), 0.0f));
  float sn, cs;
  __sincosf(kTwoPi * uniform(kb, idx), &sn, &cs);
  *c = r * cs;
  *s = r * sn;
}

// The 8 moment sums of a block (x, y, x², y², xy, sin yaw, cos yaw) from
// each thread's accumulators, in a fixed order (no float atomics): warp
// shuffles, then one pass over the warps' results. Row r goes to
// dst[r * stride]; row 7 is the block's particle count. Every thread of the
// block must call it.
template <int kThreads>
__device__ __forceinline__ void block_moments(const float acc[7], float count,
                                              float (*red)[8], float* dst,
                                              int stride) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < 7; ++r) {
    float v = acc[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) red[warp][r] = v;
  }
  __syncthreads();
  if (threadIdx.x < 7) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) s += red[w][threadIdx.x];
    dst[threadIdx.x * stride] = s;
  } else if (threadIdx.x == 7) {
    dst[7 * stride] = count;
  }
  __syncthreads();
}

}  // namespace pf_rng
