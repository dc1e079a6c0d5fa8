// K7 / K8: systematic-resample ancestor expansion + bank gather, and the
// x/y/yaw resample jitter with the post-resample pose moments.
//
// Replaces the TPU kernels smarc_navigation_tpu/ops/pf_kernels.py::
// expand_gather_call (K7, pallas_call at :562, body _make_resample_kernel,
// driven by systematic_resample_gather and, on a halo-extended window with
// an output offset, by parallel/resample_dist.py:148) and
// ::jitter_moments_call (K8, pallas_call at :472, body _jitter_kernel).
// Contract: this package's ops/pf_kernels.expand_gather_call_reference /
// expand_gather_window_call_reference / jitter_moments_call_reference:
// output slot j of n takes ancestor i = min{i : m_cum[i] > out_off + j},
// clamped to n_in - 1, of the n_in input columns (the whole-bank form is
// out_off = 0, n_in = n: resampling._expand_blocks), every row is gathered,
// and with a jitter
// x/y/yaw get sd·N(0,1) from the generator keyed on (seed, seed_off + j) and
// the block's 8 moment sums are written to an (8, n_blocks) partials buffer.
//
// K7 runs in two phases in one cooperative launch of a persistent grid
// (every block resident at once, so a block may wait for another):
//   A. ancestors by a merge-path partition (a load-balanced search) of the
//      slot sequence out_off..out_off+n-1 against m_cum: merging the two
//      sorted lists, a count boundary m_cum[i] goes before slot j when
//      m_cum[i] <= out_off + j, so the slot is emitted after exactly its
//      ancestor's number of boundaries (boundaries below the window all go
//      first, those past it last). The merged sequence (n_in boundaries and
//      n slots) is cut into
//      fixed spans of kSpan items, a contiguous run of spans per block. The
//      block finds where its run starts by one block-wide 256-ary diagonal
//      search of m_cum (three rounds of loads at N = 2^20); a span's window
//      of m_cum is loaded coalesced into shared memory (the next one while
//      the span merges) and the span's end is found in it; each thread finds
//      its kVT-item run by a binary search of the window and merges it
//      sequentially, writing its slots' ancestors to shared memory; the block
//      writes them out coalesced to an (n,) scratch buffer and adds the slots
//      it wrote to each 1024-slot group's counter. A span costs the same
//      whatever the weights: a degenerate vector (one particle takes every
//      slot) gives spans of slots only, a long run of zero counts spans of
//      boundaries only; there is no window ladder and no fallback.
//   B. per 1024-slot group, once its counter is full (or every block is
//      through A, so no wait can hang whatever m_cum holds): group_pass, the
//      device code of K8 with the ancestors read from the scratch. Each
//      thread takes four neighbouring slots, reads every row at their
//      (monotone: equal or neighbouring) ancestors and writes it with one
//      16-byte store where n and the rows allow (else a slot at a time, K8's
//      mapping); with the jitter, x/y/yaw get jitter() and the block sums the
//      group's moments in K8's thread order from shared memory. So
//      K7(jitter) equals K8(K7(no jitter)) bit for bit, bank and sums, with no
//      float atomics, and every group costs the same for any weights.
//   The counters let a block with no span of its own stream its groups as
//   soon as their ancestors are in; one grid-wide barrier between the
//   phases in their place cost 4-5 µs with the jitter (36.9-37.0 µs on
//   healthy weights). The wrapper zeroes them, one fill (~1 µs) per call.
// K8 is group_pass without the gather, one block per group. Built with
// -fmad=false; the Box-Muller and the moments' sin/cos on the special-function
// unit (pf_rng.cuh).
//
// What bounds it on the H100: the bytes. The bank is read at ancestor
// positions and written once, and m_cum read once: 52 MiB at N = 2^20 with
// the jitter, ~16 µs at 3.35 TB/s. On top come the ancestors' round trip
// through the scratch (8 MiB, mostly in L2) and phase A, whose ~10 µs of
// dependent loads and barriers run before the first group streams. On an
// NVIDIA H100 80GB HBM3 at 700 W, N = 2^20, healthy weights: 32.1-32.2 µs
// with the jitter, 33.1 with the counters' fill (the one-search-per-slot
// kernel before it: 37.7-39.9), 29.2-29.4 without (31.4-31.8), 23.7-24.4 on
// degenerate or zero-run weights with the jitter (29.4-29.5).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "pf_rng.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPPT = 4;
constexpr int kGroup = kThreads * kPPT;    // slots per moment partial
constexpr int kSpan = 4096;                // merged items (boundaries + slots) per phase-A span
constexpr int kVT = kSpan / kThreads;      // merged items per thread
constexpr unsigned kFull = 0xffffffffu;

struct Jitter {
  uint32_t k0, k1, k2, k3;
  float sdx, sdy, sdw;
};

__device__ inline Jitter make_jitter(const float* sd3, const int* seed) {
  const uint32_t s = (uint32_t)seed[0];
  return Jitter{pf_rng::draw_key(s, 0u), pf_rng::draw_key(s, 1u), pf_rng::draw_key(s, 2u),
                pf_rng::draw_key(s, 3u), sd3[0], sd3[1], sd3[2]};
}

// the resample jitter of the particle with generator index idx: K7's and K8's
__device__ __forceinline__ void jitter(const Jitter& J, uint32_t idx, float& x, float& y,
                                       float& yaw) {
  float nx, ny, nw, unused;
  pf_rng::normal_pair(J.k0, J.k1, idx, &nx, &ny);
  pf_rng::normal_pair(J.k2, J.k3, idx, &nw, &unused);
  x = x + nx * J.sdx;
  y = y + ny * J.sdy;
  yaw = yaw + nw * J.sdw;
}

__device__ __forceinline__ void accumulate(float acc[7], float x, float y, float yaw) {
  float sy, cy;
  __sincosf(yaw, &sy, &cy);
  acc[0] += x;
  acc[1] += y;
  acc[2] += x * x;
  acc[3] += y * y;
  acc[4] += x * y;
  acc[5] += sy;
  acc[6] += cy;
}

// The boundaries of m_cum merged before diagonal d (A-first on ties: the
// first a with m_cum[a] - off > d - 1 - a), by the whole block: each round the 256
// threads probe evenly spaced candidates and the count of true probes (a
// prefix) keeps the stretch where the predicate turns false; three rounds of
// loads at N = 2^20. Every thread must call it; every thread returns it.
__device__ int block_split(const int* __restrict__ m_cum, int n_in, int n, int off, int d,
                           int* s_lohi, int* s_cnt) {
  const int tid = threadIdx.x;
  if (tid == 0) {
    s_lohi[0] = max(0, d - n);
    s_lohi[1] = min(d, n_in);
  }
  __syncthreads();
  while (s_lohi[0] < s_lohi[1]) {
    const int lo = s_lohi[0], hi = s_lohi[1];
    const int step = (hi - lo + kThreads - 1) / kThreads;
    const int a = lo + tid * step;
    const bool pred = a < hi && __ldg(m_cum + a) - off <= d - 1 - a;
    const int c = __popc(__ballot_sync(kFull, pred));
    if ((tid & 31) == 0) s_cnt[tid >> 5] = c;
    __syncthreads();
    if (tid == 0) {
      int t = 0;
      for (int w = 0; w < kThreads / 32; ++w) t += s_cnt[w];
      if (t == 0) {
        s_lohi[1] = lo;
      } else {
        s_lohi[0] = lo + (t - 1) * step + 1;
        s_lohi[1] = min(hi, lo + t * step);
      }
    }
    __syncthreads();
  }
  const int a = s_lohi[0];
  __syncthreads();
  return a;
}

__device__ inline int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// A group's jittered x, y, yaw (for the sums in K8's order) and the
// reduction's scratch
struct GroupSmem {
  float x[kGroup], y[kGroup], yaw[kGroup];
  float red[kThreads / 32][8];
};

// One 1024-slot group g: every row gathered at the slots' ancestors (GATHER:
// from anc, rows of n_in columns; else the slot itself, n_in = n), the jitter
// on x/y/yaw, and the group's moment partial (JITTER), summed per thread over
// slots k·256 + tid (k < 4) in order, then block_moments. VEC: n % 4 == 0 and
// out 16-byte aligned.
template <bool GATHER, bool JITTER, bool VEC>
__device__ __forceinline__ void group_pass(int g, int n, int n_in, int rows, const int* anc,
                                           const float* __restrict__ parts, const Jitter& J,
                                           int seed_off, float* __restrict__ out,
                                           float* __restrict__ sums, int P, GroupSmem& sm) {
  const int tid = threadIdx.x;
  const int base = g * kGroup;
  if (VEC) {  // four neighbouring slots per thread, 16-byte stores
    const int j = base + 4 * tid;
    if (j < n) {
      int a[4];
      if (GATHER) {
        const int4 q = __ldcg(reinterpret_cast<const int4*>(anc + j));
        a[0] = q.x, a[1] = q.y, a[2] = q.z, a[3] = q.w;
#pragma unroll
        for (int w = 0; w < 4; ++w) a[w] = min(max(a[w], 0), n_in - 1);
      } else {
#pragma unroll
        for (int w = 0; w < 4; ++w) a[w] = j + w;
      }
      for (int r = 0; r < rows; ++r) {
        if (JITTER && (r == 0 || r == 1 || r == 5)) continue;
        const float* src = parts + (size_t)r * n_in;
        *reinterpret_cast<float4*>(out + (size_t)r * n + j) =
            make_float4(__ldg(src + a[0]), __ldg(src + a[1]), __ldg(src + a[2]), __ldg(src + a[3]));
      }
      if (JITTER) {
        float x[4], y[4], yw[4];
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          x[w] = __ldg(parts + a[w]);
          y[w] = __ldg(parts + (size_t)n_in + a[w]);
          yw[w] = __ldg(parts + 5 * (size_t)n_in + a[w]);
          jitter(J, (uint32_t)(seed_off + j + w), x[w], y[w], yw[w]);
          sm.x[4 * tid + w] = x[w];
          sm.y[4 * tid + w] = y[w];
          sm.yaw[4 * tid + w] = yw[w];
        }
        *reinterpret_cast<float4*>(out + j) = make_float4(x[0], x[1], x[2], x[3]);
        *reinterpret_cast<float4*>(out + (size_t)n + j) = make_float4(y[0], y[1], y[2], y[3]);
        *reinterpret_cast<float4*>(out + 5 * (size_t)n + j) = make_float4(yw[0], yw[1], yw[2], yw[3]);
      }
    }
  } else {  // a slot at a time: slots k·256 + tid
#pragma unroll
    for (int k = 0; k < kPPT; ++k) {
      const int e = k * kThreads + tid;
      const int j = base + e;
      if (j >= n) continue;
      const int i = GATHER ? min(max(__ldcg(anc + j), 0), n_in - 1) : j;
      for (int r = 0; r < rows; ++r) {
        if (JITTER && (r == 0 || r == 1 || r == 5)) continue;
        out[(size_t)r * n + j] = __ldg(parts + (size_t)r * n_in + i);
      }
      if (JITTER) {
        float x = __ldg(parts + i), y = __ldg(parts + (size_t)n_in + i);
        float yaw = __ldg(parts + 5 * (size_t)n_in + i);
        jitter(J, (uint32_t)(seed_off + j), x, y, yaw);
        out[j] = x;
        out[(size_t)n + j] = y;
        out[5 * (size_t)n + j] = yaw;
        sm.x[e] = x;
        sm.y[e] = y;
        sm.yaw[e] = yaw;
      }
    }
  }
  if (JITTER) {
    __syncthreads();
    float acc[7] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < kPPT; ++k) {
      const int e = k * kThreads + tid;
      if (base + e < n) accumulate(acc, sm.x[e], sm.y[e], sm.yaw[e]);
    }
    pf_rng::block_moments<kThreads>(acc, (float)min(kGroup, n - base), sm.red, sums + g, P);
  }
}

template <bool JITTER, bool VEC>
__global__ void __launch_bounds__(kThreads)
gather_kernel(int n, int n_in, int off, int rows, const int* __restrict__ m_cum,
              const float* __restrict__ parts, const float* __restrict__ sd3,
              const int* __restrict__ seed, int seed_off, float* __restrict__ out,
              float* __restrict__ sums, int* __restrict__ anc, int* __restrict__ ready) {
  __shared__ int s_m[kSpan];    // a span's window of m_cum - off
  __shared__ int s_anc[kSpan];  // ancestors of the span's slots
  __shared__ int s_lohi[2], s_cnt[kThreads / 32], s_a1;
  __shared__ GroupSmem sm;
  const int tid = threadIdx.x;
  const int total = n_in + n;   // merged items: boundaries, then slots
  const int spans = (total + kSpan - 1) / kSpan;
  const int P = (n + kGroup - 1) / kGroup;

  {
    // --- A. the ancestors of a contiguous run of spans: one search for where
    // the run starts; each span's end is found in the span's window, and the
    // next window is loaded while the span merges
    const int per = (spans + gridDim.x - 1) / gridDim.x;
    const int s0 = blockIdx.x * per, s1 = min(spans, s0 + per);
    int a0 = s0 < s1 ? block_split(m_cum, n_in, n, off, s0 * kSpan, s_lohi, s_cnt) : 0;
    int win[kVT];  // this thread's share of the next window, loaded ahead
#pragma unroll
    for (int k = 0; k < kVT; ++k) {
      const int i = tid + k * kThreads;
      win[k] = s0 < s1 && i < n_in - a0 ? __ldg(m_cum + a0 + i) - off : 0;
    }
    for (int sp = s0; sp < s1; ++sp) {
      const int d0 = sp * kSpan;
      const int d1 = min(total, d0 + kSpan);
      const int wn = min(kSpan, n_in - a0);  // the window m_cum[a0, a0 + wn)
#pragma unroll
      for (int k = 0; k < kVT; ++k) s_m[tid + k * kThreads] = win[k];
      __syncthreads();
      if (tid == 0) {  // the span's end: the first a with m_cum[a] - off > d1 - 1 - a
        int lo = max(a0, d1 - n), hi = min(min(d1, n_in), a0 + min(wn, d1 - d0));
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (s_m[mid - a0] <= d1 - 1 - mid) lo = mid + 1;
          else hi = mid;
        }
        s_a1 = lo;
      }
      __syncthreads();
      const int a1 = s_a1;
      if (sp + 1 < s1) {  // the next span's window, in flight during this merge
#pragma unroll
        for (int k = 0; k < kVT; ++k) {
          const int i = tid + k * kThreads;
          win[k] = i < n_in - a1 ? __ldg(m_cum + a1 + i) - off : 0;
        }
      }
      const int b0 = d0 - a0, b1 = d1 - a1;  // the span's slots [b0, b1)
      const int na = a1 - a0, nb = b1 - b0;
      {  // this thread's run [td, td + kVT) of the span: where it starts, then merge
        const int td = tid * kVT;
        int lo = max(0, td - nb), hi = min(td, na);
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (s_m[mid] <= b0 + td - 1 - mid) lo = mid + 1;
          else hi = mid;
        }
        int a = lo, b = td - lo;
        const int end = min(td + kVT, na + nb);
        for (int k = td; k < end; ++k) {
          if (a < na && (b >= nb || s_m[a] <= b0 + b)) {
            ++a;
          } else {
            s_anc[b] = a0 + a;
            ++b;
          }
        }
      }
      __syncthreads();
      for (int i = tid; i < nb; i += kThreads) anc[b0 + i] = s_anc[i];
      __threadfence();
      __syncthreads();
      if (tid == 0)
        for (int g = b0 / kGroup; nb > 0 && g * kGroup < b1; ++g)
          atomicAdd(ready + g, min(b1, (g + 1) * kGroup) - max(b0, g * kGroup));
      a0 = a1;
    }
    if (tid == 0) {  // this block's spans are all written
      __threadfence();
      atomicAdd(ready + P, 1);
    }
  }

  // --- B. each group once its ancestors are all written: K8's pass
  Jitter J{};
  if (JITTER) J = make_jitter(sd3, seed);
  for (int g = blockIdx.x; g < P; g += gridDim.x) {
    if (tid == 0) {  // (or once every block is through A: whatever m_cum holds, no wait hangs)
      const int size = min(kGroup, n - g * kGroup);
      while (load_acquire(ready + g) < size && load_acquire(ready + P) < (int)gridDim.x)
        __nanosleep(64);
    }
    __syncthreads();
    group_pass<true, JITTER, VEC>(g, n, n_in, rows, anc, parts, J, seed_off, out, sums, P, sm);
    __syncthreads();
  }
}

// K8: the jitter and moments of a bank, one block per 1024-slot group
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
jitter_kernel(int n, int rows, const float* __restrict__ parts, const float* __restrict__ sd3,
              const int* __restrict__ seed, int seed_off, float* __restrict__ out,
              float* __restrict__ sums) {
  __shared__ GroupSmem sm;
  const Jitter J = make_jitter(sd3, seed);
  group_pass<false, true, VEC>(blockIdx.x, n, n, rows, nullptr, parts, J, seed_off, out, sums,
                               gridDim.x, sm);
}

// K7's persistent grid: every block the card holds at once, at most one per
// span or group (the occupancy is cached per instantiation and device)
template <bool JITTER, bool VEC>
cudaError_t launch_gather(int device, cudaStream_t s, int n, int n_in, int off, int rows,
                          const int* m_cum, const float* parts, const float* sd3,
                          const int* seed, int seed_off, float* out, float* sums, int* anc,
                          int* ready) {
  static int per_sm[64] = {0}, sms[64] = {0};
  auto kern = gather_kernel<JITTER, VEC>;
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (per_sm[device] == 0) {
    cudaError_t e = cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return e;
    int occ = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, kThreads, 0);
    if (e != cudaSuccess) return e;
    per_sm[device] = occ > 0 ? occ : 1;
  }
  const long long spans = ((long long)n_in + n + kSpan - 1) / kSpan, P = (n + kGroup - 1) / kGroup;
  const int grid = (int)std::min((long long)per_sm[device] * sms[device], std::max(spans, P));
  void* args[] = {&n,    &n_in, &off,     &rows, &m_cum, &parts, &sd3,
                  &seed, &seed_off, &out, &sums, &anc,   &ready};
  return cudaLaunchCooperativeKernel((const void*)kern, dim3(grid), dim3(kThreads), args, 0, s);
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

// out (rows, n) with rows 6 or 8; parts (rows, n_in) and m_cum (n_in,) int32
// (gather != 0: slot j takes ancestor min{i : m_cum[i] > out_off + j},
// clamped to n_in - 1), anc (n,) int32 scratch and ready (ceil(n/1024) + 1,)
// int32 zeros; parts (rows, n), n_in = n and out_off = 0 without the gather;
// sd3 (3,) f32, seed (1,) int32, sums (8, ceil(n/1024)) (jitter != 0).
// gather=1, jitter=0|1: K7 (whole bank: n_in = n, out_off = 0; window: any);
// gather=0, jitter=1: K8.
extern "C" int pf_resample_launch(int device, void* stream, int n, int n_in, int out_off,
                                  int rows, int gather, int jitter, const void* m_cum,
                                  const void* parts, const void* sd3,
                                  const void* seed, int seed_off, void* out,
                                  void* sums, void* anc, void* ready) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (n < 1 || n > (1 << 30) || n_in < 1 || n_in > (1 << 30) || (rows != 6 && rows != 8) ||
      (long long)n + n_in > (1LL << 31) - kSpan || (!gather && !jitter) ||
      (!gather && (n_in != n || out_off != 0)) ||
      (gather && (anc == nullptr || ready == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* mc = (const int*)m_cum;
  const float* pp = (const float*)parts;
  const float* sd = (const float*)sd3;
  const int* sp = (const int*)seed;
  float* o = (float*)out;
  float* sm = (float*)sums;
  int* an = (int*)anc;
  int* rd = (int*)ready;
  // 16-byte stores need every output row 16-byte aligned
  const bool vec = n % 4 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  if (!gather) {
    const int grid = (n + kGroup - 1) / kGroup;
    if (vec)
      jitter_kernel<true><<<grid, kThreads, 0, s>>>(n, rows, pp, sd, sp, seed_off, o, sm);
    else
      jitter_kernel<false><<<grid, kThreads, 0, s>>>(n, rows, pp, sd, sp, seed_off, o, sm);
    return (int)cudaGetLastError();
  }
  if (jitter)
    e = vec ? launch_gather<true, true>(device, s, n, n_in, out_off, rows, mc, pp, sd, sp,
                                        seed_off, o, sm, an, rd)
            : launch_gather<true, false>(device, s, n, n_in, out_off, rows, mc, pp, sd, sp,
                                         seed_off, o, sm, an, rd);
  else
    e = vec ? launch_gather<false, true>(device, s, n, n_in, out_off, rows, mc, pp, sd, sp,
                                         seed_off, o, sm, an, rd)
            : launch_gather<false, false>(device, s, n, n_in, out_off, rows, mc, pp, sd, sp,
                                          seed_off, o, sm, an, rd);
  return (int)e;
}
