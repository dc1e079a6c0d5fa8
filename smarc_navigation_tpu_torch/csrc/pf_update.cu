// K13 / K14: the particle filter's GPS update ahead of K7 — the normalised
// GPS weights of a bank (K13) and its systematic cumulative counts (K14).
//
// Replaces no TPU kernel: the JAX package leaves both to XLA as plain jnp
// (smarc_navigation_tpu/models/particle_filter.py::_update_resample_fast's
// log-weights with ops/resampling.py::normalize_weights_det, and
// ::systematic_counts). They were added because on the card the same chain
// in plain torch was ~150 launches per GPS update (the order-pinned sums'
// slices, strided adds and cats), which held the host and left the device
// ~93 % idle. Contracts, bit for bit: this package's
// ops/pf_kernels.gps_weights_call_reference (K13) and
// ops/resampling.systematic_counts_reference (K14), at any bank size. Every
// sum follows the plain version's pinned summation tree, and every product
// and sum is a separately rounded IEEE op (the __f*_rn intrinsics, and the
// library is built with -fmad=false): no FMA contraction.
//
// K13 (gps_weights_kernel), one cooperative launch of a persistent grid over
// rows of CDF_BLOCK = 2048 particles:
//   1. each particle's log-weight in pf_kernels.fast_logw's order of
//      operations (the rotation, the fix, meas_var read from device memory),
//      the non-finite guard, written to the output; each row's max;
//   2. the global max (exact in any order), exp(logw - max) + 1e-30 in
//      place (expf, as torch.exp on the card) inside the first fold that
//      reads each weight;
//   3. tree_sum's folds and the divide. A bank that tiles by 2048 (and one
//      of 2048 or fewer, a single row) folds each row in its block, then
//      every block folds the row sums: two grid barriers. Any other bank
//      folds whole, zero-padded to a power of two P: its top halvings are
//      strided folds of 16 leaves a slot over the grid (P/16 slots, then
//      each stage 16 times fewer, a barrier each) until 2048 slots are
//      left, which every block folds.
// K14, resampling.prefix_sum's order — a sequential sum in each chunk of 16,
// the chunk totals scanned the same way one level up, each chunk's
// exclusive carry added as ``inner + carry`` adds it — then cdf[-1] = 1;
// clamp(ceil(n·cdf − u), 0, n) to int32 as float32 ops in that order (NaN
// to 0, as torch's cast does); m_cum[-1] = n; the running max. A leading
// axis of independent banks is a grid axis.
//   - systematic_counts_flat_kernel, a bank of 2048 or fewer: one block a
//     bank, its chunk totals scanned in shared memory; no barrier.
//   - systematic_counts_grid_kernel, any larger bank, one cooperative launch
//     over segments of 2048 (a bank that tiles by 2048: its rows, the
//     two-level blocked_cdf; any other: 128 chunks of its one-level
//     prefix_sum): (1) the row totals, or the chunk totals, to global
//     memory; (2) their scan, by each block in shared memory where a bank
//     has at most kMaxRows of them, else across the grid level by level
//     (grid_scan: up-sweep, top, down-sweep, one barrier a step); each
//     segment's cdf, counts and running max, its max; (3) the max of the
//     segments before (scanned across the grid past kMaxRows segments a
//     bank) into each segment.
//
// What bounds them on the H100: the bytes, and less the barriers. K13 reads
// x, y, z once and writes the weights once (16.8 MB at 2^20, 5.0 µs at
// 3.35 TB/s), plus the log-weights' round trip through L2; K14 reads the
// weights and writes the counts (8.4 MB, 2.5 µs), plus a second read and a
// read-modify-write of its rows, mostly in L2. Each barrier costs ~1-2 µs;
// the grid barriers' counters are zeroed by one memset before each launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <climits>

namespace {

constexpr int kRow = 2048;                  // resampling.CDF_BLOCK
constexpr int kBase = 16;                   // resampling.SCAN_BASE
constexpr int kFan = 16;                    // leaves of one slot of a strided fold stage
constexpr int kWThreads = 256;              // K13's block
constexpr int kCThreads = kRow / kBase;     // K14's block: a chunk of 16 per thread in a segment
constexpr int kFoldSlots = 2048;            // shared slots of a fold
constexpr int kMaxRows = 4096;              // totals of one bank a block scans in shared memory
constexpr unsigned kFull = 0xffffffffu;
constexpr float kFloor = static_cast<float>(1e-30);  // torch's cast of the Python float

// floats a scan of L values takes in shared memory: every level padded to 16
__host__ __device__ constexpr int scan_space(int L) {
  return L <= kBase ? kBase : (L + kBase - 1) / kBase * kBase + scan_space((L + kBase - 1) / kBase);
}

// words the levels above a grid-wide scan of B arrays of L take
__host__ __device__ inline long long scan_levels(int B, int L) {
  long long w = 0;
  while (L > kBase) {
    L = (L + kBase - 1) / kBase;
    w += (long long)B * L;
  }
  return w;
}

__host__ __device__ inline bool tiles(int n) { return n % kRow == 0 && n > kRow; }

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

__host__ __device__ inline int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// K13's first strided stage: the slots of a bank that folds whole
__host__ __device__ inline int first_slots(int n) {
  return imax(pow2_at_least(n) / kFan, kFoldSlots);
}

__device__ inline int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// The k-th grid-wide barrier of a cooperative launch (k = 1, 2, ...; ctr
// zeroed before the launch). Data other blocks wrote before it is read with
// __ldcg after it (from L2, never a stale L1 line).
__device__ void grid_sync(int* ctr, int k) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(ctr, 1);
    const int target = k * (int)gridDim.x;
    while (load_acquire(ctr) < target) __nanosleep(32);
    __threadfence();
  }
  __syncthreads();
}

__device__ float block_max(float v, float* red) {
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = -INFINITY;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) r = fmaxf(r, red[w]);
  __syncthreads();
  return r;
}

__device__ int block_max_int(int v, int* red) {
  for (int o = 16; o; o >>= 1) v = max(v, __shfl_xor_sync(kFull, v, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int r = INT_MIN;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) r = max(r, red[w]);
  __syncthreads();
  return r;
}

// ---------------------------------------------------------------------------
// the fold-in-half sum (resampling._fold_half)
// ---------------------------------------------------------------------------

// The fold-in-half of y_k = x[i + k·S], k < K (a power of two), x zero from L
// on: the leaves streamed in bit-reversed order and summed pairwise on a
// stack, which pairs them as the halvings do (y_k with y_{k + K/2} first).
// It is what slot i holds after the first log2(K) halvings of x.
template <class Get>
__device__ float strided_fold(const Get& get, int i, int S, int K, int L) {
  float stk[32];
  int top = 0;
  const int bits = __ffs(K) - 1;
  for (int s = 0; s < K; ++s) {
    const int k = bits ? (int)(__brev((unsigned)s) >> (32 - bits)) : 0;
    const long long j = i + (long long)k * S;
    float v = j < L ? get((int)j) : 0.0f;
    for (int b = s; b & 1; b >>= 1) v = __fadd_rn(stk[--top], v);
    stk[top++] = v;
  }
  return stk[0];
}

// _fold_half of get(0..L) by the whole block, returned to every thread: the
// top levels in each slot's own strided fold where the padded length passes
// kFoldSlots, the next in shared memory, the last five by warp shuffles
template <class Get>
__device__ float block_fold(const Get& get, int L, float* s) {
  const int P = pow2_at_least(L);
  const int S = min(P, kFoldSlots), K = P / S;
  for (int i = threadIdx.x; i < S; i += blockDim.x)
    s[i] = K == 1 ? (i < L ? get(i) : 0.0f) : strided_fold(get, i, S, K, L);
  __syncthreads();
  int p = S;
  while (p > 32) {
    p >>= 1;
    for (int i = threadIdx.x; i < p; i += blockDim.x) s[i] = __fadd_rn(s[i], s[i + p]);
    __syncthreads();
  }
  if (threadIdx.x < 32) {
    float v = (int)threadIdx.x < p ? s[threadIdx.x] : 0.0f;
    for (int q = p >> 1; q >= 1; q >>= 1) v = __fadd_rn(v, __shfl_down_sync(kFull, v, q));
    if (threadIdx.x == 0) s[0] = v;
  }
  __syncthreads();
  const float r = s[0];
  __syncthreads();
  return r;
}

// ---------------------------------------------------------------------------
// K13: GPS weights
// ---------------------------------------------------------------------------

struct Gps {
  float r[6], t[2], g[2], mv;
};

// fast_logw of particle i: ((r0·x + r1·y) + r2·z) + t per map axis, the fix
// minus it, -0.5·(dx² + dy²) / meas_var, non-finite to -inf
__device__ __forceinline__ float log_weight(const Gps& c, const float* parts, int n, int i) {
  const float x = __ldg(parts + i), y = __ldg(parts + n + i), z = __ldg(parts + 2 * (size_t)n + i);
  const float px = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(c.r[0], x), __fmul_rn(c.r[1], y)),
                                       __fmul_rn(c.r[2], z)), c.t[0]);
  const float py = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(c.r[3], x), __fmul_rn(c.r[4], y)),
                                       __fmul_rn(c.r[5], z)), c.t[1]);
  const float dx = __fsub_rn(c.g[0], px), dy = __fsub_rn(c.g[1], py);
  const float lw = __fdiv_rn(__fmul_rn(-0.5f, __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy))),
                             c.mv);
  return isfinite(lw) ? lw : -INFINITY;
}

// K13's scratch, in words: each row's max; the row sums or the first
// stage's slots; the next stage's slots; the barrier counter
struct WeightsLayout {
  long long rmax, a, b, ctr, words;
};

__host__ __device__ inline WeightsLayout weights_layout(int n) {
  const int R = (n + kRow - 1) / kRow;
  const bool whole = !tiles(n) && n > kRow;
  const int S1 = whole ? first_slots(n) : R;
  const int S2 = whole && S1 > kFoldSlots ? imax(S1 / kFan, kFoldSlots) : 0;
  WeightsLayout l;
  l.rmax = 0;
  l.a = R;
  l.b = l.a + S1;
  l.ctr = l.b + S2;
  l.words = l.ctr + 1;
  return l;
}

__global__ void __launch_bounds__(kWThreads)
gps_weights_kernel(int n, const float* __restrict__ parts, const float* __restrict__ gps,
                   const float* __restrict__ rot, const float* __restrict__ trans,
                   const float* __restrict__ meas_var, float* out, float* rmax, float* a,
                   float* b, int* ctr) {
  __shared__ float s[kFoldSlots];
  __shared__ float red[32];
  const int R = (n + kRow - 1) / kRow;
  Gps c;
  c.r[0] = rot[0], c.r[1] = rot[1], c.r[2] = rot[2];
  c.r[3] = rot[3], c.r[4] = rot[4], c.r[5] = rot[5];
  c.t[0] = trans[0], c.t[1] = trans[1], c.g[0] = gps[0], c.g[1] = gps[1], c.mv = meas_var[0];
  int bar = 0;

  // 1. log-weights, each row's max
  for (int g = blockIdx.x; g < R; g += gridDim.x) {
    float* o = out + (size_t)g * kRow;
    const int len = min(kRow, n - g * kRow);
    float m = -INFINITY;
    for (int i = threadIdx.x; i < len; i += blockDim.x) {
      const float lw = log_weight(c, parts, n, g * kRow + i);
      o[i] = lw;
      m = fmaxf(m, lw);
    }
    m = block_max(m, red);
    if (threadIdx.x == 0) rmax[g] = m;
  }
  grid_sync(ctr, ++bar);

  // 2. the global max; each weight exp(logw - max) + 1e-30, written back
  // where the first fold reads it (once per particle)
  float m = -INFINITY;
  for (int g = threadIdx.x; g < R; g += blockDim.x) m = fmaxf(m, __ldcg(rmax + g));
  m = block_max(m, red);
  const auto weight = [&](int j) {
    const float v = __fadd_rn(expf(__fsub_rn(__ldcg(out + j), m)), kFloor);
    out[j] = v;
    return v;
  };

  // 3. tree_sum
  float tot;
  if (tiles(n) || n <= kRow) {  // each row's fold, then the fold of the row sums
    for (int g = blockIdx.x; g < R; g += gridDim.x) {
      const int base = g * kRow, len = min(kRow, n - base);
      const float sum = block_fold([&](int i) { return weight(base + i); }, len, s);
      if (threadIdx.x == 0) a[g] = sum;
    }
    grid_sync(ctr, ++bar);
    tot = block_fold([&](int i) { return __ldcg(a + i); }, R, s);
  } else {  // the whole bank's fold: strided stages over the grid, then 2048 slots
    const int tid = blockIdx.x * blockDim.x + threadIdx.x, nth = gridDim.x * blockDim.x;
    const int P = pow2_at_least(n);
    int S = first_slots(n);
    for (int i = tid; i < S; i += nth) a[i] = strided_fold(weight, i, S, P / S, n);
    grid_sync(ctr, ++bar);
    float *src = a, *dst = b;
    while (S > kFoldSlots) {
      const int S2 = max(S / kFan, kFoldSlots);
      const float* from = src;
      for (int i = tid; i < S2; i += nth)
        dst[i] = strided_fold([&](int j) { return __ldcg(from + j); }, i, S2, S / S2, S);
      grid_sync(ctr, ++bar);
      float* t = src;
      src = dst;
      dst = t;
      S = S2;
    }
    const float* last = src;
    tot = block_fold([&](int i) { return __ldcg(last + i); }, S, s);
  }

  // the divide
  for (int g = blockIdx.x; g < R; g += gridDim.x) {
    float* o = out + (size_t)g * kRow;
    const int len = min(kRow, n - g * kRow);
    for (int i = threadIdx.x; i < len; i += blockDim.x) o[i] = __fdiv_rn(__ldcg(o + i), tot);
  }
}

// ---------------------------------------------------------------------------
// K14: systematic counts
// ---------------------------------------------------------------------------

// resampling.prefix_sum over a[0..L) in shared memory, in place: the chunks
// of 16 scanned in sequence, their totals written one level up (after the
// level's padded end) and scanned the same way, at the top (16 or fewer) in
// sequence; then each level's chunk c gets the carry a_up[c - 1] (0 for c = 0)
__device__ void scan_smem(float* a, int L) {
  float* lv[8];
  int len[8], k = 0;
  lv[0] = a;
  len[0] = L;
  while (len[k] > kBase) {
    const int m = (len[k] + kBase - 1) / kBase * kBase, C = m / kBase;
    for (int i = len[k] + threadIdx.x; i < m; i += blockDim.x) lv[k][i] = 0.0f;
    __syncthreads();
    float* up = lv[k] + m;
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      float* x = lv[k] + c * kBase;
      for (int j = 1; j < kBase; ++j) x[j] = __fadd_rn(x[j], x[j - 1]);
      up[c] = x[kBase - 1];
    }
    __syncthreads();
    lv[k + 1] = up;
    len[k + 1] = C;
    ++k;
  }
  if (threadIdx.x == 0)
    for (int j = 1; j < len[k]; ++j) lv[k][j] = __fadd_rn(lv[k][j], lv[k][j - 1]);
  __syncthreads();
  for (int j = k - 1; j >= 0; --j) {
    for (int i = threadIdx.x; i < len[j]; i += blockDim.x)
      lv[j][i] = __fadd_rn(lv[j][i], i >= kBase ? lv[j + 1][i / kBase - 1] : 0.0f);
    __syncthreads();
  }
}

struct AddF {
  __device__ float operator()(float a, float b) const { return __fadd_rn(a, b); }
};
struct MaxI {
  __device__ int operator()(int a, int b) const { return max(a, b); }
};

// prefix_sum's tree (with `op`; `id` its padding and chunk 0's carry) over
// B arrays a[b·L + i], i < L, in place, across the whole grid: each level's
// chunks of 16 scanned in sequence, their totals one level up (in `up`,
// scan_levels(B, L) words), the top (16 or fewer) in sequence, then each
// level's carries, top down; a grid barrier after each step. Every block
// calls it alike; returns the index of the last barrier.
template <class T, class Op>
__device__ int grid_scan(T* a, int B, int L, T* up, T id, Op op, int* ctr, int bar) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nth = (long long)gridDim.x * blockDim.x;
  T* lv[8];
  int len[8], k = 0;
  lv[0] = a;
  len[0] = L;
  while (len[k] > kBase) {
    const int C = (len[k] + kBase - 1) / kBase;
    for (long long t = tid; t < (long long)B * C; t += nth) {
      const int b = (int)(t / C), c = (int)(t % C);
      T* x = lv[k] + (size_t)b * len[k] + (size_t)c * kBase;
      const int m = min(kBase, len[k] - c * kBase);
      T s = __ldcg(x);
      for (int j = 1; j < kBase; ++j) {
        s = op(j < m ? __ldcg(x + j) : id, s);
        if (j < m) x[j] = s;
      }
      up[t] = s;
    }
    grid_sync(ctr, ++bar);
    lv[k + 1] = up;
    len[k + 1] = C;
    up += (size_t)B * C;
    ++k;
  }
  for (long long b = tid; b < B; b += nth) {
    T* x = lv[k] + (size_t)b * len[k];
    T s = __ldcg(x);
    for (int j = 1; j < len[k]; ++j) {
      s = op(__ldcg(x + j), s);
      x[j] = s;
    }
  }
  grid_sync(ctr, ++bar);
  for (int j = k - 1; j >= 0; --j) {
    for (long long t = tid; t < (long long)B * len[j]; t += nth) {
      const int b = (int)(t / len[j]), i = (int)(t % len[j]);
      const T carry = i >= kBase ? __ldcg(lv[j + 1] + (size_t)b * len[j + 1] + i / kBase - 1) : id;
      lv[j][t] = op(__ldcg(lv[j] + t), carry);
    }
    grid_sync(ctr, ++bar);
  }
  return bar;
}

// chunk c of x[0..len): its 16 values (zero past len) summed in sequence
__device__ __forceinline__ void chunk_scan(const float* __restrict__ x, int len, int c,
                                           float v[kBase]) {
#pragma unroll
  for (int j = 0; j < kBase; ++j) {
    const int i = c * kBase + j;
    v[j] = i < len ? __ldg(x + i) : 0.0f;
  }
#pragma unroll
  for (int j = 1; j < kBase; ++j) v[j] = __fadd_rn(v[j], v[j - 1]);
}

// Pass A of a segment x[0..len), len <= 2048: each chunk's total, then
// the totals scanned (prefix_sum over them), into sc[1..C], with sc[0] = 0:
// sc[c] is chunk c's carry. Returns the segment's inclusive sum at its last
// element (``rowcum[..., -1]`` where len is a multiple of 16, as a row's
// is) to every thread.
__device__ float segment_totals(const float* __restrict__ x, int len, float* sc) {
  const int C = (len + kBase - 1) / kBase;
  float v[kBase];
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    chunk_scan(x, len, c, v);
    sc[1 + c] = v[kBase - 1];
  }
  if (threadIdx.x == 0) sc[0] = 0.0f;
  __syncthreads();
  const float last = sc[C];  // the last chunk's own sum (its padding adds zeros)
  __syncthreads();
  if (C == 1) return last;
  scan_smem(sc + 1, C);
  const float r = __fadd_rn(last, sc[C - 1]);
  __syncthreads();
  return r;
}

// one count: clamp(ceil(n·cdf − u), 0, n), NaN kept by the clamp and cast to 0
__device__ __forceinline__ int count_of(float cdf, float nf, float u) {
  float y = ceilf(__fsub_rn(__fmul_rn(cdf, nf), u));
  if (!isnan(y)) y = fminf(fmaxf(y, 0.0f), nf);
  return (int)y;
}

// exclusive running max over the block's threads in order; *all the block's max
__device__ int block_excl_max(int v, int* red, int* all) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  int inc = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc = max(inc, t);
  }
  int exc = __shfl_up_sync(kFull, inc, 1);
  if (lane == 0) exc = INT_MIN;
  if (lane == 31) red[wid] = inc;
  __syncthreads();
  int tot = INT_MIN;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
    if (w < wid) exc = max(exc, red[w]);
    tot = max(tot, red[w]);
  }
  __syncthreads();
  *all = tot;
  return exc;
}

// Pass B of a segment x[0..len), len <= 2048 (a chunk of 16 per thread):
// each value's cdf (its chunk's carry cr[c] where cr is given, then +
// *prefix where given), the counts with the last-count guards where `last`
// (the bank's end), the running max within the segment, written to out.
// Returns the segment's max.
__device__ int segment_counts(const float* __restrict__ x, int len, const float* cr,
                              const float* prefix, bool last, float nf, int n, float u, int* out,
                              int* red) {
  const int c = threadIdx.x, C = (len + kBase - 1) / kBase;
  int m[kBase];
  int mx = INT_MIN;
  if (c < C) {
    float v[kBase];
    chunk_scan(x, len, c, v);
    const float carry = cr ? cr[c] : 0.0f;
#pragma unroll
    for (int j = 0; j < kBase; ++j) {
      const int i = c * kBase + j;
      float cdf = cr ? __fadd_rn(v[j], carry) : v[j];
      if (prefix) cdf = __fadd_rn(cdf, *prefix);
      const bool end = last && i == len - 1;
      int k = count_of(end ? 1.0f : cdf, nf, u);
      if (end) k = n;
      if (i < len) mx = max(mx, k);
      m[j] = mx;
    }
  }
  int all;
  const int before = block_excl_max(mx, red, &all);
  if (c < C) {
#pragma unroll
    for (int j = 0; j < kBase; ++j) {
      const int i = c * kBase + j;
      if (i < len) out[i] = max(m[j], before);
    }
  }
  return all;
}

// banks of 2048 or fewer: one block a bank
__global__ void __launch_bounds__(kCThreads)
systematic_counts_flat_kernel(int n, const float* __restrict__ w, const float* __restrict__ u,
                              int* out) {
  __shared__ float sc[1 + scan_space(kCThreads)];
  __shared__ int red[32];
  const int b = blockIdx.x;
  const float* x = w + (size_t)b * n;
  segment_totals(x, n, sc);
  segment_counts(x, n, n > kBase ? sc : nullptr, nullptr, true, (float)n, n, __ldg(u + b),
                 out + (size_t)b * n, red);
}

// K14's scratch for a bank past 2048, in words: the scanned totals (row
// totals of a tiling bank, else chunk totals), the levels above them where
// a bank has more than kMaxRows, each segment's max, its levels likewise,
// the barrier counter
struct CountsLayout {
  long long tot, lvf, smax, lvi, ctr, words;
};

__host__ __device__ inline CountsLayout counts_layout(int B, int n) {
  const int S = (n + kRow - 1) / kRow, C = (n + kBase - 1) / kBase;
  const int L = tiles(n) ? S : C;
  CountsLayout l;
  l.tot = 0;
  l.lvf = (long long)B * L;
  l.smax = l.lvf + (L > kMaxRows ? scan_levels(B, L) : 0);
  l.lvi = l.smax + (long long)B * S;
  l.ctr = l.lvi + (S > kMaxRows ? scan_levels(B, S) : 0);
  l.words = l.ctr + 1;
  return l;
}

// banks past 2048: B banks of S segments of 2048, G = B·S over the grid
__global__ void __launch_bounds__(kCThreads)
systematic_counts_grid_kernel(int B, int n, const float* __restrict__ w,
                              const float* __restrict__ u, int* out, float* tot, float* lvf,
                              int* smax, int* lvi, int* ctr) {
  __shared__ float sc[1 + scan_space(kMaxRows)];
  __shared__ float cr[kCThreads];
  __shared__ int red[32];
  const bool rows = tiles(n);
  const int S = (n + kRow - 1) / kRow, G = B * S, C = (n + kBase - 1) / kBase;
  const int L = rows ? S : C;
  const float nf = (float)n;
  int bar = 0;

  // 1. what is scanned across a bank: its rows' totals, or its chunks'
  if (rows) {
    for (int g = blockIdx.x; g < G; g += gridDim.x) {
      const float t = segment_totals(w + (size_t)g * kRow, kRow, sc);
      if (threadIdx.x == 0) tot[g] = t;
    }
  } else {
    const long long nth = (long long)gridDim.x * blockDim.x;
    float v[kBase];
    for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < (long long)B * C;
         t += nth) {
      chunk_scan(w + (size_t)(t / C) * n, n, (int)(t % C), v);
      tot[t] = v[kBase - 1];
    }
  }
  grid_sync(ctr, ++bar);
  const bool wide = L > kMaxRows;  // scanned across the grid, else by each block
  if (wide) bar = grid_scan(tot, B, L, lvf, 0.0f, AddF(), ctr, bar);

  // 2. each segment's cdf, counts and running max; the segment's max
  for (int g = blockIdx.x; g < G; g += gridDim.x) {
    const int b = g / S, s = g % S, len = min(kRow, n - s * kRow);
    const float* x = w + (size_t)b * n + (size_t)s * kRow;
    const float* ts = tot + (size_t)b * L;
    if (!wide) {
      for (int i = threadIdx.x; i < L; i += blockDim.x) sc[i] = __ldcg(ts + i);
      __syncthreads();
      scan_smem(sc, L);
    }
    float pre = 0.0f;  // a row's prefix (the rows before)
    if (rows) {
      if (s) pre = wide ? __ldcg(ts + s - 1) : sc[s - 1];
    } else {           // each chunk's carry (the chunks before)
      const int cg = s * kCThreads + threadIdx.x;
      if (cg < C) cr[threadIdx.x] = cg ? (wide ? __ldcg(ts + cg - 1) : sc[cg - 1]) : 0.0f;
    }
    __syncthreads();
    if (rows) segment_totals(x, kRow, sc);
    const int mx = segment_counts(x, len, rows ? sc : cr, rows ? &pre : nullptr, s == S - 1, nf,
                                  n, __ldg(u + b), out + (size_t)b * n + (size_t)s * kRow, red);
    if (threadIdx.x == 0) smax[g] = mx;
    __syncthreads();
  }
  grid_sync(ctr, ++bar);
  const bool wide_max = S > kMaxRows;
  if (wide_max) bar = grid_scan(smax, B, S, lvi, INT_MIN, MaxI(), ctr, bar);

  // 3. the running max of the bank's segments before
  for (int g = blockIdx.x; g < G; g += gridDim.x) {
    const int b = g / S, s = g % S;
    int carry = INT_MIN;
    if (wide_max) {
      if (s) carry = __ldcg(smax + (size_t)b * S + s - 1);
    } else {
      for (int i = threadIdx.x; i < s; i += blockDim.x)
        carry = max(carry, __ldcg(smax + (size_t)b * S + i));
      carry = block_max_int(carry, red);
    }
    if (s == 0) continue;
    int* o = out + (size_t)b * n + (size_t)s * kRow;
    const int len = min(kRow, n - s * kRow);
    for (int i = threadIdx.x; i < len; i += blockDim.x) o[i] = max(o[i], carry);
  }
}

// a persistent cooperative grid: every block the card holds at once, at most
// `work` (the occupancy cached per kernel and device)
template <class Kern>
cudaError_t cooperative(Kern kern, int threads, int device, long long work, int* per_sm,
                        int* sms, cudaStream_t s, void** args) {
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (per_sm[device] == 0) {
    cudaError_t e = cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return e;
    int occ = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, threads, 0);
    if (e != cudaSuccess) return e;
    per_sm[device] = occ > 0 ? occ : 1;
  }
  const int grid = (int)std::max(1LL, std::min((long long)per_sm[device] * sms[device], work));
  return cudaLaunchCooperativeKernel((const void*)kern, dim3(grid), dim3(threads), args, 0, s);
}

}  // namespace

// K13's scratch for a bank of n particles, in 4-byte words.
extern "C" long long pf_weights_scratch_words(int n) {
  return n < 1 ? 0 : weights_layout(n).words;
}

// K13. parts (6, n) f32; gps (2,), rot (3, 3), trans (3,), meas_var () f32;
// out (n,) f32; scratch pf_weights_scratch_words(n) words.
extern "C" int pf_weights_launch(int device, void* stream, int n, const void* parts,
                                 const void* gps, const void* rot, const void* trans,
                                 const void* meas_var, void* out, void* scratch) {
  static int per_sm[64] = {0}, sms[64] = {0};
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (n < 1 || n > (1 << 30)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const WeightsLayout l = weights_layout(n);
  float* base = static_cast<float*>(scratch);
  float* rmax = base + l.rmax;
  float* a = base + l.a;
  float* b = base + l.b;
  int* ctr = reinterpret_cast<int*>(base + l.ctr);
  e = cudaMemsetAsync(ctr, 0, sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  const long long R = (n + kRow - 1) / kRow;
  const long long work =
      !tiles(n) && n > kRow ? std::max(R, (long long)first_slots(n) / kWThreads) : R;
  void* args[] = {&n, &parts, &gps, &rot, &trans, &meas_var, &out, &rmax, &a, &b, &ctr};
  return (int)cooperative(gps_weights_kernel, kWThreads, device, work, per_sm, sms, s, args);
}

// K14's scratch for B banks of n, in 4-byte words (none for n <= 2048).
extern "C" long long pf_counts_scratch_words(int B, int n) {
  return B < 1 || n <= kRow ? 0 : counts_layout(B, n).words;
}

// K14. w (B, n) f32 banks, u (B,) f32, out (B, n) int32; scratch
// pf_counts_scratch_words(B, n) words.
extern "C" int pf_counts_launch(int device, void* stream, int B, int n, const void* w,
                                const void* u, void* out, void* scratch) {
  static int per_sm[64] = {0}, sms[64] = {0};
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (B < 1 || n < 1 || (long long)B * n > (1LL << 31) - 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wp = static_cast<const float*>(w);
  const float* up = static_cast<const float*>(u);
  int* op = static_cast<int*>(out);
  if (n <= kRow) {
    systematic_counts_flat_kernel<<<B, kCThreads, 0, s>>>(n, wp, up, op);
    return (int)cudaGetLastError();
  }
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  const CountsLayout l = counts_layout(B, n);
  float* base = static_cast<float*>(scratch);
  float* tot = base + l.tot;
  float* lvf = base + l.lvf;
  int* smax = reinterpret_cast<int*>(base + l.smax);
  int* lvi = reinterpret_cast<int*>(base + l.lvi);
  int* ctr = reinterpret_cast<int*>(base + l.ctr);
  e = cudaMemsetAsync(ctr, 0, sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  const long long G = (long long)B * ((n + kRow - 1) / kRow);
  void* args[] = {&B, &n, &wp, &up, &op, &tot, &lvf, &smax, &lvi, &ctr};
  return (int)cooperative(systematic_counts_grid_kernel, kCThreads, device, G, per_sm, sms, s,
                          args);
}
