// K12: the symmetric covariance downdate of K2 (phase 1 writes its factors).
//
// Replaces the TPU kernel smarc_navigation_tpu/ops/slam_kernels.py::
// _make_downdate_kernel (phase 2 of sequential_update_fleet(streamed=True),
// pallas_call at :807): Σ_out = Σ − ½(UᵀV + VᵀU), exactly symmetric.
// Contract: this package's ops/slam_kernels.symmetric_downdate_reference.
// Here Σ is the raw covariance of K2's phase 1, and the two terms phase 1
// leaves outside the factors are applied on the fly: the predicted pose
// rows P (Σ'[i, c] = P[i, c] for i < 6, P[c, i] for c < 6) and the diagonal
// of the new-landmark activations. Every entry is ½(s_ic + s_ci),
// s = Σ' + Act − UᵀV, s_ic = Σ'(i,c) + Act(i,c) then fmaf(−u_i, v_c, ·) over
// the factor rows in order, s_ci likewise with i and c swapped: entries
// (i, c) and (c, i) take the same two chains, so Σ_out is exactly
// symmetric, and phase 1's band (csrc/slam_update.cu) takes the same order,
// so it holds Σ_out's entries. (A tensor-core product would sum in another
// order; the kernel is bound by bytes, not by its FMAs.)
//
// Design: a persistent kernel, one block per SM. The work items are the
// (mission, row tile, column tile) pairs of 64×64 tiles over the upper
// triangle, in row-band order; each block walks a contiguous run of them.
// An item reads its Σ tile and the mirror tile (one tile for a diagonal
// item) and the U/V columns of its column tile; the row band's U/V columns
// stay in shared memory for all of the band's items the block walks. Where
// the K factor rows do not fit the ring (K > 43 on the H100's 227 KB), each
// item is walked in steps of a chunk of at most that many rows, in order:
// the first step stages the tiles, every step its rows of the row band's
// and the column tile's U/V columns, the accumulators stay in registers
// across the steps, and the last step writes the tiles — the same fmaf
// sequence per entry.
// Twelve memory warps stage the items by cp.async (8-byte copies: a row of
// Σ starts only 8-byte aligned at even D; 16-byte where D is a multiple of
// 4; 4-byte at odd D; no tensor map, whose strides must be multiples of 16
// bytes) into a ring of three stages and store the finished tiles; eight
// compute warps never issue a device-memory instruction. Named barriers
// hand each stage over: staged (memory -> compute), computed (compute ->
// memory). A compute thread owns a 4×4 block of the tile and the mirror
// block: per factor row, four conflict-free float4 shared loads (the tiles'
// 16-byte chunks are swizzled by the row) feed 32 FMAs. Items of the first
// row band stage their tile's rows 0-5 from P and copy them into the
// mirror's pose columns. A partial column tile (D = 64·n + 6 leaves a 6-wide
// one) is taken transposed, so that the compute warps whose rows all lie
// past the state skip it.
//
// What bounds it on the H100: bytes, through the memory warps' copies. At
// L=256, B=32 (D=774, M·dim=24) Σ in and out are 2 × 76.7 MB (45.8 µs at
// 3.35 TB/s); the 2·M·dim FMAs per entry are ~0.9 GFLOP (14 µs at 67
// TFLOP/s). The first version (one 32×32 tile pair per block, all threads
// copying, computing and storing in turn) took 133.7 µs there on an NVIDIA
// H100 80GB HBM3 at 700.00 W.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;         // tile side
constexpr int kThreads = 256;  // the compute warps: 16 × 16 threads, each owning a 4 × 4 block
constexpr int kMemThreads = 384;                 // the memory warps: copies in, stores out
constexpr int kBlock = kThreads + kMemThreads;
constexpr int kStages = 3;     // items in flight per block
constexpr int kTileFloats = kT * kT;
static_assert(kThreads == (kT / 4) * (kT / 4), "a thread owns a 4 × 4 block of the tile");

// named barriers (0 is __syncthreads): per stage "staged" (memory warps
// arrive, compute warps wait) and "computed" (the reverse), then one for
// each group of warps alone
constexpr int kBarStaged = 1, kBarComputed = 1 + kStages, kBarCompute = 1 + 2 * kStages,
              kBarMem = 2 + 2 * kStages;
static_assert(kBarMem < 16, "16 named barriers per block");

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  __threadfence_block();
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// a tile's shared layout: row-major, 16-byte chunks swizzled by row / 4, so
// that the row-wise and the transposed float4 reads are conflict-free
__device__ __forceinline__ int swz(int row, int col) {
  return row * kT + ((((col >> 2) ^ (row >> 2)) & 15) << 2) + (col & 3);
}

template <int W>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (W == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
  else if (W == 2)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// the walk over the items' steps: (mission, row tile, column tile), ti <=
// tc, and the chunk ch of the factor rows (nch chunks per item)
struct Cursor {
  int b, ti, tc, ch;
  int band;  // the row band's U/V buffer: the ordinal of the (b, ti) band in
             // this block's walk, or of the step where each step stages its own
  __device__ void next(int nt, int nch) {
    if (nch > 1) ++band;
    if (++ch < nch) return;
    ch = 0;
    if (++tc == nt) {
      if (nch == 1) ++band;
      if (++ti == nt) {
        ++b;
        ti = 0;
      }
      tc = ti;
    }
  }
};

struct Smem {
  float* A;  // per stage: the Σ tile (rows ti, cols tc)
  float* Bm; //   the mirror tile (rows tc, cols ti)
  float* Uc; //   the column tile's U/V columns, KC × kT each (KC: rows per chunk)
  float* Vc;
  float* Ui; // per band buffer: the row band's U/V columns
  float* Vi;
};

__host__ __device__ inline int stage_floats(int kc) { return 2 * kTileFloats + 2 * kc * kT; }

__device__ __forceinline__ Smem buffers(float* sm, int kc, int stage, int band) {
  float* st = sm + stage * stage_floats(kc);
  float* bd = sm + kStages * stage_floats(kc) + (band % kStages) * 2 * kc * kT;
  return {st, st + kTileFloats, st + 2 * kTileFloats, st + 2 * kTileFloats + kc * kT, bd,
          bd + kc * kT};
}

// W floats per copy and per store: 4 where every row starts 16-byte aligned
// (D a multiple of 4), 2 where it starts 8-byte aligned (even D), else 1.
// The memory warps (thread t of kMemThreads) move a row's 32·W floats per
// warp instruction.

// stage a 64×64 tile of a (D, D) matrix (rows r0.., cols c0..) into a
// swizzled buffer, rows 0-5 from the (6, D) pose rows P6 where given;
// entries past the state are zero
template <int W>
__device__ __forceinline__ void stage_tile(int t, float* dst, const float* src, int D, int r0,
                                           int c0, const float* P6 = nullptr) {
  constexpr int per_row = kT / W;
  for (int e = t; e < kT * per_row; e += kMemThreads) {
    const int row = e / per_row, col = (e % per_row) * W;
    float* d = dst + swz(row, col);
    if (r0 + row < D && c0 + col < D) {
      const float* m = P6 && r0 + row < 6 ? P6 : src;
      cp_async<W>(d, m + (size_t)(r0 + row) * D + c0 + col);
    } else {
      for (int u = 0; u < W; ++u) d[u] = 0.0f;
    }
  }
}

// stage the K factor rows' columns c0..c0+63 (K × kT, row-major)
template <int W>
__device__ __forceinline__ void stage_cols(int t, float* dst, const float* src, int D, int K,
                                           int c0) {
  constexpr int per_row = kT / W;
  for (int e = t; e < K * per_row; e += kMemThreads) {
    const int r = e / per_row, col = (e % per_row) * W;
    float* d = dst + r * kT + col;
    if (c0 + col < D) {
      cp_async<W>(d, src + (size_t)r * D + c0 + col);
    } else {
      for (int u = 0; u < W; ++u) d[u] = 0.0f;
    }
  }
}

// write a swizzled 64×64 tile to rows r0.., cols c0.. of a (D, D) matrix,
// whole row segments per warp
template <int W>
__device__ __forceinline__ void store_tile(int t, float* dst, const float* src, int D, int r0,
                                           int c0) {
  constexpr int per_row = kT / W;
  for (int e = t; e < kT * per_row; e += kMemThreads) {
    const int row = e / per_row, col = (e % per_row) * W;
    if (r0 + row >= D || c0 + col >= D) continue;
    float* g = dst + (size_t)(r0 + row) * D + c0 + col;
    const float* v = src + swz(row, col);
    if (W == 4)
      *reinterpret_cast<float4*>(g) = *reinterpret_cast<const float4*>(v);
    else if (W == 2)
      *reinterpret_cast<float2*>(g) = make_float2(v[0], v[1]);
    else
      g[0] = v[0];
  }
}

// A partial column tile goes to the thread rows (the item taken transposed:
// ½(s_ci + s_ic) = ½(s_ic + s_ci)), so that the compute warps whose rows all
// lie past the state skip their work; then A holds rows r0, cols q0.
__device__ __forceinline__ bool swapped(const Cursor& it, int D) {
  return it.ti != it.tc && D - it.tc * kT < kT;
}

template <int W>
__global__ void __launch_bounds__(kBlock, 1)
downdate_kernel(int D, int K, int KC, int nt, int n_items, const float* __restrict__ Sigma,
                const float* __restrict__ U, const float* __restrict__ V,
                const float* __restrict__ P, const float* __restrict__ act,
                float* __restrict__ Sigma_out) {
  extern __shared__ float4 sm4[];  // float4: the compute loop reads 16-byte chunks
  float* sm = reinterpret_cast<float*>(sm4);
  const int npairs = nt * (nt + 1) / 2;
  const int nch = (K + KC - 1) / KC;
  const int lo = (int)((long long)blockIdx.x * n_items / gridDim.x);
  const int hi = (int)((long long)(blockIdx.x + 1) * n_items / gridDim.x);
  const int n = (hi - lo) * nch;  // the block's steps
  if (n <= 0) return;

  Cursor first;
  {
    int p = lo % npairs, ti = 0;
    while (p >= nt - ti) {
      p -= nt - ti;
      ++ti;
    }
    first = {lo / npairs, ti, ti + p, 0, 0};
  }
  const size_t DD = (size_t)D * D;

  if (threadIdx.x >= kThreads) {  // --- the memory warps --------------------------------
    const int t = threadIdx.x - kThreads;
    // the copies of one step into its stage (and, at a new band, its band
    // buffer), committed as one group
    Cursor iss = first;
    int iss_band = -1;
    auto issue = [&](int stage) {
      const Smem s = buffers(sm, KC, stage, iss.band);
      const float* Sb = Sigma + iss.b * DD;
      const int r0 = iss.ch * KC, kc = K - r0 < KC ? K - r0 : KC;  // the chunk's factor rows
      const float* Ub = U + ((size_t)iss.b * K + r0) * D;
      const float* Vb = V + ((size_t)iss.b * K + r0) * D;
      const int i0 = iss.ti * kT, c0 = iss.tc * kT;
      const float* P6 = P ? P + (size_t)iss.b * 6 * D : nullptr;
      const bool swap = swapped(iss, D), first_step = iss.ch == 0;
      if (first_step)
        stage_tile<W>(t, s.A, Sb, D, swap ? c0 : i0, swap ? i0 : c0, swap ? nullptr : P6);
      if (iss.band != iss_band) {
        stage_cols<W>(t, s.Ui, Ub, D, kc, i0);
        stage_cols<W>(t, s.Vi, Vb, D, kc, i0);
        iss_band = iss.band;
      }
      if (iss.ti != iss.tc) {
        if (first_step)
          stage_tile<W>(t, s.Bm, Sb, D, swap ? i0 : c0, swap ? c0 : i0, swap ? P6 : nullptr);
        stage_cols<W>(t, s.Uc, Ub, D, kc, c0);
        stage_cols<W>(t, s.Vc, Vb, D, kc, c0);
      }
    };
    // at an item's last step, its output tile and its transpose (left in
    // the step's tile buffers by the compute warps) to Σ_out
    Cursor sto = first;
    auto store = [&](int stage) {
      if (sto.ch == nch - 1) {
        const Smem s = buffers(sm, KC, stage, sto.band);
        const bool swap = swapped(sto, D), diag = sto.ti == sto.tc;
        const int i0 = sto.ti * kT, c0 = sto.tc * kT;
        const int r0 = swap ? c0 : i0, q0 = swap ? i0 : c0;
        float* So = Sigma_out + sto.b * DD;
        store_tile<W>(t, So, s.A, D, r0, q0);
        if (!diag) store_tile<W>(t, So, s.Bm, D, q0, r0);
      }
      sto.next(nt, nch);
    };
    for (int k = 0; k < kStages - 1; ++k) {
      if (k < n) {
        issue(k);
        iss.next(nt, nch);
      }
      cp_commit();
    }
    for (int k = 0; k < n; ++k) {
      cp_wait<kStages - 2>();  // step k's copies have landed
      bar_arrive(kBarStaged + k % kStages, kBlock);
      if (k > 0) {
        bar_sync(kBarComputed + (k - 1) % kStages, kBlock);
        store((k - 1) % kStages);
      }
      bar_sync(kBarMem, kMemThreads);  // step k - 1's stage is free for step k + kStages - 1
      if (k + kStages - 1 < n) {
        issue((k + kStages - 1) % kStages);
        iss.next(nt, nch);
      }
      cp_commit();
    }
    bar_sync(kBarComputed + (n - 1) % kStages, kBlock);
    store((n - 1) % kStages);
    return;
  }

  // --- the compute warps -----------------------------------------------------------------
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  Cursor cur = first;
  float sic[4][4] = {}, sci[4][4] = {};  // kept across an item's steps
  for (int k = 0; k < n; ++k, cur.next(nt, nch)) {
    bar_sync(kBarStaged + k % kStages, kBlock);
    const Smem s = buffers(sm, KC, k % kStages, cur.band);
    const int kc = K - cur.ch * KC < KC ? K - cur.ch * KC : KC;  // the step's factor rows
    const bool diag = cur.ti == cur.tc;
    const int b = cur.b, i0 = cur.ti * kT, c0 = cur.tc * kT;
    const bool swap = swapped(cur, D);
    const int r0 = swap ? c0 : i0, q0 = swap ? i0 : c0;
    float* At = s.A;
    float* Bt = diag ? s.A : s.Bm;
    const float* Ur = swap ? s.Uc : s.Ui;
    const float* Vr = swap ? s.Vc : s.Vi;
    const float* Uq = diag || swap ? s.Ui : s.Uc;
    const float* Vq = diag || swap ? s.Vi : s.Vc;

    // the first row band holds the pose rows: Σ' there is P, staged in the
    // tile whose rows they are, and its transpose in the pose columns
    if (P && cur.ti == 0 && cur.ch == 0) {
      float* Pt = swap ? Bt : At;
      float* Ct = swap ? At : Bt;
      for (int e = threadIdx.x; e < 6 * kT; e += kThreads) {
        const int y = e / 6, x = e % 6;  // row c0+y, pose column x: P[x][c0+y]
        if (diag ? (y >= 6 && y < D) : c0 + y < D) Ct[swz(y, x)] = Pt[swz(x, y)];
      }
      bar_sync(kBarCompute, kThreads);
    }

    // s_ic for (i, c) = (r0+4ty+q, q0+4tx+p); s_ci for the mirror entry
    const float* ab = act ? act + (size_t)b * D : nullptr;
    const bool idle = r0 + 8 * (threadIdx.x >> 5) >= D;  // the warp's rows are past the state
    if (!idle && cur.ch == 0) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 a = *reinterpret_cast<const float4*>(At + swz(4 * ty + q, 4 * tx));
        sic[q][0] = a.x;
        sic[q][1] = a.y;
        sic[q][2] = a.z;
        sic[q][3] = a.w;
      }
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const float4 m = *reinterpret_cast<const float4*>(Bt + swz(4 * tx + p, 4 * ty));
        sci[0][p] = m.x;
        sci[1][p] = m.y;
        sci[2][p] = m.z;
        sci[3][p] = m.w;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const int i = r0 + 4 * ty + q, c = q0 + 4 * tx + p;
          const float a = (ab && i == c && i < D) ? ab[i] : 0.0f;
          sic[q][p] = sic[q][p] + a;
          sci[q][p] = sci[q][p] + a;
        }
      }
    }
    if (!idle) {
#pragma unroll 4
      for (int r = 0; r < kc; ++r) {
        const float4 ui = *reinterpret_cast<const float4*>(Ur + r * kT + 4 * ty);
        const float4 vi = *reinterpret_cast<const float4*>(Vr + r * kT + 4 * ty);
        const float4 uc = *reinterpret_cast<const float4*>(Uq + r * kT + 4 * tx);
        const float4 vc = *reinterpret_cast<const float4*>(Vq + r * kT + 4 * tx);
        const float u_i[4] = {ui.x, ui.y, ui.z, ui.w}, v_i[4] = {vi.x, vi.y, vi.z, vi.w};
        const float u_c[4] = {uc.x, uc.y, uc.z, uc.w}, v_c[4] = {vc.x, vc.y, vc.z, vc.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            sic[q][p] = fmaf(-u_i[q], v_c[p], sic[q][p]);
            sci[q][p] = fmaf(-u_c[p], v_i[q], sci[q][p]);
          }
        }
      }
    }

    // at the item's last step, the output tile and its transpose into the
    // step's tile buffers (every compute thread has read them), for the
    // memory warps to store
    if (cur.ch < nch - 1) {
      bar_arrive(kBarComputed + k % kStages, kBlock);
      continue;
    }
    bar_sync(kBarCompute, kThreads);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float4 o;
      o.x = 0.5f * (sic[q][0] + sci[q][0]);
      o.y = 0.5f * (sic[q][1] + sci[q][1]);
      o.z = 0.5f * (sic[q][2] + sci[q][2]);
      o.w = 0.5f * (sic[q][3] + sci[q][3]);
      *reinterpret_cast<float4*>(s.A + swz(4 * ty + q, 4 * tx)) = o;
    }
    if (!diag) {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        float4 o;  // entry (c, i) = ½(s_ci + s_ic) = entry (i, c)
        o.x = 0.5f * (sic[0][p] + sci[0][p]);
        o.y = 0.5f * (sic[1][p] + sci[1][p]);
        o.z = 0.5f * (sic[2][p] + sci[2][p]);
        o.w = 0.5f * (sic[3][p] + sci[3][p]);
        *reinterpret_cast<float4*>(s.Bm + swz(4 * tx + p, 4 * ty)) = o;
      }
    }
    bar_arrive(kBarComputed + k % kStages, kBlock);
  }
}

// the device's SM count and opt-in shared memory per block (cached)
struct Card {
  int sms, optin;
};
cudaError_t card(int device, Card* out) {
  static Card cards[64];
  Card& c = cards[device];
  if (!c.sms) {
    cudaError_t e = cudaDeviceGetAttribute(&c.optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                           device);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) {
      c.sms = 0;
      return e;
    }
  }
  *out = c;
  return cudaSuccess;
}

// one launch of the W-wide kernel: one block per SM, as many as fill the
// card. The shared-memory attribute only grows, so a graph's earlier nodes
// keep what they were launched with.
template <int W>
int launch(int device, cudaStream_t stream, int sms, int D, int K, int KC, int nt, int n_items,
           size_t smem, const float* Sigma, const float* U, const float* V, const float* P,
           const float* act, float* Sigma_out) {
  static size_t set[64];
  if (smem > 48 * 1024 && smem > set[device]) {
    const cudaError_t e = cudaFuncSetAttribute(
        downdate_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    set[device] = smem;
  }
  downdate_kernel<W><<<n_items < sms ? n_items : sms, kBlock, smem, stream>>>(
      D, K, KC, nt, n_items, Sigma, U, V, P, act, Sigma_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int slam_downdate_launch(int device, void* stream, int B, int D, int K,
                                    const void* Sigma, const void* U, const void* V,
                                    const void* P, const void* act, void* Sigma_out) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (B < 1 || D < 6 || K < 1 || device < 0 || device >= 64) return (int)cudaErrorInvalidValue;
  Card c;
  e = card(device, &c);
  if (e != cudaSuccess) return (int)e;
  const int nt = (D + kT - 1) / kT;
  const long long n_items = (long long)B * nt * (nt + 1) / 2;
  if (n_items > (1 << 30)) return (int)cudaErrorInvalidValue;
  // the factor rows per step: all K where the ring holds them, else K split
  // into the fewest even chunks that it holds
  auto ring_bytes = [](int kc) {
    return (size_t)kStages * (stage_floats(kc) + 2 * kc * kT) * sizeof(float);
  };
  int kc_max = K;
  while (kc_max > 1 && ring_bytes(kc_max) > (size_t)c.optin) --kc_max;
  const int nch = (K + kc_max - 1) / kc_max, KC = (K + nch - 1) / nch;
  // the widest copies and stores at which every row segment is aligned
  const uintptr_t any =
      (uintptr_t)Sigma | (uintptr_t)U | (uintptr_t)V | (uintptr_t)P | (uintptr_t)Sigma_out;
  const auto st = static_cast<cudaStream_t>(stream);
  auto run = D % 4 == 0 && any % 16 == 0 ? launch<4>
             : D % 2 == 0 && any % 8 == 0 ? launch<2> : launch<1>;
  return run(device, st, c.sms, D, K, KC, nt, (int)n_items, ring_bytes(KC), (const float*)Sigma,
             (const float*)U, (const float*)V, (const float*)P, (const float*)act,
             (float*)Sigma_out);
}
