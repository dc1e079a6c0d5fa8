// K12: the symmetric covariance downdate of K2's streamed schedule.
//
// Replaces the TPU kernel smarc_navigation_tpu/ops/slam_kernels.py::
// _make_downdate_kernel (phase 2 of sequential_update_fleet(streamed=True),
// pallas_call at :807): Σ_out = Σ − ½(UᵀV + VᵀU), exactly symmetric.
// Contract: this package's ops/slam_kernels.symmetric_downdate_reference.
// Here Σ is the raw covariance of K2's phase 1, and the two terms phase 1
// leaves outside the factors are applied on the fly: the predicted pose
// rows P (Σ'[i, c] = P[i, c] for i < 6, P[c, i] for c < 6) and the diagonal
// of the new-landmark activations. Every entry is ½(s_ic + s_ci),
// s = Σ' + Act − UᵀV, with the fmaf sequence of K2's one-kernel epilogue
// (csrc/slam_update.cu), so the two schedules give the same bits.
//
// Layout: a grid of (tile pair, mission) blocks over the upper triangle of
// 32×32 tiles. A block stages the U/V columns of its row tile and of its
// column tile in shared memory, reads its tile and the mirror tile once
// (the mirror through a padded shared transpose, both reads coalesced),
// computes each entry pair once and writes both tiles — so Σ is read once
// and written once, and the output is symmetric by construction. A thread
// owns one column and 4 contiguous rows of the tile: per factor row it
// loads two scalars and two float4 from shared memory for 8 FMAs (with one
// scalar load per FMA the kernel was bound by shared-memory loads: 221 µs
// at L=256, B=32 on an NVIDIA H100 80GB HBM3 at 700.00 W, against 133 µs
// now).
//
// What bounds it on the H100: bytes. At L=256, B=32 (D=774, M·dim=24) Σ in
// and out are 2 × 76.7 MB (45.8 µs at 3.35 TB/s); the 2·M·dim FMAs per
// entry are ~0.9 GFLOP (14 µs at 67 TFLOP/s). U/V (4.8 MB) stay in L2 and
// are re-read per tile from there. The one-kernel schedule runs the same
// downdate on one block per mission (32 of 132 SMs at B=32).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 32;        // tile side
constexpr int kThreads = 256; // 32 columns × 8 rows of threads
static_assert(kT / (kThreads / kT) == 4, "the inner loop is written for 4 rows a thread");

__global__ void __launch_bounds__(kThreads)
downdate_kernel(int D, int K, int nt, const float* __restrict__ Sigma,
                const float* __restrict__ U, const float* __restrict__ V,
                const float* __restrict__ P, const float* __restrict__ act,
                float* __restrict__ Sigma_out) {
  extern __shared__ float4 sm4[];  // float4: the inner loop's loads need 16-byte alignment
  float* Ui = reinterpret_cast<float*>(sm4);  // K × kT: U columns of the row tile
  float* Vi = Ui + K * kT;
  float* Uc = Vi + K * kT;     // ... and of the column tile
  float* Vc = Uc + K * kT;
  __shared__ float tr[kT][kT + 1];

  const int b = blockIdx.y;
  int p = blockIdx.x, ti = 0;  // pair index -> (ti, tc), ti <= tc
  while (p >= nt - ti) {
    p -= nt - ti;
    ++ti;
  }
  const int tc = ti + p;
  const int i0 = ti * kT, c0 = tc * kT;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const float* S = Sigma + (size_t)b * D * D;
  const float* Pb = P ? P + (size_t)b * 6 * D : nullptr;
  const float* ab = act ? act + (size_t)b * D : nullptr;
  const float* Ub = U + (size_t)b * K * D;
  const float* Vb = V + (size_t)b * K * D;
  float* So = Sigma_out + (size_t)b * D * D;

  // Σ'(i, c) + Act(i, c): predicted pose rows, their transpose in the pose
  // columns, the raw Σ elsewhere
  auto base = [&](int i, int c) -> float {
    float v;
    if (Pb && i < 6) v = Pb[i * D + c];
    else if (Pb && c < 6) v = Pb[c * D + i];
    else v = S[(size_t)i * D + c];
    return v + ((ab && i == c) ? ab[i] : 0.0f);
  };

  for (int k = threadIdx.x; k < K * kT; k += kThreads) {
    const int r = k / kT, x = k % kT;
    const int ii = i0 + x, cc = c0 + x;
    Ui[k] = ii < D ? Ub[(size_t)r * D + ii] : 0.0f;
    Vi[k] = ii < D ? Vb[(size_t)r * D + ii] : 0.0f;
    Uc[k] = cc < D ? Ub[(size_t)r * D + cc] : 0.0f;
    Vc[k] = cc < D ? Vb[(size_t)r * D + cc] : 0.0f;
  }
  for (int y = ty; y < kT; y += kThreads / kT) {  // mirror tile: rows c0+y, cols i0+tx
    const int cc = c0 + y, ii = i0 + tx;
    tr[y][tx] = (cc < D && ii < D) ? base(cc, ii) : 0.0f;
  }
  __syncthreads();

  // each thread owns column c0+tx and the 4 contiguous rows i0+4ty..+3, so
  // a factor row r costs two scalar and two float4 shared loads for 8 FMAs
  constexpr int kQ = kT / (kThreads / kT);  // rows per thread (4)
  const int c = c0 + tx;
  const int y0 = kQ * ty;
  float s_ic[kQ], s_ci[kQ];
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int i = i0 + y0 + q;
    s_ic[q] = (i < D && c < D) ? base(i, c) : 0.0f;
    s_ci[q] = tr[tx][y0 + q];
  }
  for (int r = 0; r < K; ++r) {
    const float vc = Vc[r * kT + tx], uc = Uc[r * kT + tx];
    const float4 ui = *reinterpret_cast<const float4*>(Ui + r * kT + y0);
    const float4 vi = *reinterpret_cast<const float4*>(Vi + r * kT + y0);
    s_ic[0] = fmaf(-ui.x, vc, s_ic[0]);
    s_ic[1] = fmaf(-ui.y, vc, s_ic[1]);
    s_ic[2] = fmaf(-ui.z, vc, s_ic[2]);
    s_ic[3] = fmaf(-ui.w, vc, s_ic[3]);
    s_ci[0] = fmaf(-uc, vi.x, s_ci[0]);
    s_ci[1] = fmaf(-uc, vi.y, s_ci[1]);
    s_ci[2] = fmaf(-uc, vi.z, s_ci[2]);
    s_ci[3] = fmaf(-uc, vi.w, s_ci[3]);
  }
  float out[kQ];
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int i = i0 + y0 + q;
    out[q] = 0.5f * (s_ic[q] + s_ci[q]);
    if (i < D && c < D) So[(size_t)i * D + c] = out[q];
  }
  if (ti != tc) {  // the mirror tile, through the shared transpose
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kQ; ++q) tr[tx][y0 + q] = out[q];
    __syncthreads();
    for (int y = ty; y < kT; y += kThreads / kT) {
      const int cc = c0 + y, ii = i0 + tx;
      if (cc < D && ii < D) So[(size_t)cc * D + ii] = tr[y][tx];
    }
  }
}

}  // namespace

extern "C" int slam_downdate_launch(int device, void* stream, int B, int D, int K,
                                    const void* Sigma, const void* U, const void* V,
                                    const void* P, const void* act, void* Sigma_out) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (B < 1 || B > 65535 || D < 6 || K < 1) return (int)cudaErrorInvalidValue;
  const int nt = (D + kT - 1) / kT;
  const size_t smem = 4 * (size_t)K * kT * sizeof(float);
  if (smem > 40 * 1024) {  // past the default, with the static tile beside it
    e = cudaFuncSetAttribute(downdate_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(nt * (nt + 1) / 2, B);
  downdate_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      D, K, nt, (const float*)Sigma, (const float*)U, (const float*)V,
      (const float*)P, (const float*)act, (float*)Sigma_out);
  return (int)cudaGetLastError();
}
