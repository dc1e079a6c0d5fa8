// K1: the whole EKF-SLAM data-association stage of one fleet tick, and K11:
// the fleet's exact assignment on its own.
//
// K1 replaces the TPU kernel smarc_navigation_tpu/ops/slam_da_kernels.py::
// da_lanes (pallas_call at :581, body _make_da_kernel, JV core _jv_lanes).
// Contract: ekf_slam.da_stage + the selection of ekf_slam.da_commit's kernel
// branch, i.e. this package's ops/slam_da_kernels.da_lanes_reference.
//
// One thread block per mission, one thread per landmark slot and one per
// detection (blockDim = L + M rounded up to a warp, at most 384; past that
// a thread walks more items). Per mission, in order:
//   0. one round trip, before the block's first barrier: cp.async stages the
//      pose, the parameters and the detections; each slot thread loads its
//      landmark, its Σ[0:6, lm] slab and Sll into registers; warp 0 turns
//      the pose into R(rpy) and its 27 derivatives (every lane the same
//      straight-line code, lane 0 stores); warps 1-2 stage the pose block,
//      A and R̃ for themselves and compute the (predicted) pose block
//      Spp' = A Spp Aᵀ + R̃, an entry per lane;
//   1. the slot threads: optional predict Spl' = A Spl (Σ_ll is untouched by
//      the predict), the MBES point model h = Rᵀ(lm − p) (or the FLS pixel
//      model chained through the sensor extrinsic), its dim×9 Jacobian in
//      closed form, S = H Σ9 Hᵀ + Q, S⁻¹ and the gated Mahalanobis costs of
//      every detection; the detection threads, at the same time: the
//      back-projected candidate, its H, S⁻¹, ν and its cost row. The (L+M)×M
//      table is stored column-major ([c*R + r]) in shared memory;
//   2. on warp 0: the exact Jonker-Volgenant assignment (jv_regs below),
//      then the capacity-denial prefix, one lane per detection (a ballot
//      prefix count of the detections that want an addition);
//   3. the selection, a thread per (detection, row of H_sel and S⁻¹H) and
//      per detection (ν, cand, col_to_row, do, add, slot).
// Only rows 0:6 of Σ are read for Spp/Spl (Sll comes from the band when it
// is given), so the same kernel takes the marginal fleet's pose rows (B,8,D)
// in place of Σ (B,D,D): the per-mission stride is an argument.
//
// What bounds it on the H100: latency, not bytes or FLOPs. A mission reads
// ~6 KB of Σ slabs at L=64 and the arithmetic is ~100 kFLOP; the serial
// part is the JV, at most M(M+1)/2 Dijkstra steps of one warp. Each step of
// jv_regs reads its column of the table once (conflict-free: column-major),
// keeps every row's dual, slack, predecessor and used flag in the owning
// lane's registers (rows lane + 32k, k < K, K a template parameter) and
// the column duals on lanes 0..C-1, takes the lane's minimum by a tree and
// the warp's with two reductions (__reduce_min_sync: the least slack, then
// the least row holding it), all without branches. Built with -fmad=false
// so the gate and cost arithmetic rounds each product like the plain
// PyTorch version's elementwise ops; every entry is computed in the order
// of the one-block-per-mission kernel this layout replaced, so its outputs
// are that kernel's bit for bit.
//
// K11 replaces smarc_navigation_tpu/ops/slam_da_kernels.py::hungarian_lanes
// (pallas_call at :616, body _make_jv_kernel): the exact JV of an (R, C) cost
// table per mission, one warp per mission on the table staged column-major
// in shared memory by cp.async, the same jv_regs as K1's step 2 (same duals,
// same tie rule as ops/assignment.hungarian: the slack is cost − u[i0] − v[r]
// in that order; on equal slack the lowest row wins, within a lane by keeping
// the first minimum, across lanes by the second reduction). Bound: latency
// of the serial Dijkstra steps; the table is read once.
//
// Any number of rows. The register JV holds at most 32 rows per lane
// (R ≤ kRegRows = 1024). Past that, or where the tables do not fit in the
// block's shared memory, both kernels take their SCRATCH form (a template
// parameter chosen at launch from the shape, never by a retry; a launcher's
// force_scratch takes it at any shape, to hold the two forms against each
// other): jv_scratch
// keeps every row's dual, slack, predecessor and used flag in a per-mission
// device scratch buffer, and K1 its L- and R-sized tables (H, S⁻¹, ĥ, the
// cost table, the candidates, p) there too, K11 its column-major table.
// jv_scratch does the register form's arithmetic per entry in the same order
// and keeps its tie rule (a lane scans its rows upwards and keeps the first
// least slack), so the two forms give the same bits wherever both can run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kFlsScale = 400.0f / 17.0f;  // px per metre
constexpr float kInf = 1e30f;
constexpr int kMaxThreads = 384;
constexpr int kRegRows = 1024;  // the register JV's rows: 32 lanes × at most 32 each
constexpr unsigned kFull = 0xffffffffu;

// Point Jacobian column c of the 3x9 [Hp | Ha | Hl] for a base-frame point
// with map offset diff: Hp = -Rᵀ, Ha[i][k] = Σ_j dR[k][j][i] diff[j], Hl = Rᵀ.
__device__ inline void point_model(const float* R, const float* dR,
                                   const float diff[3], float zh[3],
                                   float Hpt[3][9]) {
  for (int i = 0; i < 3; ++i) {
    zh[i] = R[0 * 3 + i] * diff[0] + R[1 * 3 + i] * diff[1] + R[2 * 3 + i] * diff[2];
    for (int k = 0; k < 3; ++k) {
      const float* d = dR + k * 9;
      Hpt[i][3 + k] = d[0 * 3 + i] * diff[0] + d[1 * 3 + i] * diff[1] +
                      d[2 * 3 + i] * diff[2];
    }
    for (int c = 0; c < 3; ++c) {
      Hpt[i][c] = -R[c * 3 + i];
      Hpt[i][6 + c] = R[c * 3 + i];
    }
  }
}

// FLS chain: v = R_fls_base·h + t, z = s·(‖(v0, v2)‖, −v1); H rows are the
// point Jacobian rows weighted by h₂·R_fls_base at v.
__device__ inline void fls_model(const float* par, const float zh3[3],
                                 float Hpt[3][9], float zh[2],
                                 float H[2][9]) {
  const float* rsb = par + 9;
  const float* tsb = par + 18;
  float v[3];
  for (int i = 0; i < 3; ++i)
    v[i] = rsb[i * 3 + 0] * zh3[0] + rsb[i * 3 + 1] * zh3[1] +
           rsb[i * 3 + 2] * zh3[2] + tsb[i];
  const float n = sqrtf(v[0] * v[0] + v[2] * v[2] + 1e-12f);
  const float inv_n = 1.0f / n;
  zh[0] = kFlsScale * n;
  zh[1] = -kFlsScale * v[1];
  float w0[3], w1[3];
  for (int j = 0; j < 3; ++j) {
    w0[j] = kFlsScale * (v[0] * rsb[0 * 3 + j] + v[2] * rsb[2 * 3 + j]) * inv_n;
    w1[j] = -kFlsScale * rsb[1 * 3 + j];
  }
  for (int c = 0; c < 9; ++c) {
    H[0][c] = w0[0] * Hpt[0][c] + w0[1] * Hpt[1][c] + w0[2] * Hpt[2][c];
    H[1][c] = w1[0] * Hpt[0][c] + w1[1] * Hpt[1][c] + w1[2] * Hpt[2][c];
  }
}

template <int DIM>
__device__ inline void inv_sym(float S[DIM][DIM], float Si[DIM][DIM]) {
  if constexpr (DIM == 2) {
    const float det = S[0][0] * S[1][1] - S[0][1] * S[0][1];
    const float inv_det = 1.0f / det;
    Si[0][0] = S[1][1] * inv_det;
    Si[0][1] = -S[0][1] * inv_det;
    Si[1][0] = Si[0][1];
    Si[1][1] = S[0][0] * inv_det;
  } else {
    const float c00 = S[1][1] * S[2][2] - S[1][2] * S[1][2];
    const float c01 = S[0][2] * S[1][2] - S[0][1] * S[2][2];
    const float c02 = S[0][1] * S[1][2] - S[0][2] * S[1][1];
    const float det = S[0][0] * c00 + S[0][1] * c01 + S[0][2] * c02;
    const float inv_det = 1.0f / det;
    Si[0][0] = c00 * inv_det;
    Si[0][1] = c01 * inv_det;
    Si[0][2] = c02 * inv_det;
    Si[1][1] = (S[0][0] * S[2][2] - S[0][2] * S[0][2]) * inv_det;
    Si[1][2] = (S[0][1] * S[0][2] - S[0][0] * S[1][2]) * inv_det;
    Si[2][2] = (S[0][0] * S[1][1] - S[0][1] * S[0][1]) * inv_det;
    Si[1][0] = Si[0][1];
    Si[2][0] = Si[0][2];
    Si[2][1] = Si[1][2];
  }
}

// S = H Σ9 Hᵀ + diag(q) for Σ9 given entry-wise by sig9(c, d).
template <int DIM, typename Sig9>
__device__ inline void innovation(float H[DIM][9], Sig9 sig9,
                                  const float* q, float S[DIM][DIM]) {
  float W[DIM][9];
  for (int a = 0; a < DIM; ++a)
    for (int d = 0; d < 9; ++d) {
      float acc = 0.0f;
      for (int c = 0; c < 9; ++c) acc += H[a][c] * sig9(c, d);
      W[a][d] = acc;
    }
  for (int a = 0; a < DIM; ++a)
    for (int b = a; b < DIM; ++b) {
      float acc = 0.0f;
      for (int d = 0; d < 9; ++d) acc += W[a][d] * H[b][d];
      if (a == b) acc += q[a];
      S[a][b] = acc;
      S[b][a] = acc;
    }
}

__device__ inline void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ inline void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// Exact JV over the column-major (R, C) table cost[c*R + r] by one warp.
// Lane `lane` owns rows lane + 32k (k < K) and keeps their potentials v,
// slacks minv, predecessors way and used flags in registers. With UREG
// (C ≤ 32) lane c also keeps the column potential u[c] in a register and
// u[i0] is a shuffle; otherwise u lives in shared memory. The assignment p
// (row -> column, R+1 entries with the virtual root at R) is in shared
// memory; on return p[r] is row r's column (-1: free). Every step reads the
// lane's K costs of column i0 at once and is branch-free up to the argmin.
template <int K, bool UREG>
__device__ void jv_regs(const float* cost, int R, int C, float* u, int* p) {
  const int lane = threadIdx.x & 31;
  float v[K];
  int roff[K];            // the lane's rows, clamped into the table
  unsigned invalid = 0u;  // rows past R count as used forever
#pragma unroll
  for (int k = 0; k < K; ++k) {
    v[k] = 0.0f;
    const int r = lane + 32 * k;
    roff[k] = r < R ? r : R - 1;
    if (r >= R) invalid |= 1u << k;
  }
  float ureg = 0.0f;  // UREG: u[lane]
  if (!UREG)
    for (int c = lane; c < C; c += 32) u[c] = 0.0f;
  for (int r = lane; r <= R; r += 32) p[r] = -1;
  __syncwarp();
  for (int c = 0; c < C; ++c) {
    float minv[K];
    int way[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      minv[k] = kInf;
      way[k] = R;
    }
    unsigned used = invalid;
    // columns on used rows (and the root's c): UREG lane c's own flag, else
    // bit q for column lane + 32q
    unsigned cused = UREG ? (lane == c ? 1u : 0u) : (lane == (c & 31) ? 1u << (c >> 5) : 0u);
    if (lane == 0) p[R] = c;
    int j0 = R, i0 = c;
    for (int step = 0; step < R; ++step) {  // each step uses a new row
      const float ui0 = UREG ? __shfl_sync(kFull, ureg, i0) : u[i0];
      const float* col = cost + (size_t)i0 * R;
      float x[K];
#pragma unroll
      for (int k = 0; k < K; ++k) x[k] = col[roff[k]];
      float bv[K];
      int bk[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const bool un = !((used >> k) & 1u);
        const float cur = x[k] - ui0 - v[k];
        const bool better = un && cur < minv[k];
        minv[k] = better ? cur : minv[k];
        way[k] = better ? j0 : way[k];
        bv[k] = un ? minv[k] : 3.0e38f;  // above every slack (unused rows hold < 1e30)
        bk[k] = k;
      }
      // the lane's least slack, the first (lowest row) on a tie
#pragma unroll
      for (int st = 1; st < K; st *= 2)
#pragma unroll
        for (int k = 0; k + st < K; k += 2 * st)
          if (bv[k + st] < bv[k]) {
            bv[k] = bv[k + st];
            bk[k] = bk[k + st];
          }
      // warp argmin: the least slack (−0 and +0 are one key), then the
      // least row index among the lanes that hold it
      const float bz = bv[0] == 0.0f ? 0.0f : bv[0];
      const unsigned bits = __float_as_uint(bz);
      const unsigned key = (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
      const unsigned kmin = __reduce_min_sync(kFull, key);
      const unsigned mine = (unsigned)(lane + 32 * bk[0]);
      const int j1 = (int)__reduce_min_sync(kFull, key == kmin ? mine : 0xffffffffu);
      const float delta = __uint_as_float((kmin & 0x80000000u) ? (kmin & 0x7fffffffu) : ~kmin);
      // dual update: used rows' columns gain delta, used rows' potentials
      // drop, unused slacks shrink
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const bool us = (used >> k) & 1u;
        v[k] = us ? v[k] - delta : v[k];
        minv[k] = us ? minv[k] : minv[k] - delta;
      }
      if (UREG) {
        ureg = cused ? ureg + delta : ureg;
      } else {
        for (int q = 0; lane + 32 * q < C; ++q)
          if ((cused >> q) & 1u) u[lane + 32 * q] += delta;
      }
      used |= lane == (j1 & 31) ? 1u << (j1 >> 5) : 0u;
      const int pj1 = p[j1];
      j0 = j1;
      if (pj1 < 0) break;  // reached a free row
      if (UREG)
        cused |= lane == pj1 ? 1u : 0u;
      else
        cused |= lane == (pj1 & 31) ? 1u << (pj1 >> 5) : 0u;
      i0 = pj1;
      if (!UREG) __syncwarp();  // u's update before the next step reads u[i0]
    }
    // augment along the predecessor chain to the root (way from its lane)
    int j = j0;
    for (int hop = 0; j != R && hop < R; ++hop) {
      const int kj = j >> 5;
      int w = R;
#pragma unroll
      for (int k = 0; k < K; ++k) w = k == kj ? way[k] : w;
      const int j1 = __shfl_sync(kFull, w, j & 31);
      if (lane == 0) p[j] = p[j1];
      j = j1;
    }
    if (lane == 0) p[R] = -1;
    __syncwarp();
  }
  if (UREG && lane < C) u[lane] = ureg;
}

// jv_regs with the fewest rows per lane that hold R (R ≤ kRegRows); u in
// registers when C ≤ 32.
__device__ void jv_warp(const float* cost, int R, int C, float* u, int* p) {
  if (C > 32) {
    jv_regs<32, false>(cost, R, C, u, p);
    return;
  }
  switch ((R + 31) / 32) {
    case 1: jv_regs<1, true>(cost, R, C, u, p); break;
    case 2: jv_regs<2, true>(cost, R, C, u, p); break;
    case 3: jv_regs<3, true>(cost, R, C, u, p); break;
    case 4: jv_regs<4, true>(cost, R, C, u, p); break;
    case 5: jv_regs<5, true>(cost, R, C, u, p); break;
    case 6: jv_regs<6, true>(cost, R, C, u, p); break;
    case 7: jv_regs<7, true>(cost, R, C, u, p); break;
    case 8: jv_regs<8, true>(cost, R, C, u, p); break;
    case 9: jv_regs<9, true>(cost, R, C, u, p); break;
    case 10: case 11: case 12: case 13: case 14: case 15: case 16:
      jv_regs<16, true>(cost, R, C, u, p); break;
    default: jv_regs<32, true>(cost, R, C, u, p); break;
  }
}

// jv_regs with every row's state in device memory (any R): ws holds the
// row duals v, the slacks minv, the predecessors way and the used flags, 4R
// words; row r is read and written only by lane r % 32, like its registers in
// jv_regs. Per step each lane scans its rows upwards and keeps the first
// least slack (jv_regs' tree keeps the same one), the warp reductions, the
// dual update and the augmentation are jv_regs', so every entry gets the same
// operations in the same order. The column duals u are in memory; a used
// row's lane adds delta to its column's dual (each column is held by at most
// one row), lane 0 to the root's column c.
__device__ void jv_scratch(const float* cost, int R, int C, float* u, int* p, float* ws) {
  const int lane = threadIdx.x & 31;
  float* v = ws;
  float* minv = ws + R;
  int* way = reinterpret_cast<int*>(ws + 2 * (size_t)R);
  int* used = way + R;
  for (int r = lane; r < R; r += 32) v[r] = 0.0f;
  for (int c = lane; c < C; c += 32) u[c] = 0.0f;
  for (int r = lane; r <= R; r += 32) p[r] = -1;
  __syncwarp();
  for (int c = 0; c < C; ++c) {
    for (int r = lane; r < R; r += 32) {
      minv[r] = kInf;
      way[r] = R;
      used[r] = 0;
    }
    if (lane == 0) p[R] = c;
    int j0 = R, i0 = c;
    for (int step = 0; step < R; ++step) {  // each step uses a new row
      const float ui0 = u[i0];
      const float* col = cost + (size_t)i0 * R;
      float best = 3.0e38f;  // above every slack (unused rows hold < 1e30)
      int brow = lane;
      for (int r = lane; r < R; r += 32) {
        if (used[r]) continue;
        const float cur = col[r] - ui0 - v[r];
        float mv = minv[r];
        if (cur < mv) {
          mv = cur;
          minv[r] = cur;
          way[r] = j0;
        }
        if (mv < best) {
          best = mv;
          brow = r;
        }
      }
      const float bz = best == 0.0f ? 0.0f : best;
      const unsigned bits = __float_as_uint(bz);
      const unsigned key = (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
      const unsigned kmin = __reduce_min_sync(kFull, key);
      const int j1 = (int)__reduce_min_sync(kFull, key == kmin ? (unsigned)brow : 0xffffffffu);
      const float delta = __uint_as_float((kmin & 0x80000000u) ? (kmin & 0x7fffffffu) : ~kmin);
      for (int r = lane; r < R; r += 32) {
        if (used[r]) {
          v[r] = v[r] - delta;
          u[p[r]] += delta;
        } else {
          minv[r] = minv[r] - delta;
        }
      }
      if (lane == 0) u[c] += delta;
      if (lane == (j1 & 31)) used[j1] = 1;
      const int pj1 = p[j1];
      j0 = j1;
      if (pj1 < 0) break;  // reached a free row
      i0 = pj1;
      __syncwarp();  // u's update before the next step reads u[i0]
    }
    __syncwarp();
    if (lane == 0) {  // augment along the predecessor chain to the root
      int j = j0;
      for (int hop = 0; j != R && hop < R; ++hop) {
        const int j1 = way[j];
        p[j] = p[j1];
        j = j1;
      }
      p[R] = -1;
    }
    __syncwarp();
  }
}

// par layout (32 floats): [q0,q1,q2, lam, outlier, mh_dist, nl0,nl1,nl2,
//                          rsb00..rsb22 (9-17), tsb0..2 (18-20)]
struct Shared {
  float* pose;   // 6
  float* par;    // 32
  float* R;      // 9   rotation R(rpy)
  float* dR;     // 27  dR/d(roll,pitch,yaw) [k][i][j]
  float* A;      // 36  motion Jacobian (predict)
  float* Rf;     // 36  R̃ (predict)
  float* Sraw;   // 36  Σ[0:6, 0:6] as read
  float* st2;    // 108 the same three, warp 2's copy
  float* Spp;    // 36  (predicted) pose block
  float* z;      // M*3
  float* H;      // L*dim*9
  float* Si;     // L*dim*dim
  float* zh;     // L*dim
  float* cost;   // (L+M)*M, column-major [c*R + r]
  float* Hc;     // M*dim*9
  float* Sic;    // M*dim*dim
  float* nuc;    // M*dim
  float* cand;   // M*3
  float* u;      // M
  int* p;        // R+1
  int* zm;       // M
  int* ctr;      // M: assigned row
  int* slot;     // M
  int* flags;    // M: do | add << 1
};

// pose .. z: always in shared memory (cp.async targets)
__host__ __device__ inline size_t small_floats(int M) {
  return 6 + 32 + 9 + 27 + 7 * 36 + (size_t)M * 3;
}

// H .. flags: in shared memory after the small part, or in the SCRATCH form
// in the mission's device scratch
__host__ __device__ inline size_t table_floats(int L, int M, int dim) {
  const int R = L + M;
  return (size_t)L * (dim * 9 + dim * dim + dim) + (size_t)R * M +
         (size_t)M * (dim * 9 + dim * dim + dim + 3) + M + (R + 1) + 4 * (size_t)M;
}

__device__ inline Shared carve(float* f, float* t, int L, int M, int dim) {
  Shared s;
  const int R = L + M;
  s.pose = f; f += 6;
  s.par = f; f += 32;
  s.R = f; f += 9;
  s.dR = f; f += 27;
  s.A = f; f += 36;
  s.Rf = f; f += 36;
  s.Sraw = f; f += 36;
  s.st2 = f; f += 108;
  s.Spp = f; f += 36;
  s.z = f;
  f = t;
  s.H = f; f += L * dim * 9;
  s.Si = f; f += L * dim * dim;
  s.zh = f; f += L * dim;
  s.cost = f; f += R * M;
  s.Hc = f; f += M * dim * 9;
  s.Sic = f; f += M * dim * dim;
  s.nuc = f; f += M * dim;
  s.cand = f; f += M * 3;
  s.u = f; f += M;
  int* i = reinterpret_cast<int*>(f);
  s.p = i; i += R + 1;
  s.zm = i; i += M;
  s.ctr = i; i += M;
  s.slot = i; i += M;
  s.flags = i;
  return s;
}

// R(rpy) and its 27 derivatives, in the expressions of the reference's
// closed form, by one whole warp: lanes 0-5 take one sine or cosine each,
// every lane forms the entries from the shuffled six (no divergence), lane 0
// stores them.
__device__ inline void rotation(const float* pose, float* R, float* dR) {
  const int lane = threadIdx.x & 31;
  const float ang = pose[3 + (lane < 6 ? lane >> 1 : 0)];
  const float sc = (lane & 1) ? cosf(ang) : sinf(ang);  // lane 2k: sin, 2k+1: cos of angle k
  const float sr = __shfl_sync(kFull, sc, 0), cr = __shfl_sync(kFull, sc, 1);
  const float sp = __shfl_sync(kFull, sc, 2), cp = __shfl_sync(kFull, sc, 3);
  const float sy = __shfl_sync(kFull, sc, 4), cy = __shfl_sync(kFull, sc, 5);
  const float Rm[9] = {cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr,
                       sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr,
                       -sp,     cp * sr,                cp * cr};
  const float dRm[27] = {
      // d/droll
      0.0f, cy * sp * cr + sy * sr, -cy * sp * sr + sy * cr,
      0.0f, sy * sp * cr - cy * sr, -sy * sp * sr - cy * cr,
      0.0f, cp * cr, -cp * sr,
      // d/dpitch
      -cy * sp, cy * cp * sr, cy * cp * cr,
      -sy * sp, sy * cp * sr, sy * cp * cr,
      -cp, -sp * sr, -sp * cr,
      // d/dyaw
      -sy * cp, -sy * sp * sr - cy * cr, -sy * sp * cr + cy * sr,
      cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr,
      0.0f, 0.0f, 0.0f};
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int i = 0; i < 9; ++i) R[i] = Rm[i];
#pragma unroll
    for (int i = 0; i < 27; ++i) dR[i] = dRm[i];
  }
}

// One landmark slot's inputs, loaded before the staging barrier.
struct SlotIn {
  float lm[3];
  float spl[6][3];  // Σ[0:6, lc:lc+3] as read
  float sll[3][3];
  bool act;
};

__device__ inline void load_slot(SlotIn& in, int b, int l, int L, int D, int use_band,
                                 const float* Sg, const bool* active, const float* lm_pos,
                                 const float* band) {
  const float* lm = lm_pos + ((size_t)b * L + l) * 3;
  for (int a = 0; a < 3; ++a) in.lm[a] = lm[a];
  in.act = active[(size_t)b * L + l];
  const int lc = 6 + 3 * l;
  for (int i = 0; i < 6; ++i)
    for (int k = 0; k < 3; ++k) in.spl[i][k] = Sg[i * D + lc + k];
  for (int a = 0; a < 3; ++a)
    for (int c = 0; c < 3; ++c) {
      if (use_band) {
        const int row = (a < c ? a : c) * 8 + (c > a ? c - a : a - c);
        in.sll[a][c] = band[((size_t)b * 24 + row) * L + l];
      } else {
        in.sll[a][c] = Sg[(lc + a) * D + lc + c];
      }
    }
}

// Correspondence of slot l against every detection: H, S⁻¹, ĥ into shared
// memory, the slot's row of the cost table.
template <bool FLS, bool PREDICT>
__device__ inline void slot_costs(const SlotIn& in, int l, int L, int M, const Shared& s) {
  constexpr int DIM = FLS ? 2 : 3;
  const int R = L + M;
  const float* par = s.par;
  const float diff[3] = {in.lm[0] - s.pose[0], in.lm[1] - s.pose[1], in.lm[2] - s.pose[2]};
  float zh3[3], Hpt[3][9];
  point_model(s.R, s.dR, diff, zh3, Hpt);
  float zh[DIM], H[DIM][9];
  if constexpr (FLS) {
    fls_model(par, zh3, Hpt, zh, H);
  } else {
    for (int i = 0; i < DIM; ++i) {
      zh[i] = zh3[i];
      for (int c = 0; c < 9; ++c) H[i][c] = Hpt[i][c];
    }
  }
  float Spl[6][3];  // Σ[0:6, lm] (predicted: A Σ[0:6, lm])
  for (int i = 0; i < 6; ++i)
    for (int k = 0; k < 3; ++k) {
      if (PREDICT) {
        float acc = 0.0f;
        for (int j = 0; j < 6; ++j) acc += s.A[i * 6 + j] * in.spl[j][k];
        Spl[i][k] = acc;
      } else {
        Spl[i][k] = in.spl[i][k];
      }
    }
  const float* Spp = s.Spp;
  auto sig9 = [&](int c, int d) -> float {
    if (c < 6 && d < 6) return Spp[c * 6 + d];
    if (c < 6) return Spl[c][d - 6];
    if (d < 6) return Spl[d][c - 6];
    return in.sll[c - 6][d - 6];
  };
  float S[DIM][DIM], Si[DIM][DIM];
  innovation<DIM>(H, sig9, par, S);
  inv_sym<DIM>(S, Si);
  for (int a = 0; a < DIM; ++a) {
    s.zh[l * DIM + a] = zh[a];
    for (int c = 0; c < 9; ++c) s.H[(l * DIM + a) * 9 + c] = H[a][c];
    for (int c = 0; c < DIM; ++c) s.Si[(l * DIM + a) * DIM + c] = Si[a][c];
  }
  const float lam = par[3], outl = par[4];
  for (int m = 0; m < M; ++m) {
    float nu[DIM];
    for (int a = 0; a < DIM; ++a) nu[a] = s.z[m * 3 + a] - zh[a];
    float dm = 0.0f;
    for (int a = 0; a < DIM; ++a)
      for (int c = 0; c < DIM; ++c) dm += nu[a] * Si[a][c] * nu[c];
    const bool gate = (dm < lam) && in.act && s.zm[m];
    s.cost[m * R + l] = gate ? dm : outl;
  }
}

// Detection m's new-landmark candidate: back-projection, its H, S⁻¹, ν and
// its cost row (mh_dist on its own column, outlier elsewhere).
template <bool FLS>
__device__ inline void candidate(int m, int L, int M, const Shared& s) {
  constexpr int DIM = FLS ? 2 : 3;
  const int R = L + M;
  const float* par = s.par;
  const float* pose = s.pose;
  const float* zm = s.z + m * 3;
  float cm[3];
  if constexpr (FLS) {  // pixels -> FLS-frame point s⁻¹·(z0, −z1, 0) -> base -> map
    const float* rsb = par + 9;
    const float* tsb = par + 18;
    const float pf[3] = {zm[0] / kFlsScale, -zm[1] / kFlsScale, 0.0f};
    float pb[3];
    for (int a = 0; a < 3; ++a)
      pb[a] = rsb[0 * 3 + a] * (pf[0] - tsb[0]) + rsb[1 * 3 + a] * (pf[1] - tsb[1]) +
              rsb[2 * 3 + a] * (pf[2] - tsb[2]);
    for (int a = 0; a < 3; ++a)
      cm[a] = s.R[a * 3 + 0] * pb[0] + s.R[a * 3 + 1] * pb[1] +
              s.R[a * 3 + 2] * pb[2] + pose[a];
  } else {
    for (int a = 0; a < 3; ++a)
      cm[a] = s.R[a * 3 + 0] * zm[0] + s.R[a * 3 + 1] * zm[1] +
              s.R[a * 3 + 2] * zm[2] + pose[a];
  }
  const float diff[3] = {cm[0] - pose[0], cm[1] - pose[1], cm[2] - pose[2]};
  float zh3[3], Hpt[3][9];
  point_model(s.R, s.dR, diff, zh3, Hpt);
  float zh[DIM], H[DIM][9];
  if constexpr (FLS) {
    fls_model(par, zh3, Hpt, zh, H);
  } else {
    for (int i = 0; i < DIM; ++i) {
      zh[i] = zh3[i];
      for (int c = 0; c < 9; ++c) H[i][c] = Hpt[i][c];
    }
  }
  const float* Spp = s.Spp;
  const float* nl = par + 6;
  auto sig9c = [&](int c, int d) -> float {
    if (c < 6 && d < 6) return Spp[c * 6 + d];
    if (c >= 6 && c == d) return nl[c - 6];
    return 0.0f;
  };
  float S[DIM][DIM], Si[DIM][DIM];
  innovation<DIM>(H, sig9c, par, S);
  inv_sym<DIM>(S, Si);
  for (int a = 0; a < DIM; ++a) {
    s.nuc[m * DIM + a] = zm[a] - zh[a];
    for (int c = 0; c < 9; ++c) s.Hc[(m * DIM + a) * 9 + c] = H[a][c];
    for (int c = 0; c < DIM; ++c) s.Sic[(m * DIM + a) * DIM + c] = Si[a][c];
  }
  for (int a = 0; a < 3; ++a) s.cand[m * 3 + a] = cm[a];
  const float mh = par[5], outl = par[4];
  for (int c = 0; c < M; ++c) s.cost[c * R + L + m] = (c == m) ? mh : outl;
}

template <bool FLS, bool PREDICT, bool SCRATCH>
__global__ void __launch_bounds__(kMaxThreads)
da_kernel(int L, int M, int D, long long sig_stride, int use_band,
          float* __restrict__ scratch, long long scratch_stride,
          const float* __restrict__ pose6, const int* __restrict__ n_active,
          const bool* __restrict__ active, const float* __restrict__ lm_pos,
          const float* __restrict__ Sigma, const float* __restrict__ z,
          const bool* __restrict__ z_mask, const float* __restrict__ par,
          const float* __restrict__ A, const float* __restrict__ r_full,
          const float* __restrict__ band,
          int* __restrict__ ctr_out, float* __restrict__ H_sel,
          float* __restrict__ SinvH, float* __restrict__ nu_sel,
          float* __restrict__ cand_out, bool* __restrict__ do_out,
          bool* __restrict__ add_out, int* __restrict__ slot_out) {
  constexpr int DIM = FLS ? 2 : 3;
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  float* mine = SCRATCH ? scratch + (size_t)b * scratch_stride : nullptr;
  Shared s = carve(smem, SCRATCH ? mine : smem + small_floats(M), L, M, DIM);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int R = L + M;
  const float* Sg = Sigma + (size_t)b * sig_stride;  // row stride D either way

  // --- 0. one round trip: the shared inputs by cp.async, each slot's own in
  // registers; warp 0 turns the pose into R and dR, warps 1-2 the pose
  // block into Spp' = A (Spp Aᵀ) + R̃
  const int n_act = tid < 32 ? n_active[b] : 0;  // for the prefix, read early
  SlotIn in;
  if (tid < L) load_slot(in, b, tid, L, D, use_band, Sg, active, lm_pos, band);
  for (int e = tid; e < 32; e += nt) cp_async4(&s.par[e], par + e);
  for (int e = tid; e < 6; e += nt) cp_async4(&s.pose[e], pose6 + (size_t)b * 6 + e);
  for (int e = tid; e < M * 3; e += nt) cp_async4(&s.z[e], z + (size_t)b * M * 3 + e);
  for (int e = tid; e < M; e += nt) s.zm[e] = z_mask[(size_t)b * M + e] ? 1 : 0;
  if (tid < 32) rotation(pose6 + (size_t)b * 6, s.R, s.dR);
  // Spp' on warps 1-2 (warp 1 alone below 65 threads, warp 0 in a one-warp
  // block), each staging its own copy of the pose block, A and R̃
  const int nsw = nt > 64 ? 2 : 1, sw0 = nt > 32 ? 1 : 0, q = (tid >> 5) - sw0;
  if (q >= 0 && q < nsw) {
    const int lane = tid & 31;
    float* Sr = q ? s.st2 : s.Sraw;
    float* Aw = q ? s.st2 + 36 : s.A;
    float* Rw = q ? s.st2 + 72 : s.Rf;
    for (int e = lane; e < 36; e += 32) {
      cp_async4(&Sr[e], Sg + (e / 6) * D + e % 6);
      if (PREDICT) {
        cp_async4(&Aw[e], A + (size_t)b * 36 + e);
        cp_async4(&Rw[e], r_full + (size_t)b * 36 + e);
      }
    }
    cp_async_wait_all();
    __syncwarp();
    for (int e = 32 * q + lane; e < 36; e += 32 * nsw) {
      if (PREDICT) {  // Spp' = A (Spp Aᵀ) + R̃, entry (i, j) whole
        const int i = e / 6, j = e % 6;
        float tmp[6];  // (Spp Aᵀ)[k][j]
        for (int k = 0; k < 6; ++k) {
          float acc = 0.0f;
          for (int l = 0; l < 6; ++l) acc += Sr[k * 6 + l] * Aw[j * 6 + l];
          tmp[k] = acc;
        }
        float acc = 0.0f;
        for (int k = 0; k < 6; ++k) acc += Aw[i * 6 + k] * tmp[k];
        s.Spp[e] = acc + Rw[e];
      } else {
        s.Spp[e] = Sr[e];
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // --- 1. every slot and every detection's candidate --------------------------
  for (int it = tid; it < R; it += nt) {
    if (it < L) {
      if (it != tid) load_slot(in, b, it, L, D, use_band, Sg, active, lm_pos, band);
      slot_costs<FLS, PREDICT>(in, it, L, M, s);
    } else {
      candidate<FLS>(it - L, L, M, s);
    }
  }
  __syncthreads();

  // --- 2. exact assignment and the capacity-denial prefix, on warp 0 ----------
  if (tid < 32) {
    if (SCRATCH)
      jv_scratch(s.cost, R, M, s.u, s.p, mine + table_floats(L, M, DIM));
    else
      jv_warp(s.cost, R, M, s.u, s.p);
    for (int r = tid; r < R; r += 32)
      if (s.p[r] >= 0) s.ctr[s.p[r]] = r;
    __syncwarp();
    // additions are granted in detection order while n_act + cum < L: a
    // ballot prefix count of the detections that want one
    int cum = 0;  // additions granted before this chunk of 32 detections
    for (int m0 = 0; m0 < M; m0 += 32) {
      const int m = m0 + tid;
      const bool here = m < M;
      const int r = here ? s.ctr[m] : 0;
      const bool is_new = r >= L;
      const bool mb = here && s.zm[m];
      const unsigned lt = (1u << tid) - 1u;
      const unsigned wants = __ballot_sync(kFull, mb && is_new);
      const bool can_add = mb && is_new && (n_act + cum + __popc(wants & lt) < L);
      const unsigned granted = __ballot_sync(kFull, can_add);
      if (here) {
        s.slot[m] = is_new ? n_act + cum + __popc(granted & lt) : (r < L - 1 ? r : L - 1);
        s.flags[m] = (mb && (can_add || !is_new) ? 1 : 0) | (can_add ? 2 : 0);
      }
      cum += __popc(granted);
    }
  }
  __syncthreads();

  // --- 3. the selection: a thread per (detection, row of H) and per detection
  for (int t = tid; t < M * DIM + M; t += nt) {
    const int m = t < M * DIM ? t / DIM : t - M * DIM;
    const int r = s.ctr[m];
    const bool is_new = r >= L;
    const int rc = r < L - 1 ? r : L - 1;
    const size_t o = (size_t)b * M + m;
    if (t < M * DIM) {  // row a of H_sel and S⁻¹H
      const int a = t % DIM;
      const float* Hs = is_new ? s.Hc + m * DIM * 9 : s.H + rc * DIM * 9;
      const float* Ss = is_new ? s.Sic + m * DIM * DIM : s.Si + rc * DIM * DIM;
      for (int c = 0; c < 9; ++c) {
        float acc = 0.0f;
        for (int k = 0; k < DIM; ++k) acc += Ss[a * DIM + k] * Hs[k * 9 + c];
        H_sel[(o * DIM + a) * 9 + c] = Hs[a * 9 + c];
        SinvH[(o * DIM + a) * 9 + c] = acc;
      }
    } else {  // ν, cand and the discrete outputs
      for (int a = 0; a < DIM; ++a)
        nu_sel[o * DIM + a] = is_new ? s.nuc[m * DIM + a] : s.z[m * 3 + a] - s.zh[rc * DIM + a];
      for (int a = 0; a < 3; ++a) cand_out[o * 3 + a] = s.cand[m * 3 + a];
      ctr_out[o] = r;
      slot_out[o] = s.slot[m];
      do_out[o] = (s.flags[m] & 1) != 0;
      add_out[o] = (s.flags[m] & 2) != 0;
    }
  }
}

// The opt-in shared memory of a block on `device` (cached per device).
int max_shared(int device) {
  static int cache[64] = {0};
  if (device < 0 || device >= 64) return 48 * 1024;
  if (cache[device] == 0) {
    int v = 0;
    if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) != cudaSuccess)
      return 48 * 1024;
    cache[device] = v;
  }
  return cache[device];
}

// K1's form from its shape: 0 = the register JV with the tables in shared
// memory, else the SCRATCH form's device scratch per mission (floats): the
// tables, then the JV's 4R row words.
long long da_scratch_floats(int device, int L, int M, int dim, bool force) {
  const int R = L + M;
  const size_t smem = (small_floats(M) + table_floats(L, M, dim)) * sizeof(float);
  if (!force && R <= kRegRows && smem <= (size_t)max_shared(device)) return 0;
  return (long long)(table_floats(L, M, dim) + 4 * (size_t)R);
}

// K11's: the column-major table, u, p, the columns' rows, then 4R row words.
long long jv_scratch_floats(int device, int R, int C, bool force) {
  const size_t smem = ((size_t)R * C + C) * sizeof(float) + (R + 1 + (size_t)C) * sizeof(int);
  if (!force && R <= kRegRows && smem <= (size_t)max_shared(device)) return 0;
  return (long long)((size_t)R * C + C + (R + 1) + C + 4 * (size_t)R);
}

template <bool FLS, bool PREDICT, bool SCRATCH>
cudaError_t launch(int B, int L, int M, int D, long long sig_stride, int use_band,
                   float* scratch, long long scratch_stride, cudaStream_t stream,
                   const float* pose6, const int* n_active, const bool* active,
                   const float* lm_pos, const float* Sigma, const float* z,
                   const bool* z_mask, const float* par, const float* A,
                   const float* r_full, const float* band, int* ctr, float* H_sel,
                   float* SinvH, float* nu_sel, float* cand, bool* do_out,
                   bool* add_out, int* slot) {
  const size_t smem = (small_floats(M) + (SCRATCH ? 0 : table_floats(L, M, FLS ? 2 : 3))) *
                     sizeof(float);
  auto kern = da_kernel<FLS, PREDICT, SCRATCH>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int threads = ((L + M + 31) / 32) * 32;
  kern<<<B, threads < kMaxThreads ? threads : kMaxThreads, smem, stream>>>(
      L, M, D, sig_stride, use_band, scratch, scratch_stride, pose6, n_active, active, lm_pos, Sigma, z, z_mask,
      par, A, r_full, band, ctr, H_sel, SinvH, nu_sel, cand, do_out, add_out, slot);
  return cudaGetLastError();
}

// K11: one warp per mission solves its (R, C) table (row-major in device
// memory, [r*C + c]; staged column-major, into shared memory or, in the
// SCRATCH form, into the mission's device scratch).
template <bool SCRATCH>
__global__ void __launch_bounds__(32)
jv_kernel(int R, int C, const float* __restrict__ cost, int* __restrict__ col_to_row,
          float* __restrict__ scratch, long long scratch_stride) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  float* tab = SCRATCH ? scratch + (size_t)b * scratch_stride : smem;  // R*C, [c*R + r]
  float* u = tab + (size_t)R * C;    // C
  int* p = reinterpret_cast<int*>(u + C);  // R+1
  int* ctr = p + R + 1;              // C
  const float* cb = cost + (size_t)b * R * C;
  for (int k = lane; k < R * C; k += 32) {
    float* dst = &tab[(size_t)(k % C) * R + k / C];
    if (SCRATCH)
      *dst = cb[k];
    else
      cp_async4(dst, cb + k);
  }
  for (int c = lane; c < C; c += 32) ctr[c] = -1;
  cp_async_wait_all();
  __syncwarp();
  if (SCRATCH)
    jv_scratch(tab, R, C, u, p, reinterpret_cast<float*>(ctr + C));
  else
    jv_warp(tab, R, C, u, p);
  for (int r = lane; r < R; r += 32)
    if (p[r] >= 0) ctr[p[r]] = r;
  __syncwarp();
  for (int c = lane; c < C; c += 32) col_to_row[(size_t)b * C + c] = ctr[c];
}

}  // namespace

// Both launchers return 0 once launched or a cudaError_t (> 0). Where the
// shape (or force_scratch) takes the scratch form and scratch is null, they
// launch nothing and return minus the floats per mission it needs: the
// caller passes B times that many again.
extern "C" long long slam_da_launch(int device, void* stream, int B, int L, int M,
                                    int D, int pose_rows, int fls, int predict,
                                    int use_band, int force_scratch, void* scratch,
                                    const void* pose6, const void* n_active,
                                    const void* active, const void* lm_pos,
                                    const void* Sigma, const void* z,
                                    const void* z_mask, const void* par, const void* A,
                                    const void* r_full, const void* band, void* ctr,
                                    void* H_sel, void* SinvH, void* nu_sel, void* cand,
                                    void* do_out, void* add_out, void* slot) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (B < 1 || L < 1 || M < 1) return (int)cudaErrorInvalidValue;
  if (pose_rows && !use_band) return (int)cudaErrorInvalidValue;  // Sll needs the band
  const long long sig_stride = pose_rows ? 8LL * D : (long long)D * D;
  const long long per = da_scratch_floats(device, L, M, fls ? 2 : 3, force_scratch != 0);
  if (per > 0 && scratch == nullptr) return -per;
  float* scr = (float*)scratch;
  auto st = static_cast<cudaStream_t>(stream);
#define SLAM_DA_ARGS                                                          \
  B, L, M, D, sig_stride, use_band, scr, per, st, (const float*)pose6, (const int*)n_active, \
      (const bool*)active, (const float*)lm_pos, (const float*)Sigma,         \
      (const float*)z, (const bool*)z_mask, (const float*)par,                \
      (const float*)A, (const float*)r_full, (const float*)band, (int*)ctr,   \
      (float*)H_sel, (float*)SinvH, (float*)nu_sel, (float*)cand,             \
      (bool*)do_out, (bool*)add_out, (int*)slot
  if (per > 0) {
    if (fls)
      e = predict ? launch<true, true, true>(SLAM_DA_ARGS) : launch<true, false, true>(SLAM_DA_ARGS);
    else
      e = predict ? launch<false, true, true>(SLAM_DA_ARGS) : launch<false, false, true>(SLAM_DA_ARGS);
  } else if (fls) {
    e = predict ? launch<true, true, false>(SLAM_DA_ARGS) : launch<true, false, false>(SLAM_DA_ARGS);
  } else {
    e = predict ? launch<false, true, false>(SLAM_DA_ARGS) : launch<false, false, false>(SLAM_DA_ARGS);
  }
#undef SLAM_DA_ARGS
  return (int)e;
}

extern "C" long long hungarian_lanes_launch(int device, void* stream, int B, int R, int C,
                                            const void* cost, void* col_to_row, int force_scratch,
                                            void* scratch) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (B < 1 || C < 1 || C > R || (long long)R * C > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const long long per = jv_scratch_floats(device, R, C, force_scratch != 0);
  auto st = static_cast<cudaStream_t>(stream);
  if (per > 0) {
    if (scratch == nullptr) return -per;
    jv_kernel<true><<<B, 32, 0, st>>>(R, C, (const float*)cost, (int*)col_to_row,
                                      (float*)scratch, per);
    return (int)cudaGetLastError();
  }
  const size_t smem = ((size_t)R * C + C) * sizeof(float) + (R + 1 + (size_t)C) * sizeof(int);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(jv_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  jv_kernel<false><<<B, 32, smem, st>>>(R, C, (const float*)cost, (int*)col_to_row, nullptr, 0);
  return (int)cudaGetLastError();
}
