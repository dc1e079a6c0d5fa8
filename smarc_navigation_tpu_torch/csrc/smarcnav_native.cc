// smarcnav_native: host-side native kernels for smarc_navigation_tpu.
//
// The reference keeps its runtime in C++ ROS nodes; in the TPU rebuild the
// compute path is XLA, and the host runtime work that remains — exact
// linear assignment for SLAM data association (the role of the vendored
// Munkres solver, auv_ekf_slam/utils/munkres/) and timeline binning of
// multi-gigabyte recorded sensor logs — lives here, exposed through a plain
// C ABI for ctypes.
//
// Build: g++ -O3 -march=native -shared -fPIC -o libsmarcnav.so smarcnav_native.cc

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Exact Jonker-Volgenant assignment (minimize; assigns every column to a
// distinct row; requires C <= R). col_to_row must hold C ints.
// Same dual-potential shortest-augmenting-path formulation as the in-JAX
// device solver (smarc_navigation_tpu/ops/assignment.py) so both paths make
// identical decisions.
// ---------------------------------------------------------------------------
int jv_assign(const double* cost, int R, int C, int* col_to_row) {
  if (C > R || R <= 0 || C <= 0) return -1;
  const double INF = std::numeric_limits<double>::infinity();

  std::vector<double> u(C + 1, 0.0);   // column potentials (1-based)
  std::vector<double> v(R + 1, 0.0);   // row potentials (1-based; 0 = virtual)
  std::vector<int> p(R + 1, 0);        // p[j]: column (1-based) at row j; 0 free
  std::vector<int> way(R + 1, 0);

  for (int i = 1; i <= C; ++i) {
    p[0] = i;
    int j0 = 0;  // virtual row
    std::vector<double> minv(R + 1, INF);
    std::vector<char> used(R + 1, 0);
    do {
      used[j0] = 1;
      const int i0 = p[j0];
      double delta = INF;
      int j1 = -1;
      for (int j = 1; j <= R; ++j) {
        if (used[j]) continue;
        // cost is (R, C) row-major; row j-1, column i0-1
        const double cur = cost[(size_t)(j - 1) * C + (i0 - 1)] - u[i0] - v[j];
        if (cur < minv[j]) {
          minv[j] = cur;
          way[j] = j0;
        }
        if (minv[j] < delta) {
          delta = minv[j];
          j1 = j;
        }
      }
      if (j1 < 0) return -2;  // infeasible (should not happen for finite costs)
      for (int j = 0; j <= R; ++j) {
        if (used[j]) {
          u[p[j]] += delta;
          v[j] -= delta;
        } else {
          minv[j] -= delta;
        }
      }
      j0 = j1;
    } while (p[j0] != 0);
    // augment along the alternating path
    do {
      const int j1 = way[j0];
      p[j0] = p[j1];
      j0 = j1;
    } while (j0);
  }

  for (int c = 0; c < C; ++c) col_to_row[c] = -1;
  for (int j = 1; j <= R; ++j)
    if (p[j] > 0) col_to_row[p[j] - 1] = j - 1;
  return 0;
}

// Batched variant: costs (B, R, C) row-major -> out (B, C).
int jv_assign_batch(const double* costs, int B, int R, int C, int* out) {
  for (int b = 0; b < B; ++b) {
    const int rc = jv_assign(costs + (size_t)b * R * C, R, C, out + (size_t)b * C);
    if (rc != 0) return rc;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Timeline binning: latest message index per tick (the queue-latest
// semantics of every reference node) over huge stamped logs.
// stamps sorted ascending; out[k] = index of latest stamp <= tick[k], -1.
// ---------------------------------------------------------------------------
void latest_index(const double* stamps, int64_t n_stamps, const double* ticks,
                  int64_t n_ticks, int64_t* out) {
  int64_t j = -1;
  for (int64_t k = 0; k < n_ticks; ++k) {
    const double t = ticks[k];
    while (j + 1 < n_stamps && stamps[j + 1] <= t) ++j;
    out[k] = j;
  }
}

// Event binning: assign each detection burst to the first tick at/after its
// stamp, pack values into a (T, K, D) bank with masks. Returns number of
// dropped detections (slots exhausted).
int64_t bin_events(const double* stamps, const double* values,
                   const int64_t* burst, int64_t n_events, int D,
                   const double* ticks, int64_t T, int K,
                   double* out_values, uint8_t* out_mask) {
  std::memset(out_values, 0, sizeof(double) * (size_t)T * K * D);
  std::memset(out_mask, 0, sizeof(uint8_t) * (size_t)T * K);
  std::vector<int> fill((size_t)T, 0);
  int64_t dropped = 0;
  int64_t t = 0;
  for (int64_t m = 0; m < n_events; ++m) {
    const double s = stamps[m];
    // ticks sorted: advance to first tick >= s (events sorted by stamp)
    if (s < ticks[0]) t = 0;
    while (t < T && ticks[t] < s) ++t;
    if (t >= T) {
      ++dropped;
      continue;
    }
    int& f = fill[(size_t)t];
    if (f >= K) {
      ++dropped;
      continue;
    }
    std::memcpy(out_values + ((size_t)t * K + f) * D, values + (size_t)m * D,
                sizeof(double) * D);
    out_mask[(size_t)t * K + f] = 1;
    ++f;
  }
  return dropped;
}

}  // extern "C"
