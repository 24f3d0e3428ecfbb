// Shared host-side grid-building helpers (graded placement, snapping,
// interpolation, squircle blend) used by both the 2D (grid2d.cpp) and 3D
// (grid3d.cpp) native builders. The Python implementations
// (remo3d_jax/meshing/grid2d.py) are the specification; parity is enforced by
// tests/test_grid.py cross-checks.
#ifndef REMO3D_NATIVE_GRID_COMMON_H_
#define REMO3D_NATIVE_GRID_COMMON_H_

#include <algorithm>
#include <cmath>
#include <vector>

namespace remo3d {

struct HTerm {
  const double* centers;
  int n;
  double h_min;
  double slope;
};

// Graded 1D point placement by density integration (grid2d._graded_1d parity).
inline void graded_1d(double lo, double hi, int n_lines,
                      const std::vector<HTerm>& terms, double h_max,
                      std::vector<double>& out) {
  // Sample set: uniform + log-spaced clusters around every center.
  std::vector<double> zz;
  zz.reserve(4001 + 100 * 8);
  for (int i = 0; i < 4001; ++i)
    zz.push_back(lo + (hi - lo) * i / 4000.0);
  for (const auto& t : terms) {
    for (int c = 0; c < t.n; ++c) {
      double center = t.centers[c];
      // geomspace(h_min/4, 2.0, 48) on both sides + the center itself
      double a = t.h_min / 4.0, b = 2.0;
      double ratio = std::pow(b / a, 1.0 / 47.0);
      double v = a;
      for (int k = 0; k < 48; ++k, v *= ratio) {
        zz.push_back(center - v);
        zz.push_back(center + v);
      }
      zz.push_back(center);
    }
  }
  for (auto& v : zz) v = std::min(std::max(v, lo), hi);
  std::sort(zz.begin(), zz.end());
  zz.erase(std::unique(zz.begin(), zz.end()), zz.end());

  const size_t m = zz.size();
  std::vector<double> h(m, h_max);
  for (const auto& t : terms) {
    if (t.n == 0) continue;
    // centers are sorted by the caller; nearest-distance via binary search
    for (size_t i = 0; i < m; ++i) {
      const double* lo_it =
          std::lower_bound(t.centers, t.centers + t.n, zz[i]);
      double dist = 1e300;
      if (lo_it != t.centers + t.n) dist = std::min(dist, *lo_it - zz[i]);
      if (lo_it != t.centers) dist = std::min(dist, zz[i] - *(lo_it - 1));
      h[i] = std::min(h[i], t.h_min + t.slope * dist);
    }
  }
  std::vector<double> cum(m, 0.0);
  for (size_t i = 1; i < m; ++i)
    cum[i] = cum[i - 1] + 0.5 * (1.0 / h[i] + 1.0 / h[i - 1]) * (zz[i] - zz[i - 1]);
  const double scale = (n_lines - 1) / cum[m - 1];
  for (auto& c : cum) c *= scale;

  out.resize(n_lines);
  size_t j = 0;
  for (int i = 0; i < n_lines; ++i) {
    double target = i;
    while (j + 1 < m && cum[j + 1] < target) ++j;
    if (j + 1 >= m) {
      out[i] = zz[m - 1];
    } else {
      double t = (target - cum[j]) / std::max(cum[j + 1] - cum[j], 1e-300);
      t = std::min(std::max(t, 0.0), 1.0);
      out[i] = zz[j] + t * (zz[j + 1] - zz[j]);
    }
  }
  out[0] = lo;
  out[n_lines - 1] = hi;
}

// Snap targets onto lines (grid2d._snap parity: float-noise dedupe, greedy
// ascending assignment with ordering constraint, final sort).
inline void snap(std::vector<double>& lines, std::vector<double> targets) {
  std::sort(targets.begin(), targets.end());
  targets.erase(std::unique(targets.begin(), targets.end()), targets.end());
  // merge float-noise duplicates
  std::vector<double> t2;
  for (double t : targets)
    if (t2.empty() || t - t2.back() > 1e-7) t2.push_back(t);
  // keep strictly interior targets
  std::vector<double> tt;
  for (double t : t2)
    if (t > lines.front() && t < lines.back()) tt.push_back(t);

  const int lo_idx = 1, hi_idx = static_cast<int>(lines.size()) - 2;
  int prev = lo_idx - 1;
  for (size_t ti = 0; ti < tt.size(); ++ti) {
    const int remaining = static_cast<int>(tt.size() - ti - 1);
    // nearest line index
    auto it = std::lower_bound(lines.begin(), lines.end(), tt[ti]);
    int idx = static_cast<int>(it - lines.begin());
    if (idx > 0 &&
        (idx >= static_cast<int>(lines.size()) ||
         std::abs(lines[idx - 1] - tt[ti]) <= std::abs(lines[idx] - tt[ti])))
      --idx;
    idx = std::min(std::max(idx, prev + 1), hi_idx - remaining);
    lines[idx] = tt[ti];
    prev = idx;
  }
  std::sort(lines.begin(), lines.end());
}

// np.interp semantics (clamped beyond the table ends).
inline double interp(const double* xs, const double* ys, int n, double x) {
  if (x <= xs[0]) return ys[0];
  if (x >= xs[n - 1]) return ys[n - 1];
  const double* it = std::upper_bound(xs, xs + n, x);
  int i = static_cast<int>(it - xs);
  double t = (x - xs[i - 1]) / (xs[i] - xs[i - 1]);
  return ys[i - 1] + t * (ys[i] - ys[i - 1]);
}

// grid2d._squircle_blend parity: map the logical rectangle onto the half-disc,
// identity for L-inf radius m <= m0, boundary ring exactly on the circle.
inline void squircle_blend(double z, double r, double R, double m0, double* zb,
                           double* rb) {
  double zn = z / R, rn = r / R;
  double m = std::max(std::abs(zn), std::abs(rn));
  double s = std::min(std::max((m - m0) / (1.0 - m0), 0.0), 1.0);
  double w = s * s * (3.0 - 2.0 * s);
  double q = m > 0 ? std::hypot(zn, rn) / m : 1.0;
  double f = (1.0 - w) + w / (q > 0 ? q : 1.0);
  *zb = z * f;
  *rb = r * f;
}

}  // namespace remo3d

#endif  // REMO3D_NATIVE_GRID_COMMON_H_
