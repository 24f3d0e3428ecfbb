// Native host-side structured hex grid builder for the 3D dipping-layer problem.
//
// C++ counterpart of remo3d_jax/meshing/grid3d.py (same algorithm, same
// semantics — the Python file is the specification and the cross-check).
// Replaces the role the reference delegated to the gmsh C++ mesher for 3D
// models (gmsh_functions.py:544-684): one boundary-fitted sheared-cylindrical
// hex grid per measurement batch, built on the host while the device solves
// the previous chunk (the executor's lazy per-chunk pipeline).
//
// Exposed as a C ABI for ctypes (no pybind11 in the image).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

#include "grid_common.h"

using remo3d::HTerm;
using remo3d::graded_1d;
using remo3d::interp;
using remo3d::snap;
using remo3d::squircle_blend;

namespace {

// grid3d._zeta_average_sigma parity: average the piecewise-constant
// vals(zeta) over [lo, hi] via the integral F built from the interior knots
// (= bottoms[:-1]); degenerate cells fall back to vals[idx_c].
struct ZetaAverager {
  const double* knots;  // bottoms[0..L-2]
  int n_knots;          // L-1
  std::vector<double> c_at_knot;  // size L-1: cumulative integral at knots
  const std::vector<double>* vals;

  void init(const double* bottoms, int n_layers, const std::vector<double>& v) {
    knots = bottoms;
    n_knots = n_layers - 1;
    vals = &v;
    c_at_knot.assign(n_knots, 0.0);
    for (int k = 1; k < n_knots; ++k)
      c_at_knot[k] = c_at_knot[k - 1] + v[k] * (knots[k] - knots[k - 1]);
  }

  double F(double z) const {
    int i = static_cast<int>(std::lower_bound(knots, knots + n_knots, z) - knots);
    const int n_vals = static_cast<int>(vals->size());
    i = std::min(std::max(i, 0), n_vals - 1);
    double ref = (i == 0) ? knots[0] : knots[std::max(i - 1, 0)];
    double base = (i == 0) ? 0.0 : c_at_knot[std::max(i - 1, 0)];
    return base + (*vals)[i] * (z - ref);
  }

  double avg(double lo, double hi, int idx_c) const {
    double ext = hi - lo;
    if (ext <= 1e-12) return (*vals)[idx_c];
    return (F(hi) - F(lo)) / ext;
  }
};

}  // namespace

extern "C" {

// sigma_blend codes: 0 = centroid, 1 = arithmetic, 2 = harmonic, 3 = mixed.
// Returns 0 on success. Outputs (caller-allocated):
//   coords : nz*np*nr*3 doubles, (x, y, z) per node
//   sigma  : (nz-1)*(np-1)*(nr-1) doubles, cell conductivities
//   z_axis : nz doubles
int build_grid3d_native(
    double R, int nz, int np_, int nr, int n_wall, int n_blend,
    double h_min_source, double slope_source, double h_min_electrode,
    double slope_electrode, double h_min_boundary, double slope_boundary,
    double h_max_axial_frac, double h_min_radial, double slope_radial,
    double h_max_radial_frac, double blend_m0, double shear_cap_frac,
    double a,  // tan(dip) — precomputed by the caller for bit parity
    int sigma_blend,
    const double* electrodes, int n_el,
    const double* sources, int n_src,
    const double* boundaries, int n_bnd,  // interior layer boundaries
    const double* bottoms, int n_layers,  // per-layer bottom (ascending)
    const double* fz_radius,              // NaN when absent
    const double* sigma_fz,               // NaN-free (caller nan_to_num)
    const double* sigma_uz,
    const double* bh_z, const double* bh_r, int n_bh,
    double mud_sigma,
    double* coords, double* sigma, double* z_axis) {
  // ---- Axial lines (boundaries = axis crossings of the dip planes) --------
  std::vector<double> near_bnd;
  for (int i = 0; i < n_bnd; ++i)
    if (std::abs(boundaries[i]) < 0.98 * R) near_bnd.push_back(boundaries[i]);
  std::vector<double> el_sorted(electrodes, electrodes + n_el);
  std::sort(el_sorted.begin(), el_sorted.end());
  std::vector<double> src_sorted(sources, sources + n_src);
  std::sort(src_sorted.begin(), src_sorted.end());
  std::sort(near_bnd.begin(), near_bnd.end());

  std::vector<HTerm> terms = {
      {src_sorted.data(), static_cast<int>(src_sorted.size()), h_min_source,
       slope_source},
      {el_sorted.data(), static_cast<int>(el_sorted.size()), h_min_electrode,
       slope_electrode},
      {near_bnd.data(), static_cast<int>(near_bnd.size()), h_min_boundary,
       slope_boundary},
  };
  std::vector<double> z_lines;
  graded_1d(-R, R, nz, terms, h_max_axial_frac * R, z_lines);
  std::vector<double> snap_targets(el_sorted);
  snap_targets.insert(snap_targets.end(), near_bnd.begin(), near_bnd.end());
  snap(z_lines, snap_targets);
  std::copy(z_lines.begin(), z_lines.end(), z_axis);

  // ---- Radial stations (as in 2D) -----------------------------------------
  std::vector<double> wall_of_z(nz);
  double wall_max = 0.0;
  for (int i = 0; i < n_bh; ++i) wall_max = std::max(wall_max, bh_r[i]);
  for (int i = 0; i < nz; ++i)
    wall_of_z[i] = interp(bh_z, bh_r, n_bh, z_lines[i]);

  std::vector<double> invasion;
  for (int l = 0; l < n_layers; ++l)
    if (!std::isnan(fz_radius[l])) invasion.push_back(fz_radius[l]);
  std::sort(invasion.begin(), invasion.end());
  invasion.erase(std::unique(invasion.begin(), invasion.end()), invasion.end());

  double r_detach = wall_max * 1.3;
  if (!invasion.empty()) {
    double r_min_inv = invasion.front();
    if (r_min_inv * 0.8 > wall_max)
      r_detach = std::min(r_detach, std::max(r_min_inv * 0.8, wall_max * 1.05));
  }

  const int n_far_lines = nr - n_wall - n_blend;
  std::vector<double> far;
  {
    std::vector<double> det = {r_detach};
    std::vector<HTerm> rterms = {{det.data(), 1, h_min_radial, slope_radial}};
    if (!invasion.empty())
      rterms.push_back({invasion.data(), static_cast<int>(invasion.size()),
                        h_min_radial, slope_radial});
    graded_1d(r_detach, R, n_far_lines, rterms, h_max_radial_frac * R, far);
    std::vector<double> inv_targets;
    for (double v : invasion)
      if (v > r_detach && v < R) inv_targets.push_back(v);
    snap(far, inv_targets);
  }

  // ---- Node positions ------------------------------------------------------
  const double shear_cap = shear_cap_frac * R;
  auto shear_offset = [&](double x, double zeta) {
    double raw = a * x;
    double clamped = std::min(std::max(raw, -shear_cap), shear_cap);
    double taper = 1.0 - (zeta / R) * (zeta / R);
    return clamped * taper;
  };

  std::vector<double> cosphi(np_), sinphi(np_);
  for (int j = 0; j < np_; ++j) {
    double phi = M_PI * j / (np_ - 1);
    cosphi[j] = std::cos(phi);
    sinphi[j] = std::sin(phi);
  }

  const size_t NN = static_cast<size_t>(nz) * np_ * nr;
  std::vector<double> zeta_node(NN);  // z - a*x at post-blend nodes
  for (int i = 0; i < nz; ++i) {
    const double zl = z_lines[i];
    for (int j = 0; j < np_; ++j) {
      // Wall radius per (i, j): one fixed-point pass through the shear.
      double z_true_wall =
          zl + shear_offset(wall_of_z[i] * cosphi[j], zl);
      double wall_ij = interp(bh_z, bh_r, n_bh, z_true_wall);
      for (int k = 0; k < nr; ++k) {
        double rho;
        if (k <= n_wall) {
          rho = wall_ij * (static_cast<double>(k) / n_wall);
        } else if (k <= n_wall + n_blend) {
          rho = wall_ij + (r_detach - wall_ij) *
                              (static_cast<double>(k - n_wall) / n_blend);
        } else {
          rho = far[k - n_wall - n_blend];
        }
        double x = rho * cosphi[j];
        double y = rho * sinphi[j];
        double z = zl + shear_offset(x, zl);
        double zb, rhob;
        squircle_blend(z, rho, R, blend_m0, &zb, &rhob);
        double scale = rho > 0 ? rhob / rho : 1.0;
        const size_t n = (static_cast<size_t>(i) * np_ + j) * nr + k;
        coords[n * 3 + 0] = x * scale;
        coords[n * 3 + 1] = y * scale;
        coords[n * 3 + 2] = zb;
        zeta_node[n] = zb - a * (x * scale);
      }
    }
  }

  // ---- Conductivity sampling ----------------------------------------------
  std::vector<double> inv_uz;  // 1/sigma_uz for the harmonic/mixed averagers
  std::vector<double> uz(sigma_uz, sigma_uz + n_layers);
  const bool homog = sigma_blend != 0 && n_layers > 1;
  ZetaAverager avg_s, avg_r;
  if (homog) {
    avg_s.init(bottoms, n_layers, uz);
    if (sigma_blend >= 2) {
      inv_uz.resize(n_layers);
      for (int l = 0; l < n_layers; ++l) inv_uz[l] = 1.0 / sigma_uz[l];
      avg_r.init(bottoms, n_layers, inv_uz);
    }
  }

  const int NPc = np_ - 1, NRc = nr - 1;
  for (int i = 0; i < nz - 1; ++i) {
    for (int j = 0; j < NPc; ++j) {
      for (int k = 0; k < NRc; ++k) {
        double xc = 0, yc = 0, zc = 0, zlo = 1e300, zhi = -1e300;
        for (int di = 0; di < 2; ++di)
          for (int dj = 0; dj < 2; ++dj)
            for (int dk = 0; dk < 2; ++dk) {
              const size_t n =
                  (static_cast<size_t>(i + di) * np_ + (j + dj)) * nr + (k + dk);
              xc += coords[n * 3 + 0];
              yc += coords[n * 3 + 1];
              zc += coords[n * 3 + 2];
              zlo = std::min(zlo, zeta_node[n]);
              zhi = std::max(zhi, zeta_node[n]);
            }
        xc *= 0.125;
        yc *= 0.125;
        zc *= 0.125;
        const double zeta_c = zc - a * xc;
        const double rc = std::hypot(xc, yc);
        int idx = static_cast<int>(
            std::lower_bound(bottoms, bottoms + n_layers, zeta_c) - bottoms);
        if (idx >= n_layers) idx = n_layers - 1;
        double val;
        if (k < n_wall) {
          val = mud_sigma;
        } else {
          const double fz = std::isnan(fz_radius[idx]) ? -1.0 : fz_radius[idx];
          if (rc < fz) {
            val = sigma_fz[idx];
          } else if (!homog) {
            val = sigma_uz[idx];
          } else if (sigma_blend == 1) {
            val = avg_s.avg(zlo, zhi, idx);
          } else if (sigma_blend == 2) {
            val = 1.0 / avg_r.avg(zlo, zhi, idx);
          } else {  // mixed
            val = std::sqrt(avg_s.avg(zlo, zhi, idx) /
                            avg_r.avg(zlo, zhi, idx));
          }
        }
        sigma[(static_cast<size_t>(i) * NPc + j) * NRc + k] = val;
      }
    }
  }
  return 0;
}

}  // extern "C"
