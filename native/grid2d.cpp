// Native host-side structured grid builder for the 2D axisymmetric problem.
//
// C++ counterpart of remo3d_jax/meshing/grid2d.py (same algorithm, same
// semantics — the Python file is the specification and the cross-check).
// This is the framework's native replacement for the role the reference
// delegated to the gmsh/netgen C++ meshers (gmsh_functions.py /
// netgen_functions.py): generating one boundary-fitted, graded, snapped grid
// per measurement batch on the host, feeding fixed-shape arrays to the device.
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

extern "C" {

// Returns 0 on success. Outputs (caller-allocated):
//   coords   : nz*nr*2 doubles, (z, r) per node
//   sigma    : (nz-1)*(nr-1) doubles, cell conductivities
//   z_axis   : nz doubles
int build_grid2d_native(
    double R, int nz, int nr, int n_wall, int n_blend,
    double h_min_source, double slope_source, double h_min_electrode,
    double slope_electrode, double h_min_boundary, double slope_boundary,
    double h_max_axial_frac, double h_min_radial, double slope_radial,
    double h_max_radial_frac, double blend_m0,
    const double* electrodes, int n_el,
    const double* sources, int n_src,
    const double* boundaries, int n_bnd,          // interior layer boundaries
    const double* bottoms, int n_layers,          // per-layer bottom (ascending)
    const double* fz_radius,                      // NaN when absent
    const double* sigma_fz, const double* sigma_uz,
    const double* bh_z, const double* bh_r, int n_bh,
    double mud_sigma,
    double* coords, double* sigma, double* z_axis) {
  // ---- Axial lines -------------------------------------------------------
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

  // ---- Radial stations ---------------------------------------------------
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
    std::vector<HTerm> rterms = {
        {det.data(), 1, h_min_radial, slope_radial}};
    if (!invasion.empty())
      rterms.push_back({invasion.data(), static_cast<int>(invasion.size()),
                        h_min_radial, slope_radial});
    graded_1d(r_detach, R, n_far_lines, rterms, h_max_radial_frac * R, far);
    std::vector<double> inv_targets;
    for (double v : invasion)
      if (v > r_detach && v < R) inv_targets.push_back(v);
    snap(far, inv_targets);
  }

  // ---- Node positions + sigma (fused loops) ------------------------------
  const double m0 = blend_m0;
  auto blend = [&](double z, double r, double* zb, double* rb) {
    double zn = z / R, rn = r / R;
    double m = std::max(std::abs(zn), std::abs(rn));
    double s = std::min(std::max((m - m0) / (1.0 - m0), 0.0), 1.0);
    double w = s * s * (3.0 - 2.0 * s);
    double q = m > 0 ? std::hypot(zn, rn) / m : 1.0;
    double f = (1.0 - w) + w / (q > 0 ? q : 1.0);
    *zb = z * f;
    *rb = r * f;
  };

  std::vector<double> r_nodes(static_cast<size_t>(nz) * nr);
  for (int i = 0; i < nz; ++i) {
    const double w = wall_of_z[i];
    for (int j = 0; j <= n_wall; ++j)
      r_nodes[i * nr + j] = w * (static_cast<double>(j) / n_wall);
    for (int j = 1; j <= n_blend; ++j)
      r_nodes[i * nr + n_wall + j] =
          w + (r_detach - w) * (static_cast<double>(j) / n_blend);
    for (int j = 1; j < n_far_lines; ++j)
      r_nodes[i * nr + n_wall + n_blend + j] = far[j];
  }

  // sigma at (pre-blend) cell centroids; borehole column overridden to mud.
  for (int i = 0; i < nz - 1; ++i) {
    const double zc0 = 0.5 * (z_lines[i] + z_lines[i + 1]);
    for (int j = 0; j < nr - 1; ++j) {
      double val;
      if (j < n_wall) {
        val = mud_sigma;
      } else {
        const double rc = 0.25 * (r_nodes[i * nr + j] + r_nodes[i * nr + j + 1] +
                                  r_nodes[(i + 1) * nr + j] +
                                  r_nodes[(i + 1) * nr + j + 1]);
        // layer lookup by bottoms (first/last layer extended to infinity)
        int l = static_cast<int>(
            std::lower_bound(bottoms, bottoms + n_layers, zc0) - bottoms);
        if (l >= n_layers) l = n_layers - 1;
        const double fz = std::isnan(fz_radius[l]) ? -1.0 : fz_radius[l];
        val = (rc < fz) ? sigma_fz[l] : sigma_uz[l];
      }
      sigma[i * (nr - 1) + j] = val;
    }
  }

  // blend node coordinates
  for (int i = 0; i < nz; ++i)
    for (int j = 0; j < nr; ++j) {
      double zb, rb;
      blend(z_lines[i], r_nodes[i * nr + j], &zb, &rb);
      coords[(i * nr + j) * 2 + 0] = zb;
      coords[(i * nr + j) * 2 + 1] = rb;
    }
  return 0;
}

}  // extern "C"
