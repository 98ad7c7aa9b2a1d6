// Native tessellation: incremental 3D Delaunay (Bowyer-Watson) and Voronoi
// cells, the host library of impact_tpu_torch/native.py.
//
// The equivalent of the reference's impact_tesselation crate
// (engine/crates/impact_tesselation/src/{delaunay.rs,voronoi.rs}):
// DelaunayTetrahedralization with circumsphere predicates and per-site
// Voronoi cell extraction, for fracture-region geometry and offline tools.
// It runs on the host: the simulation's device path assigns voxels to the
// nearest fracture seed instead; this gives the exact geometry the reference
// exposes.
//
// Built at first use by impact_tpu_torch/native.py with the host C++
// compiler into impact_tpu_torch/_build/, and loaded with ctypes.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Tet {
  int v[4];
  bool alive;
};

struct Face {
  int a, b, c;  // sorted
  int opp;      // opposite vertex of the cavity tet (for orientation)
};

// determinant helpers (double precision; callers jitter degenerate inputs)
static double det3(double a, double b, double c, double d, double e, double f,
                   double g, double h, double i) {
  return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g);
}

static double orient3d(const double* pa, const double* pb, const double* pc,
                       const double* pd) {
  return det3(pa[0] - pd[0], pa[1] - pd[1], pa[2] - pd[2],
              pb[0] - pd[0], pb[1] - pd[1], pb[2] - pd[2],
              pc[0] - pd[0], pc[1] - pd[1], pc[2] - pd[2]);
}

// > 0 iff pe strictly inside circumsphere of (pa,pb,pc,pd) when the tet is
// positively oriented
static double insphere(const double* pa, const double* pb, const double* pc,
                       const double* pd, const double* pe) {
  double ax = pa[0] - pe[0], ay = pa[1] - pe[1], az = pa[2] - pe[2];
  double bx = pb[0] - pe[0], by = pb[1] - pe[1], bz = pb[2] - pe[2];
  double cx = pc[0] - pe[0], cy = pc[1] - pe[1], cz = pc[2] - pe[2];
  double dx = pd[0] - pe[0], dy = pd[1] - pe[1], dz = pd[2] - pe[2];
  double a2 = ax * ax + ay * ay + az * az;
  double b2 = bx * bx + by * by + bz * bz;
  double c2 = cx * cx + cy * cy + cz * cz;
  double d2 = dx * dx + dy * dy + dz * dz;
  // 4x4 determinant expansion along the last column
  double m = a2 * det3(bx, by, bz, cx, cy, cz, dx, dy, dz) -
             b2 * det3(ax, ay, az, cx, cy, cz, dx, dy, dz) +
             c2 * det3(ax, ay, az, bx, by, bz, dx, dy, dz) -
             d2 * det3(ax, ay, az, bx, by, bz, cx, cy, cz);
  return m;
}

}  // namespace

extern "C" {

// Tetrahedralize n 3D points. out_tets has room for max_tets*4 ints.
// Returns the number of tetrahedra written, or -1 on overflow/failure.
// Super-tet vertices are excluded from the output.
int impact_delaunay_tetrahedralize(const float* points_f, int n,
                                   int* out_tets, int max_tets) {
  if (n < 4) return 0;
  std::vector<double> pts(3 * (n + 4));
  double lo[3] = {1e300, 1e300, 1e300}, hi[3] = {-1e300, -1e300, -1e300};
  for (int i = 0; i < n; ++i)
    for (int k = 0; k < 3; ++k) {
      double v = points_f[3 * i + k];
      pts[3 * i + k] = v;
      if (v < lo[k]) lo[k] = v;
      if (v > hi[k]) hi[k] = v;
    }
  double cx = (lo[0] + hi[0]) / 2, cy = (lo[1] + hi[1]) / 2,
         cz = (lo[2] + hi[2]) / 2;
  double span = 1.0;
  for (int k = 0; k < 3; ++k) span = std::fmax(span, hi[k] - lo[k]);
  double r = 50.0 * span;
  // super-tetrahedron (indices n..n+3)
  double super_pts[4][3] = {{cx - r, cy - r, cz - r},
                            {cx + r, cy - r, cz - r},
                            {cx, cy + r, cz - r},
                            {cx, cy, cz + r}};
  for (int s = 0; s < 4; ++s)
    for (int k = 0; k < 3; ++k) pts[3 * (n + s) + k] = super_pts[s][k];

  auto P = [&](int i) { return &pts[3 * i]; };

  std::vector<Tet> tets;
  {
    Tet t0{{n, n + 1, n + 2, n + 3}, true};
    // ensure positive orientation
    if (orient3d(P(t0.v[0]), P(t0.v[1]), P(t0.v[2]), P(t0.v[3])) < 0)
      std::swap(t0.v[0], t0.v[1]);
    tets.push_back(t0);
  }

  std::vector<int> bad;
  struct BFace {
    int a, b, c;
  };
  std::vector<BFace> boundary;

  for (int ip = 0; ip < n; ++ip) {
    const double* p = P(ip);
    bad.clear();
    for (int t = 0; t < (int)tets.size(); ++t) {
      if (!tets[t].alive) continue;
      const int* v = tets[t].v;
      double o = orient3d(P(v[0]), P(v[1]), P(v[2]), P(v[3]));
      double s = insphere(P(v[0]), P(v[1]), P(v[2]), P(v[3]), p);
      // inside-circumsphere ⇔ s > 0 for negatively oriented tets (verified
      // numerically against the determinant expansion used above)
      if (o > 0) s = -s;
      if (s > 0) bad.push_back(t);
    }
    if (bad.empty()) continue;  // duplicate/degenerate point: skip

    // cavity boundary: faces of bad tets not shared by two bad tets
    boundary.clear();
    for (int bi : bad) {
      const int* v = tets[bi].v;
      const int fv[4][3] = {{v[1], v[2], v[3]},
                            {v[0], v[3], v[2]},
                            {v[0], v[1], v[3]},
                            {v[0], v[2], v[1]}};
      for (int f = 0; f < 4; ++f) {
        int a = fv[f][0], b = fv[f][1], c = fv[f][2];
        // is this face shared with another bad tet?
        bool shared = false;
        for (int bj : bad) {
          if (bj == bi) continue;
          const int* w = tets[bj].v;
          int match = 0;
          for (int k = 0; k < 4; ++k)
            if (w[k] == a || w[k] == b || w[k] == c) ++match;
          if (match == 3) {
            shared = true;
            break;
          }
        }
        if (!shared) boundary.push_back({a, b, c});
      }
    }
    for (int bi : bad) tets[bi].alive = false;
    for (const BFace& f : boundary) {
      Tet nt{{f.a, f.b, f.c, ip}, true};
      if (orient3d(P(nt.v[0]), P(nt.v[1]), P(nt.v[2]), P(nt.v[3])) < 0)
        std::swap(nt.v[0], nt.v[1]);
      tets.push_back(nt);
    }
  }

  int count = 0;
  for (const Tet& t : tets) {
    if (!t.alive) continue;
    bool has_super = false;
    for (int k = 0; k < 4; ++k)
      if (t.v[k] >= n) has_super = true;
    if (has_super) continue;
    if (count >= max_tets) return -1;
    for (int k = 0; k < 4; ++k) out_tets[4 * count + k] = t.v[k];
    ++count;
  }
  return count;
}

// Circumcenter of a tetrahedron (doubles out).
static void circumcenter(const double* a, const double* b, const double* c,
                         const double* d, double* out) {
  double ba[3], ca[3], da[3];
  for (int k = 0; k < 3; ++k) {
    ba[k] = b[k] - a[k];
    ca[k] = c[k] - a[k];
    da[k] = d[k] - a[k];
  }
  double b2 = ba[0] * ba[0] + ba[1] * ba[1] + ba[2] * ba[2];
  double c2 = ca[0] * ca[0] + ca[1] * ca[1] + ca[2] * ca[2];
  double d2 = da[0] * da[0] + da[1] * da[1] + da[2] * da[2];
  double det = 2.0 * det3(ba[0], ba[1], ba[2], ca[0], ca[1], ca[2], da[0],
                          da[1], da[2]);
  if (std::fabs(det) < 1e-30) det = det < 0 ? -1e-30 : 1e-30;
  out[0] = a[0] + (b2 * (ca[1] * da[2] - ca[2] * da[1]) -
                   c2 * (ba[1] * da[2] - ba[2] * da[1]) +
                   d2 * (ba[1] * ca[2] - ba[2] * ca[1])) / det;
  out[1] = a[1] - (b2 * (ca[0] * da[2] - ca[2] * da[0]) -
                   c2 * (ba[0] * da[2] - ba[2] * da[0]) +
                   d2 * (ba[0] * ca[2] - ba[2] * ca[0])) / det;
  out[2] = a[2] + (b2 * (ca[0] * da[1] - ca[1] * da[0]) -
                   c2 * (ba[0] * da[1] - ba[1] * da[0]) +
                   d2 * (ba[0] * ca[1] - ba[1] * ca[0])) / det;
}

// Voronoi cell vertices of a site = circumcenters of its incident Delaunay
// tets (ref: impact_tesselation/src/voronoi.rs dual extraction). Returns the
// number of vertices written to out_verts (3 floats each), or -1 on overflow.
int impact_voronoi_cell_vertices(const float* points_f, int n_points,
                                 const int* tets, int n_tets, int site,
                                 float* out_verts, int max_verts) {
  std::vector<double> pts(3 * n_points);
  for (int i = 0; i < 3 * n_points; ++i) pts[i] = points_f[i];
  int count = 0;
  for (int t = 0; t < n_tets; ++t) {
    const int* v = &tets[4 * t];
    bool incident = v[0] == site || v[1] == site || v[2] == site || v[3] == site;
    if (!incident) continue;
    if (count >= max_verts) return -1;
    double cc[3];
    circumcenter(&pts[3 * v[0]], &pts[3 * v[1]], &pts[3 * v[2]],
                 &pts[3 * v[3]], cc);
    for (int k = 0; k < 3; ++k) out_verts[3 * count + k] = (float)cc[k];
    ++count;
  }
  return count;
}

}  // extern "C"
