// Native CPU MCRT engine: scalar sphere-traced photon transport.
//
// A compact OpenMP implementation of the same physics as the JAX wavefront
// engine (reference algorithm: src/inttau2.f90 + src/kernelsMod.f90 of
// the-professor510/RSMCRT, re-derived -- not translated).  It serves as
//  - an independent cross-validation oracle for the JAX engine, and
//  - the native CPU baseline for bench comparisons (the reference's own
//    OpenMP role).
//
// Scene model: N spheres + one axis-aligned box bounding volume, each with
// (mus, mua, g, n).  Analog (noBias) transport, Henyey-Greenstein
// scattering, Fresnel interfaces, path-length fluence deposition on a
// uniform cartesian grid.
//
// Exposed via a C ABI for ctypes (no pybind11 in this image).

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

struct Vec3 {
  double x, y, z;
};

static inline Vec3 operator+(Vec3 a, Vec3 b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}
static inline Vec3 operator-(Vec3 a, Vec3 b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
static inline Vec3 operator*(Vec3 a, double s) {
  return {a.x * s, a.y * s, a.z * s};
}
static inline double dot(Vec3 a, Vec3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
static inline double norm(Vec3 a) { return std::sqrt(dot(a, a)); }

// xoshiro256+ counter-seeded per thread
struct Rng {
  uint64_t s[4];
  explicit Rng(uint64_t seed) {
    // splitmix64 expansion
    for (int i = 0; i < 4; ++i) {
      seed += 0x9e3779b97f4a7c15ULL;
      uint64_t z = seed;
      z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
      z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
      s[i] = z ^ (z >> 31);
    }
  }
  static inline uint64_t rotl(uint64_t v, int k) {
    return (v << k) | (v >> (64 - k));
  }
  inline uint64_t next() {
    uint64_t result = s[0] + s[3];
    uint64_t t = s[1] << 17;
    s[2] ^= s[0];
    s[3] ^= s[1];
    s[1] ^= s[2];
    s[0] ^= s[3];
    s[2] ^= t;
    s[3] = rotl(s[3], 45);
    return result;
  }
  inline double uniform() {  // (0, 1]
    return ((next() >> 11) + 1.0) * 0x1.0p-53;
  }
};

struct Prim {
  int kind;  // 0 = sphere, 1 = box, 2 = moss egg, 3 = onion(egg) shell
  double cx, cy, cz;
  double radius;       // sphere | egg r1
  double hx, hy, hz;   // box half lengths | egg (r2, h, shell thickness)
  double mus, mua, g, n;
  double kappa() const { return mus + mua; }
  double albedo() const {
    return mua < 1e-9 ? 1.0 : mus / (mus + mua);
  }
};

struct Grid {
  int nx, ny, nz;
  double xmax, ymax, zmax;
};

// Moss egg (same formula as the JAX engine's sd_egg, itself matching the
// reference sdfs.f90:688-718): r1 = base radius, r2 = top radius, h = y
// of the top circle; 3D lengths (z participates).
static inline double sd_egg(Vec3 q, double r1, double r2, double h) {
  double px = std::fabs(q.x), py = q.y, pz = q.z;
  double r = r1 - r2;
  double h_in = h + r;
  double el = (h_in * h_in - r * r) / (2.0 * r);
  if (py <= 0.0) return std::sqrt(px * px + py * py + pz * pz) - r1;
  if ((py - h_in) * el > px * h_in) {
    double rt = (r1 + el) - std::sqrt(h_in * h_in + el * el);
    return std::sqrt(px * px + (py - h_in) * (py - h_in) + pz * pz) - rt;
  }
  return std::sqrt((px + el) * (px + el) + py * py + pz * pz) - (r1 + el);
}

static inline double sdf_eval(const Prim &p, Vec3 pos) {
  Vec3 q = {pos.x - p.cx, pos.y - p.cy, pos.z - p.cz};
  if (p.kind == 0) return norm(q) - p.radius;
  if (p.kind == 2) return sd_egg(q, p.radius, p.hx, p.hy);
  if (p.kind == 3)  // onion modifier applied to the egg (shell)
    return std::fabs(sd_egg(q, p.radius, p.hx, p.hy)) - p.hz;
  double ax = std::fabs(q.x) - p.hx;
  double ay = std::fabs(q.y) - p.hy;
  double az = std::fabs(q.z) - p.hz;
  double ox = ax > 0 ? ax : 0, oy = ay > 0 ? ay : 0, oz = az > 0 ? az : 0;
  double outside = std::sqrt(ox * ox + oy * oy + oz * oz);
  double inside = std::fmin(std::fmax(ax, std::fmax(ay, az)), 0.0);
  return outside + inside;
}

static inline int layer_of(const Prim *prims, int n, Vec3 pos,
                           double *ds_out) {
  int best = 0;  // 0 = outside
  double bestd = -1e30;
  for (int i = 0; i < n; ++i) {
    double d = sdf_eval(prims[i], pos);
    ds_out[i] = d;
    if (d < 0.0 && d > bestd) {
      bestd = d;
      best = i + 1;
    }
  }
  return best;
}

static inline Vec3 sdf_normal(const Prim &p, Vec3 pos) {
  const double h = 1e-6;
  Vec3 n{0, 0, 0};
  const double sx[4] = {1, -1, -1, 1};
  const double sy[4] = {-1, -1, 1, 1};
  const double sz[4] = {-1, 1, -1, 1};
  for (int k = 0; k < 4; ++k) {
    Vec3 off{sx[k] * h, sy[k] * h, sz[k] * h};
    double d = sdf_eval(p, pos + off);
    n.x += sx[k] * d;
    n.y += sy[k] * d;
    n.z += sz[k] * d;
  }
  double len = norm(n);
  if (len > 0) n = n * (1.0 / len);
  return n;
}

static inline double fresnel_coeff(Vec3 I, Vec3 N, double n1, double n2) {
  double costt = std::fabs(dot(I, N));
  if (costt > 1.0) costt = 1.0;
  double sintt = std::sqrt(1.0 - costt * costt);
  double sint2 = (n1 / n2) * sintt;
  if (sint2 > 1.0) return 1.0;
  if (costt == 1.0) return 0.0;
  double cost2 = std::sqrt(1.0 - sint2 * sint2);
  double f1 = (n1 * costt - n2 * cost2) / (n1 * costt + n2 * cost2);
  double f2 = (n1 * cost2 - n2 * costt) / (n1 * cost2 + n2 * costt);
  return 0.5 * (f1 * f1 + f2 * f2);
}

static inline void hg_scatter(Rng &rng, double g, Vec3 &dir) {
  double cost;
  if (g == 0.0) {
    cost = 2.0 * rng.uniform() - 1.0;
  } else {
    double temp = (1.0 - g * g) / (1.0 - g + 2.0 * g * rng.uniform());
    cost = (1.0 + g * g - temp * temp) / (2.0 * g);
    if (cost > 1) cost = 1;
    if (cost < -1) cost = -1;
  }
  double sint = std::sqrt(1.0 - cost * cost);
  double phi = 2.0 * M_PI * rng.uniform();
  double cosp = std::cos(phi), sinp = std::sin(phi);
  double nx = dir.x, ny = dir.y, nz = dir.z;
  double ux, uy, uz;
  if (std::fabs(nz) > 1.0 - 1e-12) {
    ux = sint * cosp;
    uy = sint * sinp;
    uz = nz > 0 ? cost : -cost;
  } else {
    double temp = std::sqrt(1.0 - nz * nz);
    ux = sint * (nx * nz * cosp - ny * sinp) / temp + nx * cost;
    uy = sint * (ny * nz * cosp + nx * sinp) / temp + ny * cost;
    uz = -sint * cosp * temp + nz * cost;
  }
  double len = std::sqrt(ux * ux + uy * uy + uz * uz);
  dir = {ux / len, uy / len, uz / len};
}

}  // namespace

extern "C" {

// Run an analog MCRT simulation.
//  prims: packed [kind, cx, cy, cz, radius, hx, hy, hz, mus, mua, g, n] x n
//  source: 0 = isotropic point, 1 = pencil (+sdir)
//  jmean: float32 [nx*ny*nz] accumulates path length * weight
// Returns total scatter events.
double mcrt_run(const double *prims_flat, int n_prims, const int *grid_n,
                const double *grid_max, int source_kind,
                const double *spos, const double *sdir, long nphotons,
                uint64_t seed, float *jmean, int n_threads) {
  std::vector<Prim> prims(n_prims);
  for (int i = 0; i < n_prims; ++i) {
    const double *p = prims_flat + 12 * i;
    prims[i] = {(int)p[0], p[1], p[2],  p[3], p[4], p[5],
                p[6],      p[7], p[8],  p[9], p[10], p[11]};
  }
  Grid grid{grid_n[0], grid_n[1], grid_n[2],
            grid_max[0], grid_max[1], grid_max[2]};
  const double eps = 1e-8;
  const double dvx = 2.0 * grid.xmax / grid.nx;
  const double dvy = 2.0 * grid.ymax / grid.ny;
  const double dvz = 2.0 * grid.zmax / grid.nz;
  const double delta = 1e-8 * std::fmin(dvx, std::fmin(dvy, dvz));
  double nscatt_total = 0.0;

#ifdef _OPENMP
  if (n_threads > 0) omp_set_num_threads(n_threads);
#endif

#pragma omp parallel reduction(+ : nscatt_total)
  {
#ifdef _OPENMP
    int tid = omp_get_thread_num();
#else
    int tid = 0;
#endif
    Rng rng(seed * 0x9e3779b97f4a7c15ULL + tid + 1);
    std::vector<double> ds(n_prims);

#pragma omp for schedule(dynamic, 256)
    for (long ph = 0; ph < nphotons; ++ph) {
      // --- emit ---
      Vec3 pos{spos[0], spos[1], spos[2]};
      Vec3 dir;
      if (source_kind == 0) {
        double phi = 2.0 * M_PI * rng.uniform();
        double cost = 2.0 * rng.uniform() - 1.0;
        double sint = std::sqrt(1.0 - cost * cost);
        dir = {sint * std::cos(phi), sint * std::sin(phi), cost};
      } else {
        dir = {sdir[0], sdir[1], sdir[2]};
      }
      int layer = layer_of(prims.data(), n_prims, pos, ds.data());
      if (layer == 0) continue;
      bool alive = true;
      int bounces = 0;

      while (alive) {
        // --- one flight leg: sample tau, sphere trace with DDA ---
        double tau = -std::log(rng.uniform());
        while (alive) {
          double d_sdf = 1e30, min_ds = 1e30;
          for (int i = 0; i < n_prims; ++i) {
            double d = sdf_eval(prims[i], pos);
            ds[i] = d;
            double ad = std::fabs(d);
            if (ad < d_sdf) d_sdf = ad;
            if (d < min_ds) min_ds = d;
          }
          if (min_ds > 0.0) { alive = false; break; }
          double kappa = prims[layer - 1].kappa();
          double tau_dist = kappa > 0 ? tau / kappa : 1e30;

          if (d_sdf < eps) {
            // boundary handling
            double smallstep = d_sdf + 2.0 * eps;
            Vec3 p2 = pos + dir * smallstep;
            int new_layer = 0;
            {
              double bestd = -1e30;
              for (int i = 0; i < n_prims; ++i) {
                double d = sdf_eval(prims[i], p2);
                if (d < 0.0 && d > bestd) { bestd = d; new_layer = i + 1; }
              }
            }
            if (new_layer == 0) { alive = false; break; }
            if (new_layer == layer) {
              double step = std::fmin(smallstep, tau_dist);
              // inline DDA walk of `step`
              {
                double remaining = step;
                while (remaining > 0) {
                  int ci = (int)std::floor((pos.x + grid.xmax) / dvx);
                  int cj = (int)std::floor((pos.y + grid.ymax) / dvy);
                  int ck = (int)std::floor((pos.z + grid.zmax) / dvz);
                  if (ci < 0 || ci >= grid.nx || cj < 0 || cj >= grid.ny ||
                      ck < 0 || ck >= grid.nz) { alive = false; break; }
                  double wx = dir.x > 0 ? ((ci + 1) * dvx - (pos.x + grid.xmax)) / dir.x
                              : dir.x < 0 ? (ci * dvx - (pos.x + grid.xmax)) / dir.x : 1e30;
                  double wy = dir.y > 0 ? ((cj + 1) * dvy - (pos.y + grid.ymax)) / dir.y
                              : dir.y < 0 ? (cj * dvy - (pos.y + grid.ymax)) / dir.y : 1e30;
                  double wz = dir.z > 0 ? ((ck + 1) * dvz - (pos.z + grid.zmax)) / dir.z
                              : dir.z < 0 ? (ck * dvz - (pos.z + grid.zmax)) / dir.z : 1e30;
                  double wall = std::fmin(wx, std::fmin(wy, wz)) + delta;
                  double sub = std::fmin(wall, remaining);
                  long idx = ((long)ci * grid.ny + cj) * grid.nz + ck;
#pragma omp atomic
                  jmean[idx] += (float)sub;
                  pos = pos + dir * sub;
                  remaining -= sub;
                }
              }
              if (!alive) break;
              tau -= step * kappa;
              if (tau_dist <= smallstep) {
                // interaction at the nudge end
                break;
              }
              continue;
            }
            double n1 = prims[layer - 1].n;
            double n2 = prims[new_layer - 1].n;
            if (n1 != n2) {
              int bprim = new_layer;
              {
                double d_new_old = ds[new_layer - 1];
                double d2_new = sdf_eval(prims[new_layer - 1], p2);
                double d_old = ds[layer - 1];
                double d2_old = sdf_eval(prims[layer - 1], p2);
                if (d2_new < 0 && d_new_old >= 0) bprim = new_layer;
                else if (d2_old >= 0 && d_old < 0) bprim = layer;
                else if (d2_new < 0 && d2_old < 0) bprim = new_layer;
                else bprim = layer;
              }
              Vec3 N = sdf_normal(prims[bprim - 1], pos);
              double Ri = fresnel_coeff(dir, N, n1, n2);
              if (rng.uniform() <= Ri) {
                // reflect
                dir = dir - N * (2.0 * dot(N, dir));
                if (++bounces > 1000) { alive = false; break; }
                continue;
              }
              // refract
              double c1 = dot(N, dir);
              Vec3 Nt = c1 < 0 ? N : N * -1.0;
              c1 = std::fabs(c1);
              double eta = n1 / n2;
              double c2 = std::sqrt(
                  std::fmax(1.0 - eta * eta * (1.0 - c1 * c1), 0.0));
              dir = dir * eta + Nt * (eta * c1 - c2);
            }
            // cross into the new layer along the (possibly refracted) dir
            layer = new_layer;
            double kap2 = prims[layer - 1].kappa();
            // deposit the small crossing step
            {
              int ci = (int)std::floor((p2.x + grid.xmax) / dvx);
              int cj = (int)std::floor((p2.y + grid.ymax) / dvy);
              int ck = (int)std::floor((p2.z + grid.zmax) / dvz);
              if (ci < 0 || ci >= grid.nx || cj < 0 || cj >= grid.ny ||
                  ck < 0 || ck >= grid.nz) { alive = false; break; }
              long idx = ((long)ci * grid.ny + cj) * grid.nz + ck;
#pragma omp atomic
              jmean[idx] += (float)smallstep;
            }
            pos = p2;
            tau = std::fmax(tau - smallstep * kap2, 0.0);
            continue;
          }

          // interior march: step min(d_sdf, tau_dist) with DDA deposits
          double step = std::fmin(d_sdf, tau_dist);
          bool interact = tau_dist <= d_sdf;
          double remaining = step;
          while (remaining > 0) {
            int ci = (int)std::floor((pos.x + grid.xmax) / dvx);
            int cj = (int)std::floor((pos.y + grid.ymax) / dvy);
            int ck = (int)std::floor((pos.z + grid.zmax) / dvz);
            if (ci < 0 || ci >= grid.nx || cj < 0 || cj >= grid.ny ||
                ck < 0 || ck >= grid.nz) { alive = false; break; }
            double wx = dir.x > 0 ? ((ci + 1) * dvx - (pos.x + grid.xmax)) / dir.x
                        : dir.x < 0 ? (ci * dvx - (pos.x + grid.xmax)) / dir.x : 1e30;
            double wy = dir.y > 0 ? ((cj + 1) * dvy - (pos.y + grid.ymax)) / dir.y
                        : dir.y < 0 ? (cj * dvy - (pos.y + grid.ymax)) / dir.y : 1e30;
            double wz = dir.z > 0 ? ((ck + 1) * dvz - (pos.z + grid.zmax)) / dir.z
                        : dir.z < 0 ? (ck * dvz - (pos.z + grid.zmax)) / dir.z : 1e30;
            double wall = std::fmin(wx, std::fmin(wy, wz)) + delta;
            double sub = std::fmin(wall, remaining);
            long idx = ((long)ci * grid.ny + cj) * grid.nz + ck;
#pragma omp atomic
            jmean[idx] += (float)sub;
            pos = pos + dir * sub;
            remaining -= sub;
          }
          if (!alive) break;
          tau -= step * prims[layer - 1].kappa();
          if (interact) break;  // interaction point reached
        }
        if (!alive) break;

        // --- interaction: scatter or absorb ---
        double albedo = prims[layer - 1].albedo();
        if (rng.uniform() < albedo) {
          hg_scatter(rng, prims[layer - 1].g, dir);
          nscatt_total += 1.0;
        } else {
          alive = false;
        }
      }
    }
  }
  return nscatt_total;
}

int mcrt_num_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}
}
