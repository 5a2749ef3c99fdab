// Fused ray trace to the sensor (Hopper), for the DP-PSF path.
//
// Replaces the Pallas TPU kernel sdirt_tpu/dp/fused_trace.py:
// fused_trace_sensor (kernel _trace_kernel, helpers _step_c, _sag_dsag,
// _sphere_seed_c). Each ray (o, d, ra) goes through the whole surface chain
// of a lens at one wavelength: per surface a sphere-seeded Newton
// intersection (or the closed forms below), the surface's validity rule, and
// Snell refraction. The ray is then propagated to the sensor plane d_sensor,
// and the four splat inputs are written:
//
//   px = -(ox + dx t),  py = -(oy + dy t),  x_tan = -dx / dz,  ra
//
// Bound on an H100 SXM: operations. A ray reads 7 f32 and writes 4 (44 B);
// through rf50mm's 12 surfaces it does 1503 f32 operations (counted from
// this source by dp/fused_trace.py:ops_per_ray), 34 per byte, above the
// card's 67 TFLOP/s / 3.35 TB/s = 20 operations per byte. At the fit step's
// main bundle (20000 x 64 rays) that is 28.7 us of f32 arithmetic against
// 16.8 us of memory traffic.
//
// Design (first version: simple and right). One thread per ray, the whole
// chain in registers: only the seven inputs are read and the four outputs
// written, which is what the Pallas kernel keeps out of HBM. The lens is not
// compiled in (Pallas bakes it into each kernel; here that would mean one
// nvcc build per lens and wavelength): the host builds a table of per-surface
// constants (dp/fused_trace.py:_surface_table), each folded in double and
// rounded once to f32 exactly as the JAX code's Python-float arithmetic
// folds it, and passes it by value as a kernel parameter, where it lives in
// the constant bank. Every thread reads the same surface at the same time,
// so the branch on the surface's path is warp-uniform. The ragged edge is
// masked here; nothing is padded. The arrays are read as they lie: o and d
// [n, 3], ra [n].
//
// Numerics: every literal is float; 1.0f/sqrtf where JAX has lax.rsqrt;
// clips and maxima let NaN through as jnp.clip / jnp.maximum do. The file is
// built with --fmad=false, so no multiply-add is contracted and the kernel
// rounds as the plain PyTorch version (fused_trace_sensor_ref) does; a
// rounding difference could flip a ray's validity at an aperture edge.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (utils/kernels.py); no PyTorch headers.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_SURF 24
#define MAX_AI 8

// One surface; the layout matches dp/fused_trace.py:_Surf.
struct Surf {
  int path;
  int newton;   // general path: run the loose Newton iterations
  int has_c;    // c != 0: conic term of the sag, sphere seed
  int n_ai;     // aspheric terms in use
  int loose;    // loose rule: 0 always valid, 1 r2 < bound, 2 r2 > 0
  int tight;    // tight rule: 0 r2 < rap2, 1 also r2 < bound
  int vrule;    // general path validity: 0 stop, 1 spheric, 2 aspheric
  int skip;     // stop in air: no refraction
  float c, opk, cc, cz, rad2, d, rap2, bound, nz0, eta, eta2;
  float ai[MAX_AI], dai[MAX_AI];
};

struct Plan {
  int n_surf;
  int maxiter;
  Surf s[MAX_SURF];
};

namespace {

constexpr int PATH_PLANE = 0;    // flat stop: plane hit
constexpr int PATH_SPHERE = 1;   // pure sphere: polished quadratic, centre normal
constexpr int PATH_GENERAL = 2;  // even asphere: sphere seed + Newton

constexpr float EPS = 1e-9f;             // EPSILON
constexpr float STEP = 5.0f;             // NEWTON_STEP_BOUND
constexpr float TOL_TIGHT = 10e-6f;      // NEWTON_TOL_TIGHT

__device__ __forceinline__ float clip_step(float x) {
  return x < -STEP ? -STEP : (x > STEP ? STEP : x);
}

__device__ __forceinline__ float at_least(float x, float lo) {
  return x < lo ? lo : x;
}

// _sag_dsag: the sag and its derivative in r^2
__device__ __forceinline__ void sag_dsag(const Surf& s, float r2, float& sag,
                                         float& dsag) {
  bool have = false;
  sag = 0.0f;
  dsag = 0.0f;
  if (s.has_c) {
    const float u = at_least(1.0f - (s.opk * r2) * s.cc, 1e-24f);
    const float sf = sqrtf(u);
    const float inv_sf = 1.0f / sf;
    const float inv1 = 1.0f / (1.0f + sf);
    sag = (r2 * s.c) * inv1;
    dsag = ((((1.0f + sf) + (1.0f - u) * (0.5f * inv_sf)) * s.c) * inv1) * inv1;
    have = true;
  }
  if (s.n_ai > 0) {
    float poly = s.ai[s.n_ai - 1];
    float dpoly = s.dai[s.n_ai - 1];
    for (int i = s.n_ai - 2; i >= 0; --i) {
      poly = poly * r2 + s.ai[i];
      dpoly = dpoly * r2 + s.dai[i];
    }
    sag = have ? sag + poly * r2 : poly * r2;
    dsag = have ? dsag + dpoly : dpoly;
  }
}

// _sphere_seed_c: intersection with the osculating sphere, the plane t
// where the sphere is missed
__device__ __forceinline__ float sphere_seed(const Surf& s, float ox, float oy,
                                             float oz, float dx, float dy,
                                             float dz, float t_plane,
                                             bool polish) {
  if (!s.has_c) return t_plane;
  const float ocz = oz - s.cz;
  const float b = 2.0f * ((dx * ox + dy * oy) + dz * ocz);
  const float cc = ((ox * ox + oy * oy) + ocz * ocz) - s.rad2;
  float a = 1.0f, disc, inv2a;
  if (polish) {
    // the exact quadratic: |d| drifts ~1e-6 from unit along the chain
    a = (dx * dx + dy * dy) + dz * dz;
    disc = b * b - (4.0f * a) * cc;
    inv2a = 0.5f / a;
  } else {
    disc = b * b - 4.0f * cc;
    inv2a = 0.5f;
  }
  const bool ok = disc > 0.0f;
  const float sq = sqrtf(at_least(disc, 0.0f));
  const float t1 = (-b - sq) * inv2a;
  const float t2 = (-b + sq) * inv2a;
  float pick = fabsf(t1 - t_plane) < fabsf(t2 - t_plane) ? t1 : t2;
  if (polish) {
    // one Newton step on q(t) = a t^2 + b t + cc
    const float q = (a * pick + b) * pick + cc;
    pick = pick - clip_step(q / (((2.0f * a) * pick + b) + EPS));
  }
  return ok ? pick : t_plane;
}

__device__ __forceinline__ bool in_loose(const Surf& s, float r2) {
  return s.loose == 0 ? true : (s.loose == 1 ? r2 < s.bound : r2 > 0.0f);
}

__device__ __forceinline__ bool in_tight(const Surf& s, float r2) {
  const bool in_ap = r2 < s.rap2;
  return s.tight ? (in_ap && r2 < s.bound) : in_ap;
}

// ft(t) = sag(r^2(t)) + d - z(t) and its t-derivative, with the loose or
// tight validity mask zeroing r^2 of rays outside
__device__ __forceinline__ void ft_dfdt(const Surf& s, float ox, float oy,
                                        float oz, float dx, float dy, float dz,
                                        bool live, float dxy2, float doxy,
                                        float t, bool tight, float& ft,
                                        float& dfdt) {
  const float x = ox + dx * t;
  const float y = oy + dy * t;
  const float z = oz + dz * t;
  const float r2_raw = x * x + y * y;
  const bool v = (tight ? in_tight(s, r2_raw) : in_loose(s, r2_raw)) && live;
  const float m = v ? 1.0f : 0.0f;
  const float xm = x * m, ym = y * m;
  const float r2 = xm * xm + ym * ym;
  float sag, dsag;
  sag_dsag(s, r2, sag, dsag);
  ft = (sag + s.d) - z;
  dfdt = dsag * (2.0f * (dxy2 * t + doxy)) - dz;
}

__global__ void __launch_bounds__(256)
fused_trace_kernel(const Plan plan, const float* __restrict__ o,
                   const float* __restrict__ d, const float* __restrict__ ra_in,
                   float d_sensor, int64_t n, float* __restrict__ px,
                   float* __restrict__ py, float* __restrict__ xt,
                   float* __restrict__ ra_out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
  float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
  float ra = ra_in[i];

  for (int si = 0; si < plan.n_surf; ++si) {
    const Surf& s = plan.s[si];
    const float inv_dz = 1.0f / dz;
    const float t0 = (s.d - oz) * inv_dz;
    const bool live = ra > 0.0f;
    float nx_o, ny_o, nz_o, r2n;
    bool valid;
    if (s.path == PATH_PLANE) {
      nx_o = ox + dx * t0;
      ny_o = oy + dy * t0;
      nz_o = oz + dz * t0;
      r2n = nx_o * nx_o + ny_o * ny_o;
      valid = (r2n <= s.rap2) && live;
    } else if (s.path == PATH_SPHERE) {
      // re-centred at the vertex plane, so every coefficient is O(R)
      const float oxp = ox + dx * t0;
      const float oyp = oy + dy * t0;
      const float ozp = oz + dz * t0;
      const float tp_loc = (s.d - ozp) * inv_dz;
      const float t_loc = sphere_seed(s, oxp, oyp, ozp, dx, dy, dz, tp_loc, true);
      const float t = t0 + t_loc;
      nx_o = oxp + dx * t_loc;
      ny_o = oyp + dy * t_loc;
      nz_o = ozp + dz * t_loc;
      r2n = nx_o * nx_o + ny_o * ny_o;
      valid = (r2n <= s.rap2) && (t >= 0.0f) && live;
    } else {
      const float dxy2 = dx * dx + dy * dy;
      const float doxy = dx * ox + dy * oy;
      float t = sphere_seed(s, ox, oy, oz, dx, dy, dz, t0, false);
      float ft, dfdt;
      if (s.newton) {
        for (int it = 0; it < plan.maxiter; ++it) {
          ft_dfdt(s, ox, oy, oz, dx, dy, dz, live, dxy2, doxy, t, false, ft, dfdt);
          t = t - clip_step(ft / (dfdt + EPS));
        }
      }
      // the tight polish; the tolerance test reads its pre-polish residual
      ft_dfdt(s, ox, oy, oz, dx, dy, dz, live, dxy2, doxy, t, true, ft, dfdt);
      t = t - clip_step(ft / (dfdt + EPS));
      nx_o = ox + dx * t;
      ny_o = oy + dy * t;
      nz_o = oz + dz * t;
      r2n = nx_o * nx_o + ny_o * ny_o;
      if (s.vrule == 2) {
        valid = in_tight(s, r2n) && (fabsf(ft) < TOL_TIGHT) && live && (t > 0.0f);
      } else if (s.vrule == 1) {
        valid = (r2n <= s.rap2) && (t >= 0.0f) && live;
      } else {
        valid = (r2n <= s.rap2) && live;
      }
    }
    if (valid) {
      ox = nx_o;
      oy = ny_o;
      oz = nz_o;
    }
    ra = ra * (valid ? 1.0f : 0.0f);
    if (s.skip) continue;

    // Snell refraction, forward-oriented unit normal
    float nx, ny, nz;
    if (s.path == PATH_SPHERE) {
      if (s.has_c) {
        // exact: -(p - C) * c with C = (0, 0, d + 1/c)
        nx = -ox * s.c;
        ny = -oy * s.c;
        nz = s.nz0 - oz * s.c;
      } else {
        nx = 0.0f;
        ny = 0.0f;
        nz = 1.0f;
      }
    } else {
      const float m = ra > 0.0f ? 1.0f : 0.0f;
      const float x = ox * m, y = oy * m;
      float sag, ds;
      sag_dsag(s, x * x + y * y, sag, ds);
      nx = (ds * 2.0f) * x;
      ny = (ds * 2.0f) * y;
      const float inv_nrm = 1.0f / sqrtf((nx * nx + ny * ny) + 1.0f);
      nx = -nx * inv_nrm;
      ny = -ny * inv_nrm;
      nz = inv_nrm;
    }
    const float cosi = (dx * nx + dy * ny) + dz * nz;
    const float c2 = cosi * cosi;
    const bool vr = (c2 > 0.1f) && (s.eta2 * (1.0f - c2) < 1.0f) && (ra > 0.0f);
    const float vm = vr ? 1.0f : 0.0f;
    const float sr = sqrtf(1.0f - (s.eta2 * (1.0f - c2)) * vm);
    const float ndx = sr * nx + s.eta * (dx - cosi * nx);
    const float ndy = sr * ny + s.eta * (dy - cosi * ny);
    const float ndz = sr * nz + s.eta * (dz - cosi * nz);
    if (vr) {
      dx = ndx;
      dy = ndy;
      dz = ndz;
    }
    ra = ra * vm;
  }

  const float inv_dz = 1.0f / dz;
  const float t = (d_sensor - oz) * inv_dz;
  px[i] = -(ox + dx * t);
  py[i] = -(oy + dy * t);
  xt[i] = -dx * inv_dz;
  ra_out[i] = ra;
}

}  // namespace

extern "C" int fused_trace_sensor(const Plan* plan, const float* o,
                                  const float* d, const float* ra,
                                  float d_sensor, int64_t n, float* px,
                                  float* py, float* xt, float* ra_out,
                                  cudaStream_t stream) {
  if (plan->n_surf < 0 || plan->n_surf > MAX_SURF) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  fused_trace_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
      *plan, o, d, ra, d_sensor, n, px, py, xt, ra_out);
  return (int)cudaGetLastError();
}

extern "C" int fused_trace_plan_bytes() { return (int)sizeof(Plan); }
