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
// Design. One thread per ray, the whole chain in registers: only the seven
// inputs are read and the four outputs written, which is what the Pallas
// kernel keeps out of HBM. The lens is not compiled in (Pallas bakes it into
// each kernel; here that would mean one nvcc build per lens and wavelength):
// the host builds a table of per-surface constants
// (dp/fused_trace.py:_surface_table), each folded in double and rounded once
// to f32 exactly as the JAX code's Python-float arithmetic folds it, and
// passes it by value as a kernel parameter. Each block copies it to shared
// memory first: read straight from the parameter bank with a dynamic
// surface index, the constants may compile to uniform-datapath loads
// (ULDC), which ran markedly slower on the H100. Every thread reads the same
// surface at the same time, so the branch on the surface's path is
// warp-uniform. The ragged edge is masked here; nothing is padded. o and d
// are read through their strides as [rows, cols, 3] views, so the fit's
// origins, one point broadcast over its spp rays (stride 0), are never
// copied; ra is read as it lies.
//
// Instructions, not bytes, bound the kernel: every IEEE divide, reciprocal
// and square root is a MUFU op plus a refinement and a slow-path test, and
// an uncontracted multiply-add is two instructions (chip_smoke.py counts
// the SASS per ray). The arithmetic is written once, over a scalar type:
//  * Exact, for the surfaces up to and including the aperture stop
//    (Plan.n_exact): every operation rounds on its own (__fadd_rn,
//    __fmul_rn, never fused) and divides and roots are correctly rounded,
//    as in the plain PyTorch version (fused_trace_sensor_ref). The pupil
//    sampling aims the bundle's rim at the stop's edge, so there a rounding
//    decides validity (chip_smoke.py counts the rays that flip when the
//    stop is contracted too).
//  * float, for the surfaces after it: the build contracts multiply-adds
//    into FFMAs, and reciprocals and roots take the MUFU approximations.
//  * Both: the solves that polish their own result (the sphere seed's root
//    and 1/(2a), the divide of each Newton correction) take the
//    approximations too; their last bits do not reach the polished t.
// Validity rules, literals and NaN handling are those of the JAX code: 1/sqrt
// where JAX has lax.rsqrt, clips and maxima that let NaN through as
// jnp.clip / jnp.maximum do. chip_smoke.py holds the kernel to the JAX
// package's fused-trace gates against the plain version.
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
  int n_exact;  // surfaces 0 .. n_exact-1 take the Exact arithmetic
  Surf s[MAX_SURF];
};

namespace {

constexpr int PATH_PLANE = 0;    // flat stop: plane hit
constexpr int PATH_SPHERE = 1;   // pure sphere: polished quadratic, centre normal
constexpr int PATH_GENERAL = 2;  // even asphere: sphere seed + Newton

constexpr float EPS = 1e-9f;             // EPSILON
constexpr float STEP = 5.0f;             // NEWTON_STEP_BOUND
constexpr float TOL_TIGHT = 10e-6f;      // NEWTON_TOL_TIGHT

struct Ray {
  float ox, oy, oz, dx, dy, dz, ra;
};

// A float whose arithmetic rounds every operation on its own, as the plain
// PyTorch version does: the file is built with contraction on, and
// __fadd_rn / __fmul_rn are never fused into an FFMA.
struct Exact {
  float v;
  __device__ Exact(float x = 0.0f) : v(x) {}
};
__device__ __forceinline__ Exact operator+(Exact a, Exact b) { return __fadd_rn(a.v, b.v); }
__device__ __forceinline__ Exact operator-(Exact a, Exact b) { return __fsub_rn(a.v, b.v); }
__device__ __forceinline__ Exact operator*(Exact a, Exact b) { return __fmul_rn(a.v, b.v); }
__device__ __forceinline__ Exact operator-(Exact a) { return -a.v; }
__device__ __forceinline__ bool operator<(Exact a, Exact b) { return a.v < b.v; }
__device__ __forceinline__ bool operator>(Exact a, Exact b) { return a.v > b.v; }
__device__ __forceinline__ bool operator<=(Exact a, Exact b) { return a.v <= b.v; }
__device__ __forceinline__ bool operator>=(Exact a, Exact b) { return a.v >= b.v; }

__device__ __forceinline__ float value(Exact x) { return x.v; }
__device__ __forceinline__ float value(float x) { return x; }
__device__ __forceinline__ float abs_(float x) { return fabsf(x); }
__device__ __forceinline__ Exact abs_(Exact x) { return fabsf(x.v); }

// Exact: the correctly rounded forms, the same bits as 1.0f / x and sqrtf.
// float: the MUFU approximations (a few ulp), for the surfaces after the
// aperture stop, whose validity tests no rounding of this size moves.
__device__ __forceinline__ Exact rcp(Exact x) { return __frcp_rn(x.v); }
__device__ __forceinline__ Exact sqrt_(Exact x) { return __fsqrt_rn(x.v); }
__device__ __forceinline__ float rcp(float x) { return __fdividef(1.0f, x); }
__device__ __forceinline__ float sqrt_(float x) {
  float y;
  asm("sqrt.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Inside a solve that polishes its own result the approximations serve
// both kinds: the sphere seed's root and 1/(2a), and the divide of every
// Newton correction t - clip(f / f'), which is small against t.
template <typename T>
__device__ __forceinline__ T seed_sqrt(T x) { return sqrt_(value(x)); }
template <typename T>
__device__ __forceinline__ T half_rcp(T x) { return __fdividef(0.5f, value(x)); }
template <typename T>
__device__ __forceinline__ T step_div(T f, T df) { return __fdividef(value(f), value(df)); }

template <typename T>
__device__ __forceinline__ T clip_step(T x) {
  return x < T(-STEP) ? T(-STEP) : (x > T(STEP) ? T(STEP) : x);
}

template <typename T>
__device__ __forceinline__ T at_least(T x, float lo) {
  return x < T(lo) ? T(lo) : x;
}

// _sag_dsag: the sag and its derivative in r^2
template <typename T>
__device__ __forceinline__ void sag_dsag(const Surf& s, T r2, T& sag, T& dsag) {
  bool have = false;
  sag = 0.0f;
  dsag = 0.0f;
  if (s.has_c) {
    const T u = at_least(T(1.0f) - (s.opk * r2) * s.cc, 1e-24f);
    const T sf = sqrt_(u);
    const T inv_sf = rcp(sf);
    const T inv1 = rcp(T(1.0f) + sf);
    sag = (r2 * s.c) * inv1;
    dsag = ((((T(1.0f) + sf) + (T(1.0f) - u) * (T(0.5f) * inv_sf)) * s.c) * inv1) * inv1;
    have = true;
  }
  if (s.n_ai > 0) {
    T poly = s.ai[s.n_ai - 1];
    T dpoly = s.dai[s.n_ai - 1];
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
template <typename T>
__device__ __forceinline__ T sphere_seed(const Surf& s, T ox, T oy, T oz, T dx,
                                         T dy, T dz, T t_plane, bool polish) {
  if (!s.has_c) return t_plane;
  const T ocz = oz - s.cz;
  const T b = T(2.0f) * ((dx * ox + dy * oy) + dz * ocz);
  const T cc = ((ox * ox + oy * oy) + ocz * ocz) - s.rad2;
  T a = 1.0f, disc, inv2a;
  if (polish) {
    // the exact quadratic: |d| drifts ~1e-6 from unit along the chain
    a = (dx * dx + dy * dy) + dz * dz;
    disc = b * b - (T(4.0f) * a) * cc;
    inv2a = half_rcp(a);
  } else {
    disc = b * b - T(4.0f) * cc;
    inv2a = 0.5f;
  }
  const bool ok = disc > T(0.0f);
  const T sq = seed_sqrt(at_least(disc, 0.0f));
  const T t1 = (-b - sq) * inv2a;
  const T t2 = (-b + sq) * inv2a;
  T pick = abs_(t1 - t_plane) < abs_(t2 - t_plane) ? t1 : t2;
  if (polish) {
    // one Newton step on q(t) = a t^2 + b t + cc
    const T q = (a * pick + b) * pick + cc;
    pick = pick - clip_step(step_div(q, ((T(2.0f) * a) * pick + b) + EPS));
  }
  return ok ? pick : t_plane;
}

template <typename T>
__device__ __forceinline__ bool in_loose(const Surf& s, T r2) {
  return s.loose == 0 ? true : (s.loose == 1 ? r2 < T(s.bound) : r2 > T(0.0f));
}

template <typename T>
__device__ __forceinline__ bool in_tight(const Surf& s, T r2) {
  const bool in_ap = r2 < T(s.rap2);
  return s.tight ? (in_ap && r2 < T(s.bound)) : in_ap;
}

// ft(t) = sag(r^2(t)) + d - z(t) and its t-derivative, with the loose or
// tight validity mask zeroing r^2 of rays outside
template <typename T>
__device__ __forceinline__ void ft_dfdt(const Surf& s, T ox, T oy, T oz, T dx,
                                        T dy, T dz, bool live, T dxy2, T doxy,
                                        T t, bool tight, T& ft, T& dfdt) {
  const T x = ox + dx * t;
  const T y = oy + dy * t;
  const T z = oz + dz * t;
  const T r2_raw = x * x + y * y;
  const bool v = (tight ? in_tight(s, r2_raw) : in_loose(s, r2_raw)) && live;
  const T m = v ? 1.0f : 0.0f;
  const T xm = x * m, ym = y * m;
  const T r2 = xm * xm + ym * ym;
  T sag, dsag;
  sag_dsag(s, r2, sag, dsag);
  ft = (sag + s.d) - z;
  dfdt = dsag * (T(2.0f) * (dxy2 * t + doxy)) - dz;
}

// One surface: intersection, validity, refraction (the JAX _step_c), in
// the arithmetic of T
template <typename T>
__device__ __forceinline__ void trace_surface(const Surf& s, int maxiter, Ray& r) {
  const T ox = r.ox, oy = r.oy, oz = r.oz, dx = r.dx, dy = r.dy, dz = r.dz;
  T ra = r.ra;
  const T inv_dz = rcp(dz);
  const T t0 = (T(s.d) - oz) * inv_dz;
  const bool live = ra > T(0.0f);
  T nx_o, ny_o, nz_o, r2n;
  bool valid;
  if (s.path == PATH_PLANE) {
    nx_o = ox + dx * t0;
    ny_o = oy + dy * t0;
    nz_o = oz + dz * t0;
    r2n = nx_o * nx_o + ny_o * ny_o;
    valid = (r2n <= T(s.rap2)) && live;
  } else if (s.path == PATH_SPHERE) {
    // re-centred at the vertex plane, so every coefficient is O(R)
    const T oxp = ox + dx * t0;
    const T oyp = oy + dy * t0;
    const T ozp = oz + dz * t0;
    const T tp_loc = (T(s.d) - ozp) * inv_dz;
    const T t_loc = sphere_seed(s, oxp, oyp, ozp, dx, dy, dz, tp_loc, true);
    const T t = t0 + t_loc;
    nx_o = oxp + dx * t_loc;
    ny_o = oyp + dy * t_loc;
    nz_o = ozp + dz * t_loc;
    r2n = nx_o * nx_o + ny_o * ny_o;
    valid = (r2n <= T(s.rap2)) && (t >= T(0.0f)) && live;
  } else {
    const T dxy2 = dx * dx + dy * dy;
    const T doxy = dx * ox + dy * oy;
    T t = sphere_seed(s, ox, oy, oz, dx, dy, dz, t0, false);
    T ft, dfdt;
    if (s.newton) {
      for (int it = 0; it < maxiter; ++it) {
        ft_dfdt(s, ox, oy, oz, dx, dy, dz, live, dxy2, doxy, t, false, ft, dfdt);
        t = t - clip_step(step_div(ft, dfdt + EPS));
      }
    }
    // the tight polish; the tolerance test reads its pre-polish residual
    ft_dfdt(s, ox, oy, oz, dx, dy, dz, live, dxy2, doxy, t, true, ft, dfdt);
    t = t - clip_step(step_div(ft, dfdt + EPS));
    nx_o = ox + dx * t;
    ny_o = oy + dy * t;
    nz_o = oz + dz * t;
    r2n = nx_o * nx_o + ny_o * ny_o;
    if (s.vrule == 2) {
      valid = in_tight(s, r2n) && (abs_(ft) < T(TOL_TIGHT)) && live && (t > T(0.0f));
    } else if (s.vrule == 1) {
      valid = (r2n <= T(s.rap2)) && (t >= T(0.0f)) && live;
    } else {
      valid = (r2n <= T(s.rap2)) && live;
    }
  }
  const T px = valid ? nx_o : ox, py = valid ? ny_o : oy, pz = valid ? nz_o : oz;
  ra = ra * (valid ? 1.0f : 0.0f);
  r.ox = value(px);
  r.oy = value(py);
  r.oz = value(pz);
  r.ra = value(ra);
  if (s.skip) return;

  // Snell refraction, forward-oriented unit normal
  T nx, ny, nz;
  if (s.path == PATH_SPHERE) {
    if (s.has_c) {
      // exact: -(p - C) * c with C = (0, 0, d + 1/c)
      nx = -px * s.c;
      ny = -py * s.c;
      nz = T(s.nz0) - pz * s.c;
    } else {
      nx = 0.0f;
      ny = 0.0f;
      nz = 1.0f;
    }
  } else {
    const T m = ra > T(0.0f) ? 1.0f : 0.0f;
    const T x = px * m, y = py * m;
    T sag, ds;
    sag_dsag(s, x * x + y * y, sag, ds);
    nx = (ds * 2.0f) * x;
    ny = (ds * 2.0f) * y;
    const T inv_nrm = rcp(sqrt_((nx * nx + ny * ny) + 1.0f));
    nx = -nx * inv_nrm;
    ny = -ny * inv_nrm;
    nz = inv_nrm;
  }
  const T cosi = (dx * nx + dy * ny) + dz * nz;
  const T c2 = cosi * cosi;
  const bool vr = (c2 > T(0.1f)) && (T(s.eta2) * (T(1.0f) - c2) < T(1.0f)) && (ra > T(0.0f));
  const T vm = vr ? 1.0f : 0.0f;
  const T sr = sqrt_(T(1.0f) - (T(s.eta2) * (T(1.0f) - c2)) * vm);
  if (vr) {
    r.dx = value(sr * nx + T(s.eta) * (dx - cosi * nx));
    r.dy = value(sr * ny + T(s.eta) * (dy - cosi * ny));
    r.dz = value(sr * nz + T(s.eta) * (dz - cosi * nz));
  }
  r.ra = value(ra * vm);
}

// The four splat inputs at the sensor plane z = d_sensor (contracted)
__device__ __forceinline__ void to_sensor(const Ray& r, float d_sensor,
                                          float& px, float& py, float& xt) {
  const float inv_dz = __frcp_rn(r.dz);
  const float t = (d_sensor - r.oz) * inv_dz;
  px = -(r.ox + r.dx * t);
  py = -(r.oy + r.dy * t);
  xt = -r.dx * inv_dz;
}

// Ray i = row * cols + col; o and d element (row, col, k) at
// row * s0 + col * s1 + k. out holds px, py, x_tan, ra, n floats each.
// The block first copies the lens table from the parameter bank to shared
// memory: every thread then reads the same surface's constants with
// broadcast shared-memory loads, whatever the compiler makes of a
// dynamically indexed kernel parameter.
__global__ void __launch_bounds__(256)
fused_trace_kernel(const __grid_constant__ Plan plan, const float* __restrict__ o,
                   int64_t os0, int64_t os1, const float* __restrict__ d,
                   int64_t ds0, int64_t ds1, const float* __restrict__ ra_in,
                   int cols, float d_sensor, int n, float* __restrict__ out) {
  __shared__ Surf lens[MAX_SURF];
  const int words = plan.n_surf * (int)(sizeof(Surf) / sizeof(uint32_t));
  for (int k = threadIdx.x; k < words; k += blockDim.x)
    reinterpret_cast<uint32_t*>(lens)[k] = reinterpret_cast<const uint32_t*>(plan.s)[k];
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int row = i / cols;
  const int col = i - row * cols;
  const float* oi = o + row * os0 + col * os1;
  const float* di = d + row * ds0 + col * ds1;
  Ray r{oi[0], oi[1], oi[2], di[0], di[1], di[2], ra_in[i]};
  for (int si = 0; si < plan.n_surf; ++si) {
    if (si < plan.n_exact)
      trace_surface<Exact>(lens[si], plan.maxiter, r);
    else
      trace_surface<float>(lens[si], plan.maxiter, r);
  }
  float px, py, xt;
  to_sensor(r, d_sensor, px, py, xt);
  out[i] = px;
  out[n + i] = py;
  out[2 * (int64_t)n + i] = xt;
  out[3 * (int64_t)n + i] = r.ra;
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a plan or bundle the kernel does not take.
extern "C" int fused_trace_sensor(const Plan* plan, const float* o, int64_t os0,
                                  int64_t os1, const float* d, int64_t ds0,
                                  int64_t ds1, const float* ra, int cols,
                                  float d_sensor, int n, float* out,
                                  cudaStream_t stream) {
  if (plan->n_surf < 0 || plan->n_surf > MAX_SURF || n < 0 || cols <= 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int threads = 256;
  const int blocks = (int)(((int64_t)n + threads - 1) / threads);
  fused_trace_kernel<<<blocks, threads, 0, stream>>>(
      *plan, o, os0, os1, d, ds0, ds1, ra, cols, d_sensor, n, out);
  return (int)cudaGetLastError();
}

extern "C" int fused_trace_plan_bytes() { return (int)sizeof(Plan); }
