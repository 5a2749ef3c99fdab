"""Fused ray trace to the sensor (K1), for the DP-PSF path.

Hopper counterpart of sdirt_tpu/dp/fused_trace.py (fused_trace_sensor). A
[spp, N] ray bundle goes through the whole surface chain of one lens at one
wavelength and comes out as the four splat inputs at the sensor plane:
px, py (the sensor point, sign-flipped), x_tan = -dx/dz and ra.

The CUDA source is ../csrc/fused_trace.cu (one thread per ray; its header
comment has the design and the bound), built and loaded by utils/kernels.py.
The lens reaches the kernel as a table of per-surface constants
(``_surface_table``), each folded in double and rounded once to f32 as the
JAX code's Python-float arithmetic folds it, so neither the kernel nor its
plain version depends on how the lens was compiled.

On a CUDA tensor the wrapper launches the kernel or raises; only rays on the
CPU take the plain PyTorch version, ``fused_trace_sensor_ref`` (the JAX
package's ``_step_c`` arithmetic, one surface at a time, from the same
table), which is also what the kernel is held against on the card.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from ..core.constants import (EPSILON, MAX_AI_TERMS, NEWTON_FAST_ITERS,
                              NEWTON_STEP_BOUND, NEWTON_TOL_TIGHT)
from ..core.rays import Rays
from ..optics.surfaces import (KIND_ASPHERIC, KIND_SPHERIC, KIND_STOP,
                               _loose_bound, _tight_bound)
from ..utils import kernels

MAX_SURF = 24          # csrc/fused_trace.cu: MAX_SURF (the table is a kernel parameter)
PATH_PLANE, PATH_SPHERE, PATH_GENERAL = 0, 1, 2
_LOOSE = {"all": 0, "lt": 1, "gt0": 2}

# launches of the CUDA kernel in this process (not of the plain version)
launches = 0


@dataclasses.dataclass(frozen=True)
class FusedPlan:
    """Hashable trace plan: surface chain + per-surface eta.

    surfaces: optics.surfaces.static_surface_desc(...) tuple
    eta:      per-surface refraction ratios (Python floats; wavelength baked)
    """

    surfaces: tuple
    eta: tuple


def make_fused_plan(lens, wvln: float = 0.589) -> FusedPlan:
    """The plan of one lens at one wavelength."""
    eta, _ = lens.eta_arrays(wvln, True)
    return FusedPlan(surfaces=lens.static_desc(),
                     eta=tuple(float(e) for e in eta.cpu().numpy()))


def _f32(x) -> float:
    return float(np.float32(x))


def _surface_consts(surf: tuple, eta: float) -> dict:
    """One surface of the kernel's table: its path, validity rules and the
    f32 constants of csrc/fused_trace.cu:Surf. Each constant is the double
    expression the JAX code folds in Python (e.g. ``(1.0 + k)``, ``c * c``,
    ``d + 1/c``, ``r_ap * r_ap``), rounded once to f32."""
    kind, c, k, ai, d_surf, r_ap, skip = surf
    n_ai = max((i + 1 for i, a in enumerate(ai) if a != 0.0), default=0)
    pure_sphere = kind == KIND_SPHERIC and k == 0.0 and not any(ai)
    if kind == KIND_STOP and c == 0.0 and not any(ai):
        path = PATH_PLANE
    elif pure_sphere:
        path = PATH_SPHERE
    else:
        path = PATH_GENERAL
    loose, bound = _loose_bound(c, k)
    tight = _tight_bound(c, k)
    radius = 1.0 / c if c != 0.0 else 0.0
    dai = [0.0] * MAX_AI_TERMS
    if n_ai:
        dai[n_ai - 1] = n_ai * ai[n_ai - 1]
        for i in range(n_ai - 1):
            dai[i] = (i + 1) * ai[i]
    return {
        "path": path,
        "newton": int(kind == KIND_ASPHERIC or k != 0.0 or any(ai)),
        "has_c": int(c != 0.0), "n_ai": n_ai, "loose": _LOOSE[loose],
        "tight": int(tight is not None),
        "vrule": {KIND_STOP: 0, KIND_SPHERIC: 1, KIND_ASPHERIC: 2}[kind],
        "skip": int(skip),
        "c": _f32(c), "opk": _f32(1.0 + k), "cc": _f32(c * c),
        "cz": _f32(d_surf + radius), "rad2": _f32(radius * radius),
        "d": _f32(d_surf), "rap2": _f32(r_ap * r_ap),
        "bound": _f32(tight if tight is not None else bound),
        "nz0": _f32(1.0 + d_surf * c), "eta": _f32(eta), "eta2": _f32(eta * eta),
        "ai": tuple(_f32(a) for a in ai), "dai": tuple(_f32(a) for a in dai),
    }


@functools.lru_cache(maxsize=64)
def _surface_table(plan: FusedPlan) -> tuple:
    if len(plan.surfaces) > MAX_SURF:
        raise ValueError(f"the fused trace takes at most {MAX_SURF} surfaces, "
                         f"got {len(plan.surfaces)}")
    return tuple(_surface_consts(s, e) for s, e in zip(plan.surfaces, plan.eta))


# ---------------------------------------------------------------------------
# Plain version: _step_c's arithmetic in torch ops (f32), from the same table
# ---------------------------------------------------------------------------

def _sag_dsag(r2, s):
    sag = dsag = None
    if s["has_c"]:
        u = torch.clamp(1.0 - (s["opk"] * r2) * s["cc"], min=1e-24)
        sf = torch.sqrt(u)
        inv_sf = 1.0 / sf
        inv1 = 1.0 / (1.0 + sf)
        sag = r2 * s["c"] * inv1
        dsag = (1.0 + sf + (1.0 - u) * (0.5 * inv_sf)) * s["c"] * inv1 * inv1
    n_ai = s["n_ai"]
    if n_ai:
        poly = torch.full_like(r2, s["ai"][n_ai - 1])
        dpoly = torch.full_like(r2, s["dai"][n_ai - 1])
        for i in range(n_ai - 2, -1, -1):
            poly = poly * r2 + s["ai"][i]
            dpoly = dpoly * r2 + s["dai"][i]
        sag = poly * r2 if sag is None else sag + poly * r2
        dsag = dpoly if dsag is None else dsag + dpoly
    if sag is None:
        sag = dsag = torch.zeros_like(r2)
    return sag, dsag


def _clip_step(x):
    return torch.clamp(x, -NEWTON_STEP_BOUND, NEWTON_STEP_BOUND)


def _sphere_seed(ox, oy, oz, dx, dy, dz, s, t_plane, polish: bool):
    if not s["has_c"]:
        return t_plane
    ocz = oz - s["cz"]
    b = 2.0 * (dx * ox + dy * oy + dz * ocz)
    cc = ox * ox + oy * oy + ocz * ocz - s["rad2"]
    if polish:
        a = dx * dx + dy * dy + dz * dz
        disc = b * b - 4.0 * a * cc
        inv2a = 0.5 / a
    else:
        disc = b * b - 4.0 * cc
        inv2a = 0.5
    ok = disc > 0.0
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t1 = (-b - sq) * inv2a
    t2 = (-b + sq) * inv2a
    pick = torch.where(torch.abs(t1 - t_plane) < torch.abs(t2 - t_plane), t1, t2)
    if polish:
        q = (a * pick + b) * pick + cc
        pick = pick - _clip_step(q / (2.0 * a * pick + b + EPSILON))
    return torch.where(ok, pick, t_plane)


def _in_loose(r2, s):
    if s["loose"] == 0:
        return torch.ones_like(r2, dtype=torch.bool)
    return r2 < s["bound"] if s["loose"] == 1 else r2 > 0.0


def _in_tight(r2, s):
    in_ap = r2 < s["rap2"]
    return in_ap & (r2 < s["bound"]) if s["tight"] else in_ap


def _step_ref(ox, oy, oz, dx, dy, dz, ra, s, maxiter: int):
    inv_dz = 1.0 / dz
    t0 = (s["d"] - oz) * inv_dz
    live = ra > 0
    if s["path"] == PATH_PLANE:
        nx_o, ny_o, nz_o = ox + dx * t0, oy + dy * t0, oz + dz * t0
        r2n = nx_o * nx_o + ny_o * ny_o
        valid = (r2n <= s["rap2"]) & live
    elif s["path"] == PATH_SPHERE:
        oxp, oyp, ozp = ox + dx * t0, oy + dy * t0, oz + dz * t0
        tp_loc = (s["d"] - ozp) * inv_dz
        t_loc = _sphere_seed(oxp, oyp, ozp, dx, dy, dz, s, tp_loc, polish=True)
        t = t0 + t_loc
        nx_o, ny_o, nz_o = oxp + dx * t_loc, oyp + dy * t_loc, ozp + dz * t_loc
        r2n = nx_o * nx_o + ny_o * ny_o
        valid = (r2n <= s["rap2"]) & (t >= 0) & live
    else:
        dxy2 = dx * dx + dy * dy
        doxy = dx * ox + dy * oy

        def ft_dfdt(t, tight: bool):
            x, y, z = ox + dx * t, oy + dy * t, oz + dz * t
            r2_raw = x * x + y * y
            v = (_in_tight(r2_raw, s) if tight else _in_loose(r2_raw, s)) & live
            m = v.to(x.dtype)
            xm, ym = x * m, y * m
            sag, dsag = _sag_dsag(xm * xm + ym * ym, s)
            ft = sag + s["d"] - z
            dfdt = dsag * (2.0 * (dxy2 * t + doxy)) - dz
            return ft, dfdt

        t = _sphere_seed(ox, oy, oz, dx, dy, dz, s, t0, polish=False)
        if s["newton"]:
            for _ in range(maxiter):
                ft, dfdt = ft_dfdt(t, tight=False)
                t = t - _clip_step(ft / (dfdt + EPSILON))
        ft_d, dfdt = ft_dfdt(t, tight=True)
        t = t - _clip_step(ft_d / (dfdt + EPSILON))
        nx_o, ny_o, nz_o = ox + dx * t, oy + dy * t, oz + dz * t
        r2n = nx_o * nx_o + ny_o * ny_o
        if s["vrule"] == 2:
            valid = (_in_tight(r2n, s) & (torch.abs(ft_d) < NEWTON_TOL_TIGHT)
                     & live & (t > 0))
        elif s["vrule"] == 1:
            valid = (r2n <= s["rap2"]) & (t >= 0) & live
        else:
            valid = (r2n <= s["rap2"]) & live

    ox = torch.where(valid, nx_o, ox)
    oy = torch.where(valid, ny_o, oy)
    oz = torch.where(valid, nz_o, oz)
    ra = ra * valid.to(ra.dtype)
    if s["skip"]:
        return ox, oy, oz, dx, dy, dz, ra

    if s["path"] == PATH_SPHERE and s["has_c"]:
        nx = -ox * s["c"]
        ny = -oy * s["c"]
        nz = s["nz0"] - oz * s["c"]
    elif s["path"] == PATH_SPHERE:
        nx = ny = torch.zeros_like(ox)
        nz = torch.ones_like(ox)
    else:
        m = (ra > 0).to(dx.dtype)
        x, y = ox * m, oy * m
        ds = _sag_dsag(x * x + y * y, s)[1]
        nx = ds * 2.0 * x
        ny = ds * 2.0 * y
        inv_nrm = 1.0 / torch.sqrt(nx * nx + ny * ny + 1.0)
        nx = -nx * inv_nrm
        ny = -ny * inv_nrm
        nz = inv_nrm
    cosi = dx * nx + dy * ny + dz * nz
    c2 = cosi * cosi
    valid_r = (c2 > 0.1) & (s["eta2"] * (1.0 - c2) < 1.0) & (ra > 0)
    vm = valid_r.to(dx.dtype)
    sr = torch.sqrt(1.0 - s["eta2"] * (1.0 - c2) * vm)
    ndx = sr * nx + s["eta"] * (dx - cosi * nx)
    ndy = sr * ny + s["eta"] * (dy - cosi * ny)
    ndz = sr * nz + s["eta"] * (dz - cosi * nz)
    dx = torch.where(valid_r, ndx, dx)
    dy = torch.where(valid_r, ndy, dy)
    dz = torch.where(valid_r, ndz, dz)
    return ox, oy, oz, dx, dy, dz, ra * vm


def _check(rays: Rays):
    o, d, ra = rays.o, rays.d, rays.ra
    if o.shape[-1] != 3 or d.shape != o.shape or ra.shape != o.shape[:-1]:
        raise ValueError(f"rays must be o, d [..., 3] and ra [...], got "
                         f"{tuple(o.shape)}, {tuple(d.shape)}, {tuple(ra.shape)}")
    if not (o.device == d.device == ra.device):
        raise ValueError(f"rays on {o.device}, {d.device}, {ra.device}")
    if {o.dtype, d.dtype, ra.dtype} != {torch.float32}:
        raise TypeError(f"rays must be float32, got {o.dtype}, {d.dtype}, {ra.dtype}")


def fused_trace_sensor_ref(rays: Rays, d_sensor, plan: FusedPlan,
                           maxiter: int = NEWTON_FAST_ITERS):
    """Plain PyTorch version of fused_trace_sensor: the same arithmetic,
    one surface at a time, as elementwise torch ops in f32."""
    _check(rays)
    ox, oy, oz = rays.o.unbind(-1)
    dx, dy, dz = rays.d.unbind(-1)
    ra = rays.ra
    for s in _surface_table(plan):
        ox, oy, oz, dx, dy, dz, ra = _step_ref(ox, oy, oz, dx, dy, dz, ra, s, maxiter)
    inv_dz = 1.0 / dz
    t = (_f32(d_sensor) - oz) * inv_dz
    return -(ox + dx * t), -(oy + dy * t), -dx * inv_dz, ra


# ---------------------------------------------------------------------------
# The CUDA kernel
# ---------------------------------------------------------------------------

class _Surf(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_int) for n in ("path", "newton", "has_c", "n_ai",
                                              "loose", "tight", "vrule", "skip")]
                + [(n, ctypes.c_float) for n in ("c", "opk", "cc", "cz", "rad2",
                                                "d", "rap2", "bound", "nz0",
                                                "eta", "eta2")]
                + [("ai", ctypes.c_float * MAX_AI_TERMS),
                   ("dai", ctypes.c_float * MAX_AI_TERMS)])


class _Plan(ctypes.Structure):
    _fields_ = [("n_surf", ctypes.c_int), ("maxiter", ctypes.c_int),
                ("n_exact", ctypes.c_int), ("s", _Surf * MAX_SURF)]


def exact_surfaces(plan: FusedPlan) -> int:
    """How many leading surfaces the kernel traces with the plain version's
    roundings: through the aperture stop (the last stop surface), whose
    edge the pupil sampling aims the bundle's rim at, so that there a
    rounding decides a ray's validity."""
    stops = [i for i, surf in enumerate(plan.surfaces) if surf[0] == KIND_STOP]
    return stops[-1] + 1 if stops else 0


@functools.lru_cache(maxsize=64)
def _plan_arg(plan: FusedPlan, maxiter: int) -> ctypes.c_void_p:
    """The kernel's Plan struct for one plan, packed once and kept alive by
    this cache, as the pointer the C entry point takes."""
    table = _surface_table(plan)
    st = _Plan(n_surf=len(table), maxiter=maxiter, n_exact=exact_surfaces(plan))
    for dst, s in zip(st.s, table):
        for name, value in s.items():
            if name in ("ai", "dai"):
                getattr(dst, name)[:] = value
            else:
                setattr(dst, name, value)
    arg = ctypes.c_void_p(ctypes.addressof(st))
    arg._keep = st
    return arg


_ARGTYPES = ([ctypes.c_void_p] + [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64] * 2
             + [ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p])


@functools.cache
def _kernel():
    lib = kernels.library("fused_trace")
    if lib.fused_trace_plan_bytes() != ctypes.sizeof(_Plan):
        raise RuntimeError("csrc/fused_trace.cu:Plan and _Plan differ in size")
    fn = lib.fused_trace_sensor
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def _rows(v: torch.Tensor, cols: int) -> torch.Tensor:
    """v [..., 3] as a [rows, cols, 3] view with unit stride on the last
    axis: no copy for the [spp, N, 3] bundles of the fit, broadcast or not."""
    if v.dim() != 3 or v.shape[1] != cols:
        v = v.reshape(-1, cols, 3)
    return v if v.stride(2) == 1 else v.contiguous()


_last_plan: list = [None, 0, None]    # (plan, maxiter, _plan_arg) of the last call


def fused_trace_sensor(rays: Rays, d_sensor, plan: FusedPlan,
                       maxiter: int = NEWTON_FAST_ITERS):
    """Trace a [spp, N] bundle to the sensor plane z = d_sensor in one kernel.

    Returns (px, py, x_tan, ra), each shaped like rays.ra: the sensor point,
    sign-flipped, the flipped incidence slope -dx/dz, and the validity.
    """
    global launches
    _check(rays)
    dev = rays.o.device
    if dev.type == "cpu":
        return fused_trace_sensor_ref(rays, d_sensor, plan, maxiter)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return fused_trace_sensor(rays, d_sensor, plan, maxiter)
    shape = rays.ra.shape
    n = rays.ra.numel()
    if n >= 2 ** 31:
        raise ValueError(f"the fused trace takes fewer than 2^31 rays, got {n}")
    cols = shape[-1] if shape and shape[-1] > 0 else 1
    o, d = _rows(rays.o, cols), _rows(rays.d, cols)
    ra = rays.ra if rays.ra.is_contiguous() else rays.ra.contiguous()
    out = torch.empty((4, *shape), dtype=torch.float32, device=dev)
    if n == 0:
        return out.unbind(0)
    # a fit calls with one plan: the identity test spares hashing it
    if _last_plan[0] is not plan or _last_plan[1] != maxiter:
        _last_plan[:] = [plan, maxiter, _plan_arg(plan, int(maxiter))]
    # torch.cuda.current_stream(dev).cuda_stream, without building a Stream
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    rc = _kernel()(_last_plan[2], o.data_ptr(), o.stride(0), o.stride(1),
                   d.data_ptr(), d.stride(0), d.stride(1), ra.data_ptr(), cols,
                   _f32(d_sensor), n, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"fused_trace_sensor launch failed: CUDA error {rc}")
    launches += 1
    return out.unbind(0)


# ---------------------------------------------------------------------------
# Operation count, for the kernel's bound
# ---------------------------------------------------------------------------

def _ops_sag_dsag(s, sag: bool = True) -> int:
    m, hc = s["n_ai"], s["has_c"]
    ops = (16 if sag else 14) if hc else 0
    if m:
        ops += 2 * (m - 1) * (2 if sag else 1) + (1 if hc else 0)
        if sag:
            ops += 2 if hc else 1
    return ops


def ops_per_ray(plan: FusedPlan, maxiter: int = NEWTON_FAST_ITERS) -> int:
    """f32 operations of one live ray through the kernel, counted from
    csrc/fused_trace.cu: each add, subtract, multiply, divide, square root
    and negation is one; comparisons, selects and absolute values are not
    counted. A dead ray does the same arithmetic (the masks select)."""
    ops = 11                                   # propagation to the sensor, outputs
    for s in _surface_table(plan):
        ops += 3 + 1                           # t0, and ra * valid
        if s["path"] == PATH_PLANE:
            ops += 9
        elif s["path"] == PATH_SPHERE:
            ops += 59 if s["has_c"] else 18
        else:
            newton = 21 + _ops_sag_dsag(s) + 3
            ops += 6 + (24 if s["has_c"] else 0) + 9
            ops += newton * ((maxiter if s["newton"] else 0) + 1)
        if s["skip"]:
            continue
        if s["path"] == PATH_SPHERE:
            ops += 6 if s["has_c"] else 0
        else:
            ops += 18 + _ops_sag_dsag(s, sag=False)
        ops += 28
    return ops
