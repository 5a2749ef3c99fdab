"""Stacked optical surfaces and the differentiable per-surface trace
(PyTorch counterpart of sdirt_tpu/optics/surfaces.py).

A lens is one ``SurfaceStack`` of stacked parameter tensors. Tracing walks
the surfaces in a Python loop (the JAX package's ``lax.scan``); every
surface runs the same masked math as in JAX: a sphere-seeded Newton
intersection, the per-kind validity rule, then Snell refraction.

Gradients follow the JAX code: the Newton iterations run detached, and one
more differentiable iteration re-attaches the graph, so the intersection's
gradient with respect to the surface parameters and the rays is exact
without unrolling the solver.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core.constants import (EPSILON, MAX_AI_TERMS, NEWTON_FAST_ITERS,
                              NEWTON_STEP_BOUND, NEWTON_TOL_TIGHT)
from ..core.rays import Rays, normalize

# Surface kinds (their validity rules differ)
KIND_STOP = 0      # flat plane / aperture stop (c == 0)
KIND_SPHERIC = 1   # c != 0, k == 0, no aspheric terms
KIND_ASPHERIC = 2  # general even asphere


@dataclasses.dataclass(frozen=True)
class SurfaceStack:
    """Stacked surface parameters for a lens with S surfaces.

    c [S] curvature (1/roc); k [S] conic constant; ai [S, MAX_AI_TERMS]
    even-asphere coefficients a2..a16 (zero padded); d [S] vertex z [mm];
    r [S] clear aperture radius [mm]; kind [S] int32 surface kind.
    """

    c: torch.Tensor
    k: torch.Tensor
    ai: torch.Tensor
    d: torch.Tensor
    r: torch.Tensor
    kind: torch.Tensor

    @property
    def num_surfaces(self) -> int:
        return self.c.shape[0]

    @staticmethod
    def from_lists(c, k, ai_lists, d, r, kinds, device="cpu") -> "SurfaceStack":
        ai = np.zeros((len(c), MAX_AI_TERMS), np.float32)
        for i, terms in enumerate(ai_lists):
            if terms:
                ai[i, : len(terms)] = np.asarray(terms, np.float32)
        f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
        return SurfaceStack(c=f32(c), k=f32(k), ai=torch.from_numpy(ai).to(device),
                            d=f32(d), r=f32(r),
                            kind=torch.tensor(np.asarray(kinds, np.int32),
                                              device=device))

    def replace(self, **kw) -> "SurfaceStack":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Sag and derivatives
# ---------------------------------------------------------------------------

def sag_r2(r2, c, k, ai):
    """Even-asphere sag g(r^2) = c r^2 / (1 + sqrt(1-(1+k) c^2 r^2)) + sum a_i r^(2i)."""
    sf = torch.sqrt(torch.clamp(1.0 - (1.0 + k) * r2 * c * c, min=1e-24))
    base = r2 * c / (1.0 + sf)
    poly = ai[..., MAX_AI_TERMS - 1]
    for i in range(MAX_AI_TERMS - 2, -1, -1):
        poly = poly * r2 + ai[..., i]
    return base + poly * r2


def dsag_dr2(r2, c, k, ai):
    """d g / d r^2."""
    cc = c * c
    sf = torch.sqrt(torch.clamp(1.0 - (1.0 + k) * r2 * cc, min=1e-24))
    ds = (1.0 + sf + (1.0 + k) * r2 * cc / (2.0 * sf)) * c / (1.0 + sf) ** 2
    poly = MAX_AI_TERMS * ai[..., MAX_AI_TERMS - 1]
    for i in range(MAX_AI_TERMS - 2, -1, -1):
        poly = poly * r2 + (i + 1) * ai[..., i]
    return ds + poly


def _r2_bound(c, k):
    """Largest r^2 for which the conic sqrt stays real."""
    denom = c * c * (1.0 + k)
    bound = (1.0 - EPSILON) / torch.where(denom == 0.0, 1.0, denom)
    return torch.where(denom == 0.0, torch.inf, bound)


def _valid_loose(r2, c, k):
    """Shape-defined region only."""
    return torch.where(k > -1.0, r2 < _r2_bound(c, k), r2 > 0.0)


def _valid_tight(r2, c, k, r_ap):
    """Shape-defined AND inside the clear aperture."""
    in_ap = r2 < r_ap * r_ap
    return torch.where(k > -1.0, in_ap & (r2 < _r2_bound(c, k)), in_ap)


# ---------------------------------------------------------------------------
# Newton intersection + Snell refraction for one surface (all rays at once)
# ---------------------------------------------------------------------------

def _sphere_seed(o, dvec, c, d_surf, t_plane):
    """Closed-form intersection with the osculating sphere (radius 1/c,
    centre z = d + 1/c), the Newton seed; the plane seed where c == 0 or
    the sphere is missed."""
    inv_c = 1.0 / torch.where(c == 0.0, 1.0, c)
    cz = d_surf + inv_c
    oc_x, oc_y = o[..., 0], o[..., 1]
    oc_z = o[..., 2] - cz
    b = 2.0 * (dvec[..., 0] * oc_x + dvec[..., 1] * oc_y + dvec[..., 2] * oc_z)
    cc = oc_x ** 2 + oc_y ** 2 + oc_z ** 2 - inv_c ** 2
    disc = b * b - 4.0 * cc
    ok = (disc > 0.0) & (c != 0.0)
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t1 = (-b - sq) / 2.0
    t2 = (-b + sq) / 2.0
    # the lens surface is the hemisphere nearest the vertex plane
    pick = torch.where(torch.abs(t1 - t_plane) < torch.abs(t2 - t_plane), t1, t2)
    return torch.where(ok, pick, t_plane)


def _newton_t(o, dvec, ra, c, k, ai, d_surf, r_ap, maxiter: int = NEWTON_FAST_ITERS):
    """Solve o_z + d_z t = d_surf + g(x(t), y(t)) for every ray.

    Returns (t, ft_detached); t carries gradients through exactly one
    Newton step.
    """
    dz = dvec[..., 2]
    t0 = (d_surf - o[..., 2]) / dz
    dxy2 = dvec[..., 0] ** 2 + dvec[..., 1] ** 2
    doxy = dvec[..., 0] * o[..., 0] + dvec[..., 1] * o[..., 1]

    def ft_dfdt(t, tight: bool):
        new_o = o + dvec * t[..., None]
        x, y = new_o[..., 0], new_o[..., 1]
        r2_raw = x * x + y * y
        valid = _valid_tight(r2_raw, c, k, r_ap) if tight else _valid_loose(r2_raw, c, k)
        m = (valid & (ra > 0)).to(x.dtype)
        r2 = (x * m) ** 2 + (y * m) ** 2
        ft = sag_r2(r2, c, k, ai) + d_surf - new_o[..., 2]
        dr2dt = 2.0 * (dxy2 * t + doxy)
        dfdt = dsag_dr2(r2, c, k, ai) * dr2dt - dz
        return ft, dfdt

    with torch.no_grad():
        t_ng = _sphere_seed(o, dvec, c, d_surf, t0)
        for _ in range(maxiter):
            ft, dfdt = ft_dfdt(t_ng, tight=False)
            t_ng = t_ng - torch.clamp(ft / (dfdt + EPSILON),
                                      -NEWTON_STEP_BOUND, NEWTON_STEP_BOUND)
        t1 = t_ng - t0
    # one differentiable iteration re-attaches the graph
    t = t0 + t1
    ft, dfdt = ft_dfdt(t, tight=True)
    t = t - torch.clamp(ft / (dfdt + EPSILON), -NEWTON_STEP_BOUND, NEWTON_STEP_BOUND)
    return t, ft.detach()


def _refract(o_new, dvec, ra, c, k, ai, eta, forward: bool):
    """Snell refraction with validity masking."""
    m = (ra > 0).to(dvec.dtype)
    x = o_new[..., 0] * m
    y = o_new[..., 1] * m
    ds = dsag_dr2(x * x + y * y, c, k, ai)
    n = normalize(torch.stack([ds * 2.0 * x, ds * 2.0 * y, -torch.ones_like(x)], dim=-1))
    if forward:
        n = -n
    cosi = torch.sum(dvec * n, dim=-1)
    valid = (cosi ** 2 > 0.1) & (eta ** 2 * (1.0 - cosi ** 2) < 1.0) & (ra > 0)
    vm = valid.to(dvec.dtype)
    eta_v = eta[..., None]          # against the vectors' last axis
    sr = torch.sqrt(1.0 - eta_v ** 2 * (1.0 - cosi[..., None] ** 2) * vm[..., None])
    new_d = sr * n + eta_v * (dvec - cosi[..., None] * n)
    return torch.where(valid[..., None], new_d, dvec), ra * vm


def surface_step(rays: Rays, p: dict, forward: bool = True,
                 maxiter: int = NEWTON_FAST_ITERS) -> Rays:
    """Intersection + refraction with one surface.

    p: c, k, d, r, eta (0-d tensors), ai [MAX_AI_TERMS], kind (int) and
    skip (bool: a stop in air, which does not refract); for a coherent
    bundle also n_in and k_wave (0-d f32 tensors: the incidence medium's
    index and 2 pi / wavelength per mm).
    """
    c, k, ai, d_surf, r_ap = p["c"], p["k"], p["ai"], p["d"], p["r"]
    o, dvec, ra = rays.o, rays.d, rays.ra
    t, ft_d = _newton_t(o, dvec, ra, c, k, ai, d_surf, r_ap, maxiter)
    new_o = o + dvec * t[..., None]
    r2n = (new_o[..., 0] ** 2 + new_o[..., 1] ** 2).detach()
    t_d = t.detach()
    live = ra > 0
    if p["kind"] == KIND_STOP:
        valid = (torch.sqrt(r2n) <= r_ap) & live
    elif p["kind"] == KIND_SPHERIC:
        valid = (r2n <= r_ap * r_ap) & (t_d >= 0) & live
    else:
        valid = (_valid_tight(r2n, c, k, r_ap) & (torch.abs(ft_d) < NEWTON_TOL_TIGHT)
                 & live & (t_d > 0))
    o_out = torch.where(valid[..., None], new_o, o)
    ra_mid = ra * valid.to(ra.dtype)
    coh = {"opl": rays.opl, "phi": rays.phi}
    if "n_in" in p:
        # optical path n_in t, and its phase reduced per surface so f32 stays
        # accurate at any object distance (the common minimum path is a
        # global phase and cancels in |amplitude|^2)
        n_in = p["n_in"]
        dphi = torch.remainder(n_in * p["k_wave"] * (t - t_d.amin(dim=0)),
                               2.0 * math.pi)
        coh = {"opl": torch.where(valid, rays.opl + n_in * t, rays.opl),
               "phi": torch.where(valid, rays.phi + dphi, rays.phi)}
    if p["skip"]:
        return Rays(o=o_out, d=dvec, ra=ra_mid, **coh)
    d_out, ra_out = _refract(o_out, dvec, ra_mid, c, k, ai, p["eta"], forward)
    return Rays(o=o_out, d=d_out, ra=ra_out, **coh)


def trace_rays(rays: Rays, stack: SurfaceStack, eta: torch.Tensor, skip,
               forward: bool = True, maxiter: int = NEWTON_FAST_ITERS,
               n_in=None, coherent: bool = False, wvln: float = 0.589,
               record: bool = False):
    """Trace a ray bundle through all surfaces, in order (forward) or in
    reverse (backward). eta[S]: per-surface refraction ratio n_in/n_out in
    the given direction, or eta[S, B, 1, ...] to broadcast against ra for a
    bundle whose leading axis holds B wavelengths; skip[S]: stops in air
    that do not refract (the same at every wavelength).

    coherent=True also accumulates opl and the per-surface-reduced phase
    for the wavelength wvln [um]; n_in[S] is then each surface's incidence
    index (Lens.n_in_array). record=True returns (rays, o [S, ..., 3],
    ra [S, ...]): positions and validity after every surface, in the order
    traced.
    """
    kinds = stack.kind.tolist()
    skips = [bool(s > 0) for s in torch.as_tensor(skip).tolist()]
    if coherent:
        if n_in is None:
            raise ValueError("coherent tracing needs the per-surface n_in")
        if not rays.coherent:
            zero = torch.zeros_like(rays.ra)
            rays = rays.replace(opl=zero, phi=zero)
        n_in = torch.as_tensor(n_in, dtype=torch.float32, device=rays.o.device)
        k_wave = torch.tensor(2.0 * math.pi / (wvln * 1e-3), dtype=torch.float32,
                              device=rays.o.device)
    order = range(stack.num_surfaces)
    os_, ras = [], []
    for i in (order if forward else reversed(order)):
        p = {"c": stack.c[i], "k": stack.k[i], "ai": stack.ai[i],
             "d": stack.d[i], "r": stack.r[i], "eta": eta[i],
             "kind": kinds[i], "skip": skips[i]}
        if coherent:
            p.update(n_in=n_in[i], k_wave=k_wave)
        rays = surface_step(rays, p, forward=forward, maxiter=maxiter)
        if record:
            os_.append(rays.o)
            ras.append(rays.ra)
    if record:
        return rays, torch.stack(os_), torch.stack(ras)
    return rays


# ---------------------------------------------------------------------------
# Static description, for the fused trace's plan (dp/fused_trace.py)
# ---------------------------------------------------------------------------

def static_surface_desc(stack: SurfaceStack, skip) -> tuple:
    """Hashable per-surface description: (kind, c, k, ai, d, r, skip) with
    the f32 values as Python floats. Reads the stack back to the host."""
    c, k, ai, d, r = (a.detach().cpu().numpy() for a in
                      (stack.c, stack.k, stack.ai, stack.d, stack.r))
    kind = stack.kind.cpu().numpy()
    skip = np.asarray(torch.as_tensor(skip).cpu())
    return tuple(
        (int(kind[i]), float(c[i]), float(k[i]), tuple(float(a) for a in ai[i]),
         float(d[i]), float(r[i]), bool(skip[i] > 0))
        for i in range(c.shape[0]))


def _loose_bound(c: float, k: float):
    """The loose (shape-only) validity rule of a static surface, as
    ("all" | "lt" | "gt0", bound): r2 always valid, r2 < bound, r2 > 0."""
    if c == 0.0:
        return "all", 0.0
    denom = c * c * (1.0 + k)
    if denom == 0.0:
        return ("all", 0.0) if k > -1.0 else ("gt0", 0.0)
    return ("lt", (1.0 - EPSILON) / denom) if k > -1.0 else ("gt0", 0.0)


def _tight_bound(c: float, k: float):
    """The conic bound of the tight rule (inside the aperture AND r2 <
    bound), or None where only the aperture applies."""
    if c == 0.0:
        return None
    denom = c * c * (1.0 + k)
    if k > -1.0 and denom != 0.0:
        return (1.0 - EPSILON) / denom
    return None


# ---------------------------------------------------------------------------
# Statically specialised trace
# ---------------------------------------------------------------------------
# The surface constants of a fixed lens are Python floats here, so a term
# with a zero coefficient is never computed: stops reduce to a plane hit,
# spherics to the closed-form sphere intersection plus one polish, and
# aspheres run Horner only over their nonzero terms. Value-only (no
# gradient re-attach): for the traced supervision and other value paths.

def _n_ai(ai: tuple) -> int:
    return max((i + 1 for i, a in enumerate(ai) if a != 0.0), default=0)


def _sag_spec(r2, c: float, k: float, ai: tuple):
    """sag_r2 with static (c, k, ai)."""
    n_ai = _n_ai(ai)
    out = None
    if c != 0.0:
        sf = torch.sqrt(torch.clamp(1.0 - (1.0 + k) * r2 * (c * c), min=1e-24))
        out = r2 * c / (1.0 + sf)
    if n_ai:
        poly = torch.full_like(r2, ai[n_ai - 1])
        for i in range(n_ai - 2, -1, -1):
            poly = poly * r2 + ai[i]
        out = poly * r2 if out is None else out + poly * r2
    return torch.zeros_like(r2) if out is None else out


def _dsag_spec(r2, c: float, k: float, ai: tuple):
    """dsag_dr2 with static (c, k, ai)."""
    n_ai = _n_ai(ai)
    out = None
    if c != 0.0:
        cc = c * c
        sf = torch.sqrt(torch.clamp(1.0 - (1.0 + k) * r2 * cc, min=1e-24))
        out = (1.0 + sf + (1.0 + k) * r2 * cc / (2.0 * sf)) * c / (1.0 + sf) ** 2
    if n_ai:
        poly = torch.full_like(r2, n_ai * ai[n_ai - 1])
        for i in range(n_ai - 2, -1, -1):
            poly = poly * r2 + (i + 1) * ai[i]
        out = poly if out is None else out + poly
    return torch.zeros_like(r2) if out is None else out


def _valid_loose_spec(r2, c: float, k: float):
    rule, bound = _loose_bound(c, k)
    if rule == "all":
        return torch.ones(r2.shape, dtype=torch.bool, device=r2.device)
    return r2 < bound if rule == "lt" else r2 > 0.0


def _valid_tight_spec(r2, c: float, k: float, r_ap: float):
    in_ap = r2 < r_ap * r_ap
    bound = _tight_bound(c, k)
    return in_ap if bound is None else in_ap & (r2 < bound)


def _clip_newton(ft, dfdt):
    return torch.clamp(ft / (dfdt + EPSILON), -NEWTON_STEP_BOUND, NEWTON_STEP_BOUND)


def _surface_step_spec(o, dvec, ra, surf: tuple, eta, maxiter: int):
    """One specialised surface step (values of surface_step)."""
    kind, c, k, ai, d_surf, r_ap, skip = surf
    dz = dvec[..., 2]
    t0 = (d_surf - o[..., 2]) / dz
    live = ra > 0
    if kind == KIND_STOP and c == 0.0 and not any(ai):
        # a plane: Newton converges at the seed
        new_o = o + dvec * t0[..., None]
        r2n = new_o[..., 0] ** 2 + new_o[..., 1] ** 2
        valid = (torch.sqrt(r2n) <= r_ap) & live
    else:
        dxy2 = dvec[..., 0] ** 2 + dvec[..., 1] ** 2
        doxy = dvec[..., 0] * o[..., 0] + dvec[..., 1] * o[..., 1]

        def ft_dfdt(t, tight: bool):
            new_o = o + dvec * t[..., None]
            x, y = new_o[..., 0], new_o[..., 1]
            r2_raw = x * x + y * y
            valid = (_valid_tight_spec(r2_raw, c, k, r_ap) if tight
                     else _valid_loose_spec(r2_raw, c, k))
            m = (valid & live).to(x.dtype)
            r2 = (x * m) ** 2 + (y * m) ** 2
            ft = _sag_spec(r2, c, k, ai) + d_surf - new_o[..., 2]
            dfdt = _dsag_spec(r2, c, k, ai) * (2.0 * (dxy2 * t + doxy)) - dz
            return ft, dfdt

        c_t = torch.tensor(c, dtype=torch.float32, device=o.device)
        t = _sphere_seed(o, dvec, c_t, d_surf, t0)
        if kind == KIND_ASPHERIC or k != 0.0 or any(ai):
            for _ in range(maxiter):
                ft, dfdt = ft_dfdt(t, tight=False)
                t = t - _clip_newton(ft, dfdt)
        # the final tight-masked polish; the tolerance test reads the
        # residual before it, as surface_step does
        ft_d, dfdt = ft_dfdt(t, tight=True)
        t = t - _clip_newton(ft_d, dfdt)
        new_o = o + dvec * t[..., None]
        r2n = new_o[..., 0] ** 2 + new_o[..., 1] ** 2
        if kind == KIND_ASPHERIC:
            valid = (_valid_tight_spec(r2n, c, k, r_ap)
                     & (torch.abs(ft_d) < NEWTON_TOL_TIGHT) & live & (t > 0))
        elif kind == KIND_SPHERIC:
            valid = (r2n <= r_ap * r_ap) & (t >= 0) & live
        else:
            valid = (torch.sqrt(r2n) <= r_ap) & live
    o_out = torch.where(valid[..., None], new_o, o)
    ra_mid = ra * valid.to(ra.dtype)
    if skip:
        return o_out, dvec, ra_mid
    m = (ra_mid > 0).to(dvec.dtype)
    x = o_out[..., 0] * m
    y = o_out[..., 1] * m
    ds = _dsag_spec(x * x + y * y, c, k, ai)
    n = -normalize(torch.stack([ds * 2.0 * x, ds * 2.0 * y, -torch.ones_like(x)],
                               dim=-1))
    cosi = torch.sum(dvec * n, dim=-1)
    valid_r = (cosi ** 2 > 0.1) & (eta ** 2 * (1.0 - cosi ** 2) < 1.0) & (ra_mid > 0)
    vm = valid_r.to(dvec.dtype)
    sr = torch.sqrt(1.0 - eta ** 2 * (1.0 - cosi[..., None] ** 2) * vm[..., None])
    new_d = sr * n + eta * (dvec - cosi[..., None] * n)
    return o_out, torch.where(valid_r[..., None], new_d, dvec), ra_mid * vm


@torch.no_grad()
def trace_rays_specialized(rays: Rays, desc: tuple, eta,
                           maxiter: int = NEWTON_FAST_ITERS) -> Rays:
    """Forward trace over a static lens description (static_surface_desc),
    the surface loop unrolled with the constants as Python floats.
    Value-only; an incoherent bundle (opl / phi untouched).

    eta[S]: per-surface refraction ratios (a tensor: wavelength-dependent).
    """
    o, dvec, ra = rays.o, rays.d, rays.ra
    for i, surf in enumerate(desc):
        o, dvec, ra = _surface_step_spec(o, dvec, ra, surf, eta[i], maxiter)
    return rays.replace(o=o, d=dvec, ra=ra)
