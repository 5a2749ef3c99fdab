"""Differentiable lens design demo of the PyTorch port (counterpart of
``scripts/demo_lens_design.py``).

  python -m sdirt_tpu_torch.demo_lens_design [--device cuda] [--steps 300] \\
      [--spp 256 --perturb 0.002 --base-lr 1.0 --rel-step 2e-4 --seed 0] \\
      [--draws FILE.npz]

A Canon RF50mm is detuned as by manufacturing (multiplicative jitter on
curvatures, conic and asphere coefficients, additive on thicknesses and
radii), then Adam descends the surface parameters through the
differentiable trace to recover the RMS spot size over three field points
x RGB at the -20 m conjugate. Prints the nominal / detuned / recovered
RMS-spot table (um) and ``RECOVERY OK`` or ``RECOVERY WEAK``.

``--draws`` takes the pupil samples (``pupil_<i>`` [spp, 2], one per
wavelength) and the perturbation's five normal draws (``perturb_<j>``) from
an .npz instead of drawing them (scripts/make_lens_design_reference.py
writes the JAX package's own).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from .core.rays import Rays
from .optics.lens import Lens
from .optics.optimize import (apply_params, make_lens_optimizer, optimizable_params,
                              perturb_stack, surface_param_labels)
from .optics.surfaces import trace_rays
from .utils.device import resolve_device

WVLNS = (0.656, 0.589, 0.486)
FIELDS = np.array([0.0, 0.35, 0.7], np.float32)


def spot_rms2(o, ra):
    """Per-field mean squared spot radius [mm^2] about the live rays'
    centroid, and the summed squares / count over all fields (the loss).
    o [spp, N, 3], ra [spp, N]."""
    xy = o[..., :2]
    ctr = (xy * ra[..., None]).sum(0) / (ra.sum(0)[..., None] + 1e-9)
    sq = ((xy - ctr) ** 2).sum(-1) * ra
    return sq.sum(0) / (ra.sum(0) + 1e-9), sq.sum() / (ra.sum() + 1e-9)


def trace_rgb(rays, stack, eta, skip, d_sensor):
    """The three wavelengths' bundles ([3, spp, N]) in one trace, each with
    its own eta [S, 3, 1, 1] (the same arithmetic per ray as three traces,
    a third of the launches), propagated to the sensor."""
    return trace_rays(rays, stack, eta, skip).propagate_to(d_sensor)


def rms_table(stack, rays, eta, skip, d_sensor) -> np.ndarray:
    """Per-field RMS spot radius (um), averaged over the wavelengths."""
    with torch.no_grad():
        out = trace_rgb(rays, stack, eta, skip, d_sensor)
        per_field = [torch.sqrt(spot_rms2(out.o[w], out.ra[w])[0]) * 1e3
                     for w in range(len(WVLNS))]
    return torch.stack(per_field).mean(0).cpu().numpy()


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--lens", default="./lenses/rf50mm/lens_web.json")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--spp", type=int, default=256)
    ap.add_argument("--perturb", type=float, default=0.002,
                    help="relative manufacturing jitter on c/k/ai")
    ap.add_argument("--base-lr", type=float, default=1.0)
    ap.add_argument("--rel-step", type=float, default=2e-4,
                    help="per-step relative parameter change (Adam updates "
                         "are ~unit-scale, so this is the step size)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--draws", default=None,
                    help=".npz of pupil_<i> and perturb_<j> draws to use")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the demo; returns {"nominal", "detuned", "recovered" (um per
    field), "ok", "losses", "ms_per_step"}."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    lens = Lens(args.lens, sensor_res=(512, 768), device=device)
    eta = torch.stack([lens.eta_arrays(w, True)[0] for w in WVLNS], 1)[..., None, None]
    # stops in air (c == 0 and eta == 1) at every wavelength
    _, skip = lens.eta_arrays(WVLNS[0], True)
    draws = dict(np.load(args.draws)) if args.draws else None
    gen = torch.Generator(device=device).manual_seed(args.seed)

    scale = lens.calc_scale_pinhole(-20000.0)
    pts = np.stack([np.zeros_like(FIELDS), FIELDS * scale * lens.sensor_size[0] / 2,
                    np.full_like(FIELDS, -20000.0)], -1)
    per_wvln = [lens.sample_from_points(pts, spp=args.spp, generator=gen,
                                        xy=None if draws is None else draws[f"pupil_{i}"])
                for i in range(len(WVLNS))]
    rays = Rays(*(torch.stack([getattr(r, a) for r in per_wvln]) for a in ("o", "d", "ra")))
    nominal = rms_table(lens.stack, rays, eta, skip, lens.d_sensor)
    detuned_stack = perturb_stack(
        lens.stack, gen, ratio=args.perturb, thickness_precision=0.002,
        draws=None if draws is None else [draws[f"perturb_{j}"] for j in range(5)])
    detuned = rms_table(detuned_stack, rays, eta, skip, lens.d_sensor)

    def loss_fn(params):
        out = trace_rgb(rays, apply_params(detuned_stack, params), eta, skip, lens.d_sensor)
        total = 0.0
        for w in range(len(WVLNS)):
            total = total + spot_rms2(out.o[w], out.ra[w])[1]
        return total / len(WVLNS)

    params = optimizable_params(detuned_stack)
    # the reference's freezing policy, with steps proportional to each
    # parameter (a multiplicative recovery): unit-scale Adam steps would
    # wreck the high-order asphere terms (|a_10| ~ 1e-9..1e-15)
    labels = surface_param_labels(detuned_stack, aper_idx=lens.aper_idx)
    scales = {k: (labels[k] > 0) * args.rel_step * torch.abs(params[k].detach())
              for k in params}
    opt = make_lens_optimizer(params, scales, base_lr=args.base_lr)

    t0 = time.perf_counter()
    best, best_params, losses = np.inf, None, []
    for i in range(args.steps):
        prev = {k: v.detach().clone() for k, v in params.items()}
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(params)
        loss.backward()
        opt.step()
        value = float(loss.detach())   # the loss at prev, not at the updated params
        losses.append(value)
        if value < best:
            best, best_params = value, prev
        if i % 50 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss {value:.6e}  ({time.perf_counter() - t0:.1f}s)",
                  flush=True)
    ms_per_step = (time.perf_counter() - t0) / max(args.steps, 1) * 1e3

    recovered = rms_table(apply_params(detuned_stack, best_params), rays, eta, skip,
                          lens.d_sensor)
    print("\nRMS spot radius (um), RGB-averaged, rf50mm @ -20 m conjugate")
    print(f"{'field':>6} | {'nominal':>8} | {'detuned':>8} | {'recovered':>9}")
    for f, a, b, c in zip(FIELDS, nominal, detuned, recovered):
        print(f"{f:6.2f} | {a:8.2f} | {b:8.2f} | {c:9.2f}")
    mean_rec = recovered.mean()
    print(f"\nmean: nominal {nominal.mean():.2f}  detuned {detuned.mean():.2f}"
          f"  recovered {mean_rec:.2f}")
    ok = bool(mean_rec < 0.5 * detuned.mean() or mean_rec < 1.1 * nominal.mean())
    print("RECOVERY", "OK" if ok else "WEAK")
    return {"nominal": nominal, "detuned": detuned, "recovered": recovered, "ok": ok,
            "losses": losses, "ms_per_step": ms_per_step}


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
