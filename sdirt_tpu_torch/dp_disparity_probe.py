"""DP disparity against depth: how much signal the depth net has (PyTorch
counterpart of scripts/dp_disparity_probe.py).

  python -m sdirt_tpu_torch.dp_disparity_probe [--lens ...] [--ckpt ...] \\
      [--ks 21] [--depths 0.3 0.5 ...] [--fnum F] [--traced [--spp N]
      [--focus-mm MM]] [--device cuda|cpu]

For each on-axis depth, the left/right PSF centroid separation (the stereo
baseline the DfDP cost volume sees) and the blur sigma, in pixels. By
default the PSFs are the fitted surrogate's; ``--traced`` ray-traces them
instead (the lens refocused to ``--focus-mm``), through dp/psf.py's
``dp_psf_fused``, whose chief and main bundles are traced by K1: the point
and its mirror in x go through one call per depth, and the right PSF is the
mirror's left PSF flipped in x, as the JAX probe builds it. The rays are
drawn from an explicit torch.Generator seeded with 0.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .dfdp.factory import ported_weights
from .dp.fused_trace import make_fused_plan
from .dp.psf import dp_psf_fused, lens_scalars
from .psfnet.surrogate import PSFNetLens
from .utils.device import resolve_device

DEPTHS = (0.3, 0.5, 0.7, 0.9, 1.0, 1.2, 1.5, 2.0, 3.0, 5.0, 9.0)


def disparity(psf_l: np.ndarray, psf_r: np.ndarray, ks: int):
    """(left - right centroid in x, left blur sigma in x), in pixels."""
    xx = np.arange(ks) - ks // 2
    cl = (psf_l.sum(0) * xx).sum() / psf_l.sum()
    cr = (psf_r.sum(0) * xx).sum() / psf_r.sum()
    sig = np.sqrt((psf_l.sum(0) * (xx - cl) ** 2).sum() / psf_l.sum())
    return float(cl - cr), float(sig)


def probe(lens, depths, ks: int, traced: bool = False, spp: int = 200_000,
          generator=None) -> list:
    """[{"depth_m", "disparity_px", "sigma_px"}] for each depth (metres)."""
    plan = make_fused_plan(lens) if traced else None
    rows = []
    for d_m in depths:
        # the render pipeline's convention: depth (negative mm) + d_sensor
        depth_mm = -d_m * 1e3 + lens.d_sensor
        with torch.no_grad():
            if traced:
                pts = torch.tensor([[0.0, 0.0, depth_mm], [-0.0, 0.0, depth_mm]],
                                   device=lens.device)
                psf_l, _ = dp_psf_fused(pts, generator, lens_scalars(lens), plan,
                                        spp=spp, ks=ks)
                psf_l = psf_l.cpu().numpy()
                psf = np.stack([psf_l[0], psf_l[1][:, ::-1]])
            else:
                z = lens.depth2z(torch.tensor([depth_mm], device=lens.device))
                o = torch.stack([torch.zeros_like(z), torch.zeros_like(z), z], -1)
                psf = lens.pred(o[None]).reshape(-1, 2, ks, ks)[0].cpu().numpy()
        disp, sig = disparity(psf[0], psf[1], ks)
        rows.append({"depth_m": d_m, "disparity_px": disp, "sigma_px": sig})
    return rows


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--lens", default="lenses/rf50mm/lens_web.json")
    ap.add_argument("--ckpt", default="ckpt/rf50mm/F4_PSFNet_mlp")
    ap.add_argument("--ks", type=int, default=21)
    ap.add_argument("--depths", type=float, nargs="+", default=DEPTHS)
    ap.add_argument("--fnum", type=float, default=None,
                    help="re-stop the lens (e.g. 1.8 with --ks 35)")
    ap.add_argument("--focus-mm", type=float, default=-1000.0,
                    help="object-side focus (mm, negative) for --traced")
    ap.add_argument("--traced", action="store_true",
                    help="probe ray-traced PSFs instead of the fitted surrogate")
    ap.add_argument("--spp", type=int, default=200_000,
                    help="rays per point for --traced")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    lens = PSFNetLens(args.lens, kernel_size=args.ks, sensor_res=(512, 768), device=dev)
    if args.fnum is not None:
        lens.set_aperture(fnum=args.fnum)
        print(f"aperture re-stopped to F/{lens.fnum:.3f}")
    generator = None
    if args.traced:
        lens.refocus(args.focus_mm + lens.d_sensor)
        generator = torch.Generator(device=dev).manual_seed(0)
    else:
        lens.load_net(ported_weights(args.ckpt))
    rows = probe(lens, args.depths, args.ks, args.traced, args.spp, generator)
    print(f"{'depth (m)':>10} {'disparity (px)':>15} {'blur sigma (px)':>16}")
    for r in rows:
        print(f"{r['depth_m']:>10.2f} {r['disparity_px']:>+15.3f} {r['sigma_px']:>16.2f}")
    return rows


if __name__ == "__main__":
    main()
