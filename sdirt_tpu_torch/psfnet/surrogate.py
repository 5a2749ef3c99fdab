"""PSFNetLens: a ray-traced lens with an implicit dual-pixel PSF surrogate
network (PyTorch counterpart of sdirt_tpu/psfnet/surrogate.py).

The network maps normalised (x, y, z) to the LEFT DP PSF; the right PSF is
the network queried at -x and mirrored in kx. The reference's behavioural
quirks are kept:
  * the sensor distance is pinned per lens (62.25 mm for rf50mm, 80.447 for
    rf35mm) without recomputing fov or f-number;
  * the focus prior is pinned to ~1 m;
  * PSFs are max-normalised for fitting, sum-normalised in ``pred``;
  * the depth normalisation maps -DMIN mm to z = 0 and -DMAX mm to z = 1.
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np
import torch

from ..core.constants import D_SENSOR, DMAX, DMIN, GEO_SPP
from ..dp.psf import compute_psf
from ..optics.lens import Lens
from ..utils.png import write_png
from ..utils.weights import flax_to_torch, load_npz, torch_to_flax
from .arch import build_psfnet

DEFAULT_FOC_OFFSETS = np.array([-999.9, -1000.0, -1000.1], np.float32)


def pred_psf(fn, inp, ks: int, flip_right: bool = True, fn_right=None):
    """Network DP-PSF prediction: left from the net, right mirrored.

    fn: [..., 3] -> [..., ks*ks]; inp: [..., 3] normalised (x, y, z).
    Returns [..., 2, ks, ks], sum-normalised per view; the right PSF is the
    net queried at -x (through ``fn_right`` when given), flipped in kx
    unless ``flip_right`` is False (for local_dp_conv(mirror_right=True),
    which folds the mirror into its tap index instead).
    """
    fn_r = fn if fn_right is None else fn_right
    psfl = fn(inp).reshape(*inp.shape[:-1], ks, ks)
    inp_m = inp * torch.tensor([-1.0, 1.0, 1.0], dtype=inp.dtype,
                               device=inp.device)
    psfr = fn_r(inp_m).reshape(*inp.shape[:-1], ks, ks)
    if flip_right:
        psfr = torch.flip(psfr, dims=(-1,))
    psf = torch.stack([psfl, psfr], dim=-3)
    return psf / (psf.sum((-1, -2), keepdim=True) + 1e-9)


class PSFNetLens(Lens):
    """Lens + trained implicit PSF representation."""

    def __init__(self, filename: str, model_name: str = "mlp",
                 kernel_size: int = 11, sensor_res=(512, 512), seed: int = 0,
                 device="cuda"):
        super().__init__(filename=filename, sensor_res=sensor_res, device=device)
        self.kernel_size = kernel_size
        self.model_name = model_name
        # as in the JAX class: d_max = -DMAX, d_min = -DMIN, so z runs from
        # 0 at -200 mm to 1 at -20 m
        self.d_max = -DMAX
        self.d_min = -DMIN
        # d_sensor override WITHOUT post_computation: hfov / fnum keep the
        # values of the JSON's sensor distance
        lens = [k for k in D_SENSOR if k in filename]
        if not lens:
            raise ValueError("Lens filename must name rf35mm or rf50mm")
        self.d_sensor = D_SENSOR[lens[0]]
        self.foc_d_arr = DEFAULT_FOC_OFFSETS + self.d_sensor
        self.foc_z_arr = ((self.foc_d_arr - self.d_min)
                          / (self.d_max - self.d_min)).astype(np.float32)
        self.foc_d = np.array([-1000.0], np.float32) + self.d_sensor
        gen = torch.Generator().manual_seed(seed)
        self.net = build_psfnet(model_name, kernel_size).init_(gen)
        self.net = self.net.to(self.device).eval()

    def set_focus_prior(self, focus_mm: float):
        """Re-centre the fit-time focus prior on a new focus distance
        (negative object distance in mm). Call after refocus(), so that
        d_sensor is the fit-time value."""
        offsets = DEFAULT_FOC_OFFSETS - (-1000.0) + float(focus_mm)
        self.foc_d_arr = (offsets + self.d_sensor).astype(np.float32)
        self.foc_z_arr = ((self.foc_d_arr - self.d_min)
                          / (self.d_max - self.d_min)).astype(np.float32)
        self.foc_d = np.array([float(focus_mm)], np.float32) + self.d_sensor

    # -----------------------------------------------------------------
    # Depth normalisation
    # -----------------------------------------------------------------
    def depth2z(self, depth):
        z = (depth - self.d_min) / (self.d_max - self.d_min)
        return torch.clamp(z, 0.0, 1.0)

    def z2depth(self, z):
        return z * (self.d_max - self.d_min) + self.d_min

    # -----------------------------------------------------------------
    # Ray-traced ground truth, network prediction, weights
    # -----------------------------------------------------------------
    def psf(self, points, ks=None, spp=GEO_SPP, generator=None, both=False):
        """Ray-traced left DP PSF (per-surface trace); points: [N, 3]
        normalised x, y + depth z in mm."""
        ks = self.kernel_size if ks is None else ks
        return compute_psf(self, points, generator=generator, spp=spp, ks=ks,
                           both=both)

    def pred(self, inp):
        """[..., 3] -> [..., 2, ks, ks] (left net / mirrored right)."""
        inp = torch.as_tensor(inp, dtype=torch.float32, device=self.device)
        return pred_psf(self.net, inp, self.kernel_size)

    def load_net(self, path: str):
        """Load an exported ``.npz`` tree (scripts/export_torch_weights.py,
        or ``save_net``), or a reference PyTorch ``.pkl`` state dict
        (_load_pkl). A tree that does not match this net's layers is
        merged leaf by leaf where name and shape agree (how a basis student
        warm-starts its trunk from a PSFMLP of the same width); one that
        shares no such leaf raises."""
        if path.endswith(".pkl") and os.path.exists(path):
            return self._load_pkl(path)
        if not path.endswith(".npz") or not os.path.exists(path):
            raise FileNotFoundError(f"no exported surrogate at {path}")
        stored = flax_to_torch(load_npz(path))
        own = self.net.state_dict()
        if (set(stored) == set(own)
                and all(stored[k].shape == v.shape for k, v in own.items())):
            self.net.load_state_dict(stored, strict=True)
            return self
        hits = [k for k, v in own.items()
                if k in stored and stored[k].shape == v.shape]
        if not hits:
            raise ValueError(f"checkpoint at {path} shares no same-shaped "
                             f"leaves with a {self.model_name} net: wrong "
                             "checkpoint?")
        self.net.load_state_dict({**own, **{k: stored[k] for k in hits}})
        logging.info(f"partial net load: {len(hits)}/{len(own)} leaves from {path}")
        return self

    def _load_pkl(self, path: str):
        """A reference MLP checkpoint (a PyTorch state dict of Linear layers
        ``<prefix>.<i>.weight`` / ``.bias``): its layers, in the order of
        i, go into this net's Dense layers in order, each leaf only where
        its shape matches."""
        sd = torch.load(path, map_location="cpu", weights_only=True)
        order = lambda kv: int(kv[0].split(".")[-2])
        weights = sorted(((k, v) for k, v in sd.items() if k.endswith("weight")), key=order)
        biases = sorted(((k, v) for k, v in sd.items() if k.endswith("bias")), key=order)
        own = self.net.state_dict()
        dense = sorted({k.rsplit(".", 1)[0] for k in own if k.startswith("Dense_")},
                       key=lambda m: int(m.split("_")[1]))
        new = dict(own)
        for (_, w), (_, b), m in zip(weights, biases, dense):
            for leaf, v in (("weight", w), ("bias", b)):
                if own[f"{m}.{leaf}"].shape == v.shape:
                    new[f"{m}.{leaf}"] = v.float()
        self.net.load_state_dict(new)
        return self

    def save_net(self, path: str):
        """Write the net as a flat Flax-layout ``.npz`` tree, the layout
        ``load_net`` and the serve path read."""
        np.savez(path, **torch_to_flax(self.net.state_dict()))

    @torch.no_grad()
    def render(self, img, depth, foc_dist, variant: str | None = None,
               train: bool = False, generator=None, **render_kw):
        """Render a DP pair from an all-in-focus image + depth map.

        img: [N, C, H, W] in [0, 1]; depth: [N, 1, H, W] mm (negative);
        foc_dist: [N] mm (negative, unused by the per-pixel render).
        variant: a render variant (render/pipeline.py), None for
        SDIRT_RENDER_VARIANT or the port's default.
        train=True adds the DP noise, drawn from ``generator``. render_kw
        (``mlp_bf16``, ``scan_right``) go to render_dp.
        Returns [N, 2C, H, W] on this lens's device.
        """
        from ..render.pipeline import render_dp

        img = torch.as_tensor(img, dtype=torch.float32, device=self.device)
        depth = torch.as_tensor(depth, dtype=torch.float32, device=self.device)
        return render_dp(self.net, img, depth, foc_dist,
                         d_sensor=self.d_sensor, d_min=self.d_min,
                         d_max=self.d_max, ks=self.kernel_size,
                         variant=variant, train=train, generator=generator,
                         **render_kw)

    # -----------------------------------------------------------------
    # Timing and fit-quality evaluation
    # -----------------------------------------------------------------
    @torch.no_grad()
    def time_compare_psf(self, n_points: int = 512 * 768 // 16,
                         spp: int = GEO_SPP * 2, log_fn=print):
        """Ray-traced PSFs against network inference for the same point
        count: seconds of the per-surface trace of n_points x spp rays (in
        chunks of 1024 points, which bounds the memory) and of one
        128 x 192 network query. On the card both are timed with CUDA
        events. Returns (t_rt, t_net) in seconds."""
        chunk = 1024
        rng = np.random.default_rng(0)
        pts = np.stack([rng.uniform(-1, 1, n_points), rng.uniform(-1, 1, n_points),
                        -(rng.uniform(0, 1, n_points) * 19800 + 200)],
                       -1).astype(np.float32)
        inp = rng.uniform(0, 1, (1, 128, 192, 3)).astype(np.float32)
        gen = torch.Generator(device=self.device).manual_seed(0)

        def timed(fn):
            if self.device.type == "cuda":
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                fn()
                end.record()
                end.synchronize()
                return start.elapsed_time(end) / 1e3
            t0 = time.perf_counter()
            fn()
            return time.perf_counter() - t0

        t_rt = timed(lambda: [self.psf(pts[i:i + chunk], spp=spp, generator=gen)
                              for i in range(0, n_points, chunk)])
        log_fn(f"ray_tracing time cost: {t_rt:.3f}s "
               f"({n_points * spp / t_rt / 1e6:.1f} Mrays/s)")
        t_net = timed(lambda: self.pred(inp))
        log_fn(f"network time cost: {t_net:.3f}s")
        return t_rt, t_net

    @torch.no_grad()
    def compare_psf(self, spp=GEO_SPP * 100, generator=None, save_path=None,
                    save_dir=None):
        """Ray-traced vs predicted DP PSFs at the field points 0, 0.4, 0.8
        and the depths -500 and -20000 mm.

        Returns {'traced': [2 depths, 2 views, 3 fields, ks, ks],
        'pred': [2 depths, 3 fields, 2 views, ks, ks], 'depths'} as numpy,
        also written to ``save_path`` (.npz) when given. With ``save_dir``
        each (depth, field) also gets its panel as a grey PNG,
        ``compare_<depth>_v0{0,4,8}.png``: traced left | right on top, the
        prediction below, each PSF scaled to its maximum.
        """
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        xy = np.array([0.0, 0.4, 0.8], np.float32)
        out = {"traced": [], "pred": [], "depths": [-500.0, -20000.0]}
        for depth0 in out["depths"]:
            depth = depth0 + self.d_sensor
            pts = np.stack([xy, xy, np.full_like(xy, depth)], -1)
            psfl = self.psf(pts, spp=spp, generator=generator).cpu().numpy()
            pts_m = pts.copy()
            pts_m[:, 0] *= -1
            psfr = self.psf(pts_m, spp=spp, generator=generator).cpu().numpy()[..., ::-1]
            out["traced"].append(np.stack([psfl, psfr], axis=0))
            z = float(np.clip((depth - self.d_min) / (self.d_max - self.d_min), 0, 1))
            inp = np.stack([xy, xy, np.full_like(xy, z)], -1)
            out["pred"].append(self.pred(inp).cpu().numpy())
        out["traced"] = np.stack(out["traced"])
        out["pred"] = np.stack(out["pred"])
        out["depths"] = np.array(out["depths"], np.float32)
        if save_path is not None:
            np.savez(save_path, **out)
        if save_dir is not None:
            for di, d0 in enumerate(out["depths"]):
                for vi, tag in enumerate(["v00", "v04", "v08"]):
                    rows = [np.concatenate([p / (p.max() + 1e-9) for p in row], axis=1)
                            for row in (out["traced"][di, :, vi], out["pred"][di, vi])]
                    write_png(f"{save_dir}/compare_{int(d0)}_{tag}.png",
                              np.concatenate(rows, axis=0))
        return out
