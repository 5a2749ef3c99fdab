"""PSF surrogate: DP-PSF prediction and a render-only PSFNetLens
(PyTorch counterpart of sdirt_tpu/psfnet/surrogate.py).

The network maps normalised (x, y, z) to the LEFT DP PSF; the right PSF is
the network queried at -x and mirrored in kx. The reference's behavioural
quirks are kept: the sensor distance is pinned per lens (62.25 mm for
rf50mm, 80.447 for rf35mm) without recomputing fov or f-number, and the
depth normalisation maps -DMIN mm to z = 0 and -DMAX mm to z = 1.
"""

from __future__ import annotations

import os

import torch

from ..core.constants import D_SENSOR, DMAX, DMIN
from ..utils.device import resolve_device
from ..utils.weights import load_state
from .arch import build_psfnet


def pred_psf(fn, inp, ks: int):
    """Network DP-PSF prediction: left from the net, right mirrored.

    fn: [..., 3] -> [..., ks*ks]; inp: [..., 3] normalised (x, y, z).
    Returns [..., 2, ks, ks], sum-normalised per view; the right PSF is the
    net queried at -x, flipped in kx.
    """
    psfl = fn(inp).reshape(*inp.shape[:-1], ks, ks)
    inp_m = inp * torch.tensor([-1.0, 1.0, 1.0], dtype=inp.dtype,
                               device=inp.device)
    psfr = torch.flip(fn(inp_m).reshape(*inp.shape[:-1], ks, ks), dims=(-1,))
    psf = torch.stack([psfl, psfr], dim=-3)
    return psf / (psf.sum((-1, -2), keepdim=True) + 1e-9)


class PSFNetLens:
    """Render-only lens with an implicit DP-PSF surrogate.

    The JAX class derives from the ray-traced ``Lens`` (optics, pupils,
    ray-traced PSFs); that base class comes with the optics slice. What the
    serve path needs does not trace rays: the pinned sensor distance, the
    depth normalisation, the surrogate net and the render.
    """

    def __init__(self, filename: str, model_name: str = "mlp",
                 kernel_size: int = 11, sensor_res=(512, 512), seed: int = 0,
                 device="cuda"):
        self.device = resolve_device(device)
        self.kernel_size = kernel_size
        self.model_name = model_name
        self.sensor_res = tuple(sensor_res)
        # as in the JAX class: d_max = -DMAX, d_min = -DMIN, so z runs from
        # 0 at -200 mm to 1 at -20 m
        self.d_max = -DMAX
        self.d_min = -DMIN
        lens = [k for k in D_SENSOR if k in filename]
        if not lens:
            raise ValueError("Lens filename must name rf35mm or rf50mm")
        self.d_sensor = D_SENSOR[lens[0]]
        gen = torch.Generator().manual_seed(seed)
        self.net = build_psfnet(model_name, kernel_size).init_(gen)
        self.net = self.net.to(self.device).eval()

    def depth2z(self, depth):
        z = (depth - self.d_min) / (self.d_max - self.d_min)
        return torch.clamp(z, 0.0, 1.0)

    def load_net(self, path: str):
        """Load an exported ``.npz`` tree (scripts/export_torch_weights.py)."""
        if not path.endswith(".npz") or not os.path.exists(path):
            raise FileNotFoundError(f"no exported surrogate at {path}")
        load_state(self.net, path)
        return self

    @torch.no_grad()
    def render(self, img, depth, foc_dist, variant: str = "fused"):
        """Render a DP pair from an all-in-focus image + depth map.

        img: [N, C, H, W] in [0, 1]; depth: [N, 1, H, W] mm (negative);
        foc_dist: [N] mm (negative, unused by the per-pixel render).
        Returns [N, 2C, H, W] on this lens's device.
        """
        from ..render.pipeline import render_dp

        img = torch.as_tensor(img, dtype=torch.float32, device=self.device)
        depth = torch.as_tensor(depth, dtype=torch.float32, device=self.device)
        return render_dp(self.net, img, depth, foc_dist,
                         d_sensor=self.d_sensor, d_min=self.d_min,
                         d_max=self.d_max, ks=self.kernel_size,
                         variant=variant)
