"""Full DP image formation: depth map -> per-pixel PSFs -> camera-space pair
(PyTorch counterpart of sdirt_tpu/render/pipeline.py).

Depth normalisation, per-pixel MLP PSF prediction, degamma -> per-pixel DP
convolution -> gamma, clip. Two variants:

  "fused" -- one-GEMM bf16 MLP emitting the PSF tap-major
             (mlp_fast.mlp_psf_tapmajor) into the fused CUDA conv+normalise
             kernel (fused_conv.fused_dp_conv_tapmajor); the serve path.
  "scan"  -- the plain path: bf16 network per view (psfnet.surrogate.pred_psf)
             then the tap-by-tap convolution (perpixel.local_dp_conv).

Training renders (``train=True``) add the structured DP noise
(camera.dp_noise) after gamma and before the clip. The JAX package's default
variant is the int8 trunk ("fused_int8"), which the port does not have yet,
nor the basis student ("basis"): the port's training render is "fused".
"""

from __future__ import annotations

import copy

import torch

from .camera import degamma, dp_noise, gamma

VARIANTS = ("fused", "scan")


def query_points(depth, d_sensor, d_min, d_max):
    """[N, 1, H, W] depth (mm, negative) -> [N, H, W, 3] normalised (x, y, z)."""
    n, _, h, w = depth.shape
    depth = depth + d_sensor          # the reference's d_sensor shift
    z = torch.clamp((depth - d_min) / (d_max - d_min), 0.0, 1.0).reshape(n, h, w)
    dev = depth.device
    y, x = torch.meshgrid(torch.linspace(1, -1, h, device=dev),
                          torch.linspace(-1, 1, w, device=dev), indexing="ij")
    return torch.stack([x.expand(n, h, w), y.expand(n, h, w), z], dim=-1).float()


def _bf16_fn(net):
    """The network with bf16 weights on bf16 queries, f32 out (the JAX scan
    path's bf16 MLP)."""
    net_b = copy.deepcopy(net).to(torch.bfloat16)
    return lambda q: net_b(q.to(torch.bfloat16)).float()


@torch.no_grad()
def render_dp(net, img, depth, foc_dist, *, d_sensor, d_min, d_max, ks,
              variant: str = "fused", train: bool = False,
              generator: torch.Generator | None = None):
    """Render a DP pair.

    net: the PSFMLP surrogate; img: [N, C, H, W] in [0, 1]; depth:
    [N, 1, H, W] or [N, H, W] mm (negative); foc_dist is unused (the
    per-pixel render reads the depth only). train=True adds the DP noise,
    drawn from ``generator`` (required then, on the image's device).
    Returns [N, 2C, H, W] in [0, 1].
    """
    if variant not in VARIANTS:
        raise ValueError(f"render variant {variant!r} not in {VARIANTS}")
    if train and generator is None:
        raise ValueError("a training render needs a generator for its noise")
    del foc_dist
    if depth.dim() == 3:
        depth = depth[:, None]
    o = query_points(depth.float(), d_sensor, d_min, d_max)
    lum = degamma(img.float().permute(0, 2, 3, 1))           # [N, H, W, C]
    if variant == "fused":
        from .fused_conv import fused_dp_conv_tapmajor
        from .mlp_fast import mlp_psf_tapmajor

        psf_tm = mlp_psf_tapmajor(net, o, ks)
        render_l, render_r = fused_dp_conv_tapmajor(lum, psf_tm, ks)
    else:
        from ..psfnet.surrogate import pred_psf
        from .perpixel import local_dp_conv

        psf = pred_psf(_bf16_fn(net), o, ks)                 # [N, H, W, 2, ks, ks]
        render_l, render_r = local_dp_conv(lum, psf, ks)
    render = torch.cat([render_l, render_r], dim=-1)         # [N, H, W, 2C]
    render = gamma(render).permute(0, 3, 1, 2)               # [N, 2C, H, W]
    if train:
        render = dp_noise(generator, render)
    return torch.clamp(render, 0.0, 1.0)
