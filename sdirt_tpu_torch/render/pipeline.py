"""Full DP image formation: depth map -> per-pixel PSFs -> camera-space pair
(PyTorch counterpart of sdirt_tpu/render/pipeline.py).

Depth normalisation, the PSF surrogate, degamma -> spatially varying DP
convolution -> gamma, clip. Five variants:

  "fused"      -- one-GEMM bf16 MLP emitting the PSF tap-major
                  (mlp_fast.mlp_psf_tapmajor) into the fused CUDA
                  conv+normalise kernel (fused_conv.fused_dp_conv_tapmajor);
  "fused_int8" -- "fused" with the trunk after the first two layers as
                  static-scale int8 GEMMs (mlp_fast.quantize_mlp, built once
                  per net and weight state);
  "scan"       -- the plain path: the network per view (bf16 unless
                  SDIRT_RENDER_MLP_BF16=0; psfnet.surrogate.pred_psf), then
                  the tap-by-tap convolution (perpixel.local_dp_conv);
  "basis"      -- the basis student's coefficient MLP, one dense conv with
                  its 2K + 2 kernels and a K-contraction (render/basis.py);
                  no per-pixel PSF;
  "basis_int8" -- "basis" with the coefficient chain in int8.

The fused variants apply a ReLU after the last layer, so they need an
all-ReLU PSFMLP; the basis variants need the linear head of a PSFMLPBasis.
``render_dp`` raises on either mismatch. ``variant=None`` reads
SDIRT_RENDER_VARIANT, else the port's default, "fused" (the JAX package
defaults to "fused_int8", chosen by its speed on the TPU). Training renders
(``train=True``) add the structured DP noise (camera.dp_noise) after gamma
and before the clip.
"""

from __future__ import annotations

import copy
import functools
import json
import os

import torch

from ..utils import trace
from .camera import degamma, dp_noise, gamma

VARIANTS = ("scan", "fused", "fused_int8", "basis", "basis_int8")
DEFAULT_VARIANT = "fused"
SCAN_RIGHT = ("flip", "noflip", "f32")
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# int8 packs by id(net): (the net, its weights' (data_ptr, version) state,
# the pack), first in first out. The state is part of the entry because a
# module's weights change in place (an optimiser step, load_state_dict):
# a changed state quantises again.
_QUANT_CACHE: dict = {}
QUANT_CACHE_SIZE = 8


def _weight_state(net):
    return tuple((p.data_ptr(), p._version) for p in net.parameters())


def get_quant(net):
    """The net's int8 pack (mlp_fast.quantize_mlp), built once per net and
    weight state."""
    from .mlp_fast import quantize_mlp

    state = _weight_state(net)
    hit = _QUANT_CACHE.get(id(net))
    if hit is not None and hit[0] is net and hit[1] == state:
        return hit[2]
    _QUANT_CACHE.pop(id(net), None)
    while len(_QUANT_CACHE) >= QUANT_CACHE_SIZE:
        _QUANT_CACHE.pop(next(iter(_QUANT_CACHE)))
    pack = quantize_mlp(net)
    _QUANT_CACHE[id(net)] = (net, state, pack)
    return pack


def resolve_variant(variant: str | None = None) -> str:
    """variant, or SDIRT_RENDER_VARIANT when it is None, or DEFAULT_VARIANT;
    raises for a name not in VARIANTS."""
    if variant is None:
        variant = os.environ.get("SDIRT_RENDER_VARIANT", DEFAULT_VARIANT)
    if variant not in VARIANTS:
        raise ValueError(f"render variant {variant!r} not in {VARIANTS}")
    return variant


@functools.cache
def scan_right_default() -> str:
    """The scan path's right-view mode: ckpt/SCAN_RIGHT.json's ``mode``
    where that manifest exists, else "flip"."""
    try:
        with open(os.path.join(ROOT, "ckpt", "SCAN_RIGHT.json")) as f:
            return json.load(f).get("mode", "flip")
    except (OSError, ValueError):
        return "flip"


def query_points(depth, d_sensor, d_min, d_max):
    """[N, 1, H, W] depth (mm, negative) -> [N, H, W, 3] normalised (x, y, z)."""
    n, _, h, w = depth.shape
    depth = depth + d_sensor          # the reference's d_sensor shift
    z = torch.clamp((depth - d_min) / (d_max - d_min), 0.0, 1.0).reshape(n, h, w)
    dev = depth.device
    y, x = torch.meshgrid(torch.linspace(1, -1, h, device=dev),
                          torch.linspace(-1, 1, w, device=dev), indexing="ij")
    return torch.stack([x.expand(n, h, w), y.expand(n, h, w), z], dim=-1).float()


def _dense_bf16(layer, x):
    """A Flax Dense in bf16: the product rounded to bf16, then the bias added
    and rounded again (torch's Linear adds the bias inside the GEMM and
    rounds once, which moves a linear head's taps by up to ~3e-2)."""
    return torch.nn.functional.linear(x, layer.weight) + layer.bias


def _bf16_fn(net):
    """The network with bf16 weights on bf16 queries, f32 out (the JAX scan
    path's bf16 MLP), every Linear rounded as a bf16 Flax Dense is."""
    net_b = copy.deepcopy(net).to(torch.bfloat16)
    for m in net_b.modules():
        if isinstance(m, torch.nn.Linear) and m.bias is not None:
            m.forward = functools.partial(_dense_bf16, m)
    return lambda q: net_b(q.to(torch.bfloat16)).float()


def _check_head(net, variant):
    linear = getattr(net, "linear_head", False)
    if variant.startswith("fused") and linear:
        raise ValueError(f"variant {variant!r} applies a ReLU after the last "
                         "layer; this net's head is linear (a basis student): "
                         "use 'basis', 'basis_int8' or 'scan'")
    if variant.startswith("basis") and not linear:
        raise ValueError(f"variant {variant!r} needs a linear-head basis "
                         "student (mlpb@WxK); this net is an all-ReLU PSFMLP: "
                         "use 'fused', 'fused_int8' or 'scan'")


def _scan(net, o, lum, ks, mlp_bf16, scan_right):
    from ..psfnet.surrogate import pred_psf
    from .perpixel import local_dp_conv

    with trace.span("render.psf_mlp", o.device):
        fn = _bf16_fn(net) if mlp_bf16 else net
        fn_r = net if (mlp_bf16 and scan_right == "f32") else None
        psf = pred_psf(fn, o, ks, flip_right=scan_right != "noflip",
                       fn_right=fn_r)                        # [N, H, W, 2, ks, ks]
    with trace.span("render.dp_conv", o.device):
        return local_dp_conv(lum, psf, ks, mirror_right=scan_right == "noflip")


@torch.no_grad()
def render_dp(net, img, depth, foc_dist, *, d_sensor, d_min, d_max, ks,
              variant: str | None = None, train: bool = False,
              generator: torch.Generator | None = None,
              mlp_bf16: bool | None = None, scan_right: str | None = None):
    """Render a DP pair.

    net: the PSF surrogate; img: [N, C, H, W] in [0, 1]; depth:
    [N, 1, H, W] or [N, H, W] mm (negative); foc_dist is unused (the
    per-pixel render reads the depth only). variant: one of VARIANTS, None
    for SDIRT_RENDER_VARIANT or DEFAULT_VARIANT. mlp_bf16 (None:
    SDIRT_RENDER_MLP_BF16 != "0") and scan_right (None: SDIRT_SCAN_RIGHT,
    ckpt/SCAN_RIGHT.json or "flip"; "noflip" folds the right view's mirror
    into the conv, "f32" runs its network in f32) are read by "scan" only.
    train=True adds the DP noise, drawn from ``generator`` (required then,
    on the image's device). Returns [N, 2C, H, W] in [0, 1].
    """
    variant = resolve_variant(variant)
    if mlp_bf16 is None:
        mlp_bf16 = os.environ.get("SDIRT_RENDER_MLP_BF16", "1") != "0"
    if scan_right is None:
        scan_right = os.environ.get("SDIRT_SCAN_RIGHT") or scan_right_default()
    if scan_right not in SCAN_RIGHT:
        raise ValueError(f"scan_right {scan_right!r} not in {SCAN_RIGHT}")
    if train and generator is None:
        raise ValueError("a training render needs a generator for its noise")
    _check_head(net, variant)
    del foc_dist
    if depth.dim() == 3:
        depth = depth[:, None]
    dev = img.device
    with trace.span("render", dev):
        o = query_points(depth.float(), d_sensor, d_min, d_max)
        lum = degamma(img.float().permute(0, 2, 3, 1))       # [N, H, W, C]
        quant = get_quant(net) if variant.endswith("_int8") else None
        if variant.startswith("fused"):
            from .fused_conv import fused_dp_conv_tapmajor
            from .mlp_fast import mlp_psf_tapmajor

            with trace.span("render.psf_mlp", dev):
                psf_tm = mlp_psf_tapmajor(net, o, ks, quant=quant)
            with trace.span("render.dp_conv", dev):
                render_l, render_r = fused_dp_conv_tapmajor(lum, psf_tm, ks)
            del psf_tm
        elif variant.startswith("basis"):
            from .basis import basis_dp_conv

            render_l, render_r = basis_dp_conv(net, o, lum, ks, quant=quant)
        else:
            render_l, render_r = _scan(net, o, lum, ks, mlp_bf16, scan_right)
        with trace.span("render.camera", dev):
            render = torch.cat([render_l, render_r], dim=-1)  # [N, H, W, 2C]
            render = gamma(render).permute(0, 3, 1, 2)        # [N, 2C, H, W]
            if train:
                render = dp_noise(generator, render)
            return torch.clamp(render, 0.0, 1.0)
