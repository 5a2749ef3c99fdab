"""Fused tap-major per-pixel DP convolution + PSF normalisation (K2).

Hopper counterpart of sdirt_tpu/render/fused_conv_pallas.py
(fused_dp_conv_tapmajor). The CUDA source is ../csrc/fused_dp_conv.cu; it is
compiled with nvcc into a shared library with a plain C interface at first
use in a process and loaded with ctypes (utils/kernels.py). Its header
comment has the design and the bound (memory: the 0.69 GB bf16 PSF read at
the serve shape, 0.21 ms on an H100 SXM). The kernel reads the f32 image as
it lies and pads it itself, one output tile per block, with the tile's
image rows in shared memory: ``smem_bytes`` and ``max_ks`` give what a
launch takes and the largest ks that fits.

On a CUDA tensor the wrapper launches the kernel or raises; only tensors on
the CPU take the plain PyTorch version, ``fused_dp_conv_tapmajor_ref``, which
is also what the kernel is held against on the card.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ..utils import kernels

CHANNELS = (1, 3)
# csrc/fused_dp_conv.cu: pixels per thread, tile width and height, and the
# shared memory a block may use on sm_90
VEC, TILE_W, TILE_H = 8, 128, 8
SMEM_LIMIT = 232448
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]

# launches of the CUDA kernel in this process (not of the plain version)
launches = 0


def smem_bytes(c: int, ks: int) -> int:
    """Shared memory of one launch: the tile's padded image rows in bf16,
    (TILE_H + ks - 1) x (TILE_W + VEC ceil(ks / VEC)) x c."""
    groups = -(-ks // VEC)
    return c * (TILE_H + ks - 1) * (TILE_W + VEC * groups) * 2


def max_ks(c: int) -> int:
    """The largest (odd) ks whose tile fits a block's shared memory."""
    ks = 1
    while smem_bytes(c, ks + 2) <= SMEM_LIMIT:
        ks += 2
    return ks


@functools.cache
def _kernel():
    fn = kernels.library("fused_dp_conv").fused_dp_conv_tapmajor
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def _check(img, psf_tm, ks: int):
    if img.dim() != 4:
        raise ValueError(f"img must be [N, H, W, C], got {tuple(img.shape)}")
    n, h, w, c = img.shape
    if ks % 2 != 1:
        raise ValueError(f"ks must be odd, got {ks}")
    if tuple(psf_tm.shape) != (ks * ks, n, 2, h * w):
        raise ValueError(f"psf_tm must be [ks*ks, N, 2, H*W] = "
                         f"{(ks * ks, n, 2, h * w)}, got {tuple(psf_tm.shape)}")
    if img.device != psf_tm.device:
        raise ValueError(f"img on {img.device}, psf_tm on {psf_tm.device}")


def fused_dp_conv_tapmajor_ref(img, psf_tm, ks: int):
    """Plain PyTorch version: gather the taps from the tap-major PSF, sum the
    products of the bf16 inputs in f32, divide each view by its tap sum."""
    _check(img, psf_tm, ks)
    n, h, w, c = img.shape
    pad = (ks - 1) // 2
    img_p = F.pad(img.permute(0, 3, 1, 2).float(), (pad, pad, pad, pad),
                  mode="replicate").to(torch.bfloat16).float()   # [N, C, Hp, Wp]
    psf = psf_tm.reshape(ks, ks, n, 2, h, w)
    acc_l = torch.zeros((n, c, h, w), dtype=torch.float32, device=img.device)
    acc_r = torch.zeros_like(acc_l)
    for ty in range(ks):
        rows = img_p[:, :, ks - 1 - ty:ks - 1 - ty + h]
        for dx in range(ks):
            patch = rows[..., dx:dx + w]
            acc_l += patch * psf[ty, ks - 1 - dx, :, 0, None].float()
            acc_r += patch * psf[ty, dx, :, 1, None].float()
    norm = psf.float().sum((0, 1))                              # [N, 2, H, W]
    out_l = acc_l / (norm[:, 0, None] + 1e-9)
    out_r = acc_r / (norm[:, 1, None] + 1e-9)
    return out_l.permute(0, 2, 3, 1), out_r.permute(0, 2, 3, 1)


def fused_dp_conv_tapmajor(img, psf_tm, ks: int):
    """Normalised per-pixel DP convolution from a RAW tap-major PSF.

    img:    [N, H, W, C] f32 linear luminance
    psf_tm: [ks*ks, N, 2, H*W] bf16 unnormalised network outputs
            (mlp_fast.mlp_psf_tapmajor; right view NOT kx-flipped)
    Returns (render_l, render_r): [N, H, W, C] f32.
    """
    global launches
    _check(img, psf_tm, ks)
    if img.device.type == "cpu":
        return fused_dp_conv_tapmajor_ref(img, psf_tm, ks)
    if img.device.type != "cuda":
        raise ValueError(f"no kernel for device {img.device}")
    if img.dtype != torch.float32 or psf_tm.dtype != torch.bfloat16:
        raise TypeError(f"need f32 img and bf16 psf_tm, got {img.dtype} and "
                        f"{psf_tm.dtype}")
    if not psf_tm.is_contiguous():
        raise ValueError("psf_tm must be contiguous")
    n, h, w, c = img.shape
    if c not in CHANNELS:
        raise ValueError(f"the kernel takes C in {CHANNELS}, got {c}")
    if ks > max_ks(c):
        raise ValueError(f"ks {ks} needs {smem_bytes(c, ks)} B of shared memory "
                         f"per block, above the {SMEM_LIMIT} B limit: the kernel "
                         f"takes ks <= {max_ks(c)} at C = {c}")
    fn = _kernel()
    img = img.contiguous()
    out_l = torch.empty((n, h, w, c), dtype=torch.float32, device=img.device)
    out_r = torch.empty_like(out_l)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(img.data_ptr(), psf_tm.data_ptr(), out_l.data_ptr(),
                out_r.data_ptr(), n, h, w, c, ks, stream)
    if rc != 0:
        raise RuntimeError(f"fused_dp_conv_tapmajor launch failed: CUDA error {rc}")
    launches += 1
    return out_l, out_r
