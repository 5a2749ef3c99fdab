"""Plain reference of the training render: a DP pair per RGB-D sample.

Semantics (Sdirt's per-pixel DP render, as the cell's configuration states
it), written for this benchmark and sharing no code with the program:

- upload: the all-in-focus image quantised to uint8 (``floor(255 x + 0.5)``
  in float32) and the depth map to float16, both widened to float32;
- every pixel queries the PSF surrogate at (x, y, z): x from -1 (left) to 1,
  y from 1 (top) to -1, z = clip((-1000 depth + d_sensor + DMIN) /
  (DMIN - DMAX), 0, 1) with depth in metres and the lens's pinned sensor
  distance; the right view's PSF is the net at (-x, y, z), mirrored in kx;
- the image goes to linear luminance (the Canon R6M2 response fit), is
  replicate-padded, and each view's output pixel is the sum over the taps of
  psf[ty, tx] * lum[y + ks-1-ty, x + ks-1-tx] (a convolution), divided by the
  sum of the taps plus 1e-9;
- back through the response; the DP noise (a uniform scale and ramps, one
  normal draw per value, the right views' ramp mirrored) is added; clip to
  [0, 1].

Precision, as the configuration states it: the surrogate's GEMMs take bf16
operands with float32 sums, bias and ReLU in float32, activations rounded
to bf16 between layers, the PSF taps rounded to bf16; the DP convolution
takes bf16 luminance and taps with float32 sums. For the ``basis`` render
(a linear-head surrogate, PSF = coefficients . basis + bias) the image is
convolved with each basis kernel (bf16 operands, float32 sums, the result
rounded to bf16) and contracted with the bf16 coefficients in float32.
Products of bf16 values are exact in float32, so every GEMM here runs in
float32 on bf16-valued operands with TF32 off: only the order of the sums
differs from a bf16 GEMM.

The noise is drawn from a ``torch.Generator`` set to the state the
benchmark recorded before the program's render of the batch: three
uniforms (scale, ramp start, ramp end), then the normal draw of the stack's
shape.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

# Canon R6M2 response fit (two reciprocal branches blended by x / 100)
_A1, _B1, _C1 = 0.89129432, 0.27217316, -0.00246187
_A2, _B2, _C2 = 5.94018909e-01, 1.20060450e01, -5.24983855e-03
ROWS = 1 << 17          # surrogate rows per GEMM chunk


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """Float32 GEMMs and convolutions with TF32 on or off, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to bfloat16 (nearest even) and widen back to float32."""
    return x.to(torch.bfloat16).float()


def degamma(img):
    """[0, 1] image -> linear luminance."""
    x = img * 255.0
    l1 = 1.0 / (1.0 / (_A1 * x + _B1) + _C1)
    l2 = 1.0 / (1.0 / (_A2 * x + _B2) + _C2)
    t = torch.clamp(x / 100.0, max=1.0)
    return l2 * t + l1 * (1.0 - t)


def gamma(lum):
    """linear luminance -> [0, 1] image."""
    inv = 1.0 / (lum + 1e-9)
    x1 = (1.0 / (inv - _C1) - _B1) / _A1
    x2 = (1.0 / (inv - _C2) - _B2) / _A2
    t = torch.clamp((x1 + x2) / 2.0 / 100.0, max=1.0)
    return (x2 * t + x1 * (1.0 - t)) / 255.0


def upload(aif: np.ndarray, depth: np.ndarray, device):
    """Host batch -> device tensors as the training render sees them."""
    img = (np.asarray(aif, np.float32) * np.float32(255.0) + np.float32(0.5)).astype(np.uint8)
    img = torch.from_numpy(img).to(device).float() / 255.0
    d = torch.from_numpy(np.asarray(depth).astype(np.float16)).to(device).float()
    return img, d


def queries(depth_m, lens):
    """[H, W] depth in metres -> [H*W, 3] (x, y, z), row-major pixels."""
    h, w = depth_m.shape
    dev = depth_m.device
    z = (-1000.0 * depth_m + lens["d_sensor_mm"] + lens["dmin_mm"]) / (
        lens["dmin_mm"] - lens["dmax_mm"])
    z = torch.clamp(z, 0.0, 1.0)
    y, x = torch.meshgrid(torch.linspace(1, -1, h, device=dev),
                          torch.linspace(-1, 1, w, device=dev), indexing="ij")
    return torch.stack([x, y, z], -1).reshape(-1, 3)


def _surrogate(layers, q, relu_last: bool):
    """bf16 forward of the Dense stack on rows q: f32 out, bf16-valued."""
    h = bf16(q)
    for i, (k, b) in enumerate(layers):
        h = h @ bf16(k) + b
        if i < len(layers) - 1 or relu_last:
            h = torch.relu(h)
        h = bf16(h)
    return h


def surrogate(layers, q, relu_last: bool = True):
    return torch.cat([_surrogate(layers, q[i:i + ROWS], relu_last)
                      for i in range(0, q.shape[0], ROWS)])


def _pad(lum, p):
    """[C, H, W] -> replicate-padded bf16-valued [C, H + 2p, W + 2p]."""
    return bf16(F.pad(lum[None], (p, p, p, p), mode="replicate")[0])


def perpixel_conv(lum, psf, ks: int):
    """lum [C, H, W]; psf [ks*ks, H, W] unnormalised taps (ty-major).
    Returns [C, H, W]: sum_t psf[ty, tx] lum[y + ks-1-ty, x + ks-1-tx] over
    the tap sum plus 1e-9."""
    c, h, w = lum.shape
    img = _pad(lum, (ks - 1) // 2)
    acc = torch.zeros((c, h, w), dtype=torch.float32, device=lum.device)
    for ty in range(ks):
        for tx in range(ks):
            acc += psf[ty * ks + tx] * img[:, ks - 1 - ty:ks - 1 - ty + h,
                                           ks - 1 - tx:ks - 1 - tx + w]
    return acc / (psf.sum(0) + 1e-9)


def _mirror_kx(taps, ks):
    """[ks*ks, ...] ty-major taps -> the same mirrored in tx."""
    return taps.reshape(ks, ks, *taps.shape[1:]).flip(1).reshape(taps.shape)


def mlp_views(layers, lum, depth_m, lens, ks):
    """The per-pixel PSF render of one sample: (left, right) [C, H, W]."""
    _, h, w = lum.shape
    q = queries(depth_m, lens)
    outs = []
    for sign in (1.0, -1.0):
        qv = q * torch.tensor([sign, 1.0, 1.0], device=q.device)
        taps = surrogate(layers, qv).t().reshape(ks * ks, h, w)
        if sign < 0:
            taps = _mirror_kx(taps, ks)
        outs.append(perpixel_conv(lum, taps, ks))
        del taps
    return outs


def basis_views(layers, lum, depth_m, lens, ks):
    """The basis render of one sample: PSF = coeff . basis + bias per pixel,
    applied as one convolution per basis kernel. (left, right) [C, H, W]."""
    c, h, w = lum.shape
    basis, bias = layers[-1]                      # [K, ks*ks], [ks*ks]
    kdim = basis.shape[0]
    q = queries(depth_m, lens)
    img = _pad(lum, (ks - 1) // 2)[:, None]       # [C, 1, Hp, Wp]
    outs = []
    for sign in (1.0, -1.0):
        qv = q * torch.tensor([sign, 1.0, 1.0], device=q.device)
        coeff = surrogate(layers[:-1], qv)        # [P, K] bf16-valued
        kern = torch.cat([basis, bias[None]])     # [K + 1, ks*ks]
        if sign < 0:
            kern = _mirror_kx(kern.t(), ks).t()
        # a correlation with the kernel flipped in both axes is the
        # convolution the per-pixel render applies
        bank = kern.reshape(kdim + 1, 1, ks, ks).flip(-1, -2)
        g = bf16(F.conv2d(img, bf16(bank)))       # [C, K + 1, H, W]
        cm = coeff.t().reshape(kdim, h, w)
        acc = g[:, kdim].clone()
        for k in range(kdim):
            acc += cm[k] * g[:, k]
        norm = coeff @ basis.sum(1) + bias.sum()  # [P]
        outs.append(acc / (norm.reshape(h, w) + 1e-9))
    return outs


def dp_noise(stack, gen_state, device):
    """stack + DP noise from a generator restored to ``gen_state``."""
    gen = torch.Generator(device=device)
    gen.set_state(gen_state)
    u = torch.rand(3, generator=gen, device=device)
    noise = torch.randn(tuple(stack.shape), generator=gen, device=device)
    n, c2, h, w = stack.shape
    ramp = u[1] / 2.0 + (u[2] / 2.0 + 0.5 - u[1] / 2.0) * torch.arange(
        w, dtype=torch.float32, device=device) / (w - 1)
    weight = torch.cat([ramp.expand(n, c2 // 2, h, w),
                        ramp.flip(0).expand(n, c2 // 2, h, w)], 1)
    return stack + noise * (0.05 * u[0]) * weight


def render_batch(layers, aif, depth, lens, ks: int, kind: str, gen_state=None,
                 device="cuda", tf32: bool = False):
    """The training render of one host batch: aif [B, 3, H, W], depth
    [B, 1, H, W] metres (numpy). kind: "mlp" (all-ReLU surrogate, PSF per
    pixel) or "basis" (linear-head student). gen_state: the noise
    generator's state before the draw; None renders without noise. layers:
    [(kernel [in, out], bias)] as device tensors. Returns [B, 6, H, W]."""
    views = {"mlp": mlp_views, "basis": basis_views}[kind]
    with torch.no_grad(), matmul_precision(tf32):
        img, d = upload(aif, depth, device)
        out = []
        for i in range(img.shape[0]):
            lum = degamma(img[i])
            left, right = views(layers, lum, d[i, 0], lens, ks)
            out.append(torch.cat([left, right]))
        stack = gamma(torch.stack(out))
        if gen_state is not None:
            stack = dp_noise(stack, gen_state, device)
        return torch.clamp(stack, 0.0, 1.0)


def device_layers(np_layers, device):
    return [(torch.from_numpy(k).to(device), torch.from_numpy(b).to(device))
            for k, b in np_layers]
