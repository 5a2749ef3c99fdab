"""Basis-convolution DP render for linear-head PSF students
(PyTorch counterpart of sdirt_tpu/render/basis.py).

The PSFMLPBasis student's last layer is linear, so with per-pixel ReLU'd
coefficients c[px, k] and the fixed basis kernels B_k plus the bias kernel b,

    out[px] = sum_t psf[px, t] img[px + t]
            = sum_k c[px, k] (B_k * img)[px] + (b * img)[px],

and the per-pixel PSF never exists: the render is one coefficient MLP, one
dense convolution of the image with a bank of 2K + 2 kernels (both views),
a K-contraction and the per-pixel normalisation, which commutes:
s[px] = c[px] . rowsum(B) + sum(b). The right view's taps are the kx mirror
of the x-mirrored query, so its bank is the left one flipped in kx.

The conv is ``torch.nn.functional.conv2d`` (the JAX package leaves it to
XLA's conv_general_dilated, outside any Pallas kernel); both compute
cross-correlation. Numerics follow the JAX code: bf16 operands with f32
sums, the conv output rounded to bf16, the contraction's f32 sums of exact
bf16 products, the normalisation sums from the f32 basis. float32 as
``compute_dtype`` is the exact-parity debug path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils import trace
from .mlp_fast import bf16_trunk, dense_layers, quant_trunk, stack_views


def basis_coeffs(net, o, quant=None, compute_dtype=torch.bfloat16):
    """ReLU'd basis coefficients of both DP views in one GEMM chain.

    o: [N, ..., 3] queries. Returns [N, 2, P, K] f32 (view 0 left, view 1
    the x-mirrored right query). quant: the int8 pack of
    mlp_fast.quantize_mlp (its layers [2:-1] include the coefficient layer);
    compute_dtype: the GEMM operands' type without it, bf16 or f32.
    """
    layers = dense_layers(net)
    x = stack_views(o)                                     # [N*2*P, 3]
    if quant is not None:
        h = quant_trunk(layers, quant, x)
    elif compute_dtype == torch.float32:
        h = x
        for w, b in layers[:-1]:
            h = torch.relu(torch.mm(h, w.t()) + b)
    else:
        h = bf16_trunk(layers[:-1], x)
    n = o.shape[0]
    return h.float().reshape(n, 2, -1, h.shape[-1])


def _conv_bank(img_b, bank, compute_dtype):
    """[M, 1, Hp, Wp] x [F, 1, ks, ks] valid cross-correlation -> [M, F, H, W]
    in compute_dtype: f32 sums of the compute_dtype operands, rounded once.
    The card's cuDNN takes bf16 operands and sums in f32; the CPU widens
    them to f32 first, which gives the same exact products."""
    img_c, bank_c = img_b.to(compute_dtype), bank.to(compute_dtype)
    if img_b.is_cuda:
        return F.conv2d(img_c, bank_c)
    return F.conv2d(img_c.float(), bank_c.float()).to(compute_dtype)


def _contract(coeff, g):
    """sum_k coeff[n, k, h, w] g[n, c, k, h, w] in f32, one k at a time:
    the products of the (compute-type) operands are exact in f32, so this
    is the JAX einsum's preferred_element_type=f32 sum, with no [N, C, K,
    H, W] f32 temporary. coeff: [N, K, H, W]; g: [N, C, K, H, W]."""
    acc = g[:, :, 0].float() * coeff[:, None, 0].float()
    for k in range(1, coeff.shape[1]):
        acc.addcmul_(g[:, :, k].float(), coeff[:, None, k].float())
    return acc


def basis_dp_conv(net, o, lum, ks: int, quant=None,
                  compute_dtype=torch.bfloat16):
    """DP pair through the basis.

    net: a PSFMLPBasis (last layer linear, [ks*ks, K] + bias).
    o:   [N, H, W, 3] per-pixel queries; lum: [N, H, W, C] linear luminance.
    Returns (render_l, render_r): [N, H, W, C] f32, sum-normalised as
    surrogate.pred_psf + perpixel.local_dp_conv would be.
    """
    n, hh, ww, c = lum.shape
    layers = dense_layers(net)
    bm, bb = layers[-1]                                    # [ks*ks, K], [ks*ks]
    kdim = bm.shape[1]
    with trace.span("render.psf_mlp", lum.device):
        coeff = basis_coeffs(net, o, quant=quant, compute_dtype=compute_dtype)
    coeff = coeff.reshape(n, 2, hh, ww, kdim)
    with trace.span("render.dp_conv", lum.device):
        # the unnormalised tap sums, from the f32 basis (a flip leaves them)
        s = coeff @ bm.float().sum(0) + bb.float().sum()   # [N, 2, H, W]

        # local_dp_conv applies psf[ks-1-dy, ks-1-dx] to img_pad[y+dy, x+dx]:
        # the left taps enter flipped in both axes, the right view's (already
        # kx-mirrored) in ky only
        basis = bm.float().t().reshape(kdim, ks, ks)
        bias_k = bb.float().reshape(1, ks, ks)
        bank = torch.cat([basis.flip(-1, -2), bias_k.flip(-1, -2),
                          basis.flip(-2), bias_k.flip(-2)])  # [2K+2, ks, ks]

        pad = (ks - 1) // 2
        img_b = F.pad(lum.permute(0, 3, 1, 2).reshape(n * c, 1, hh, ww),
                      (pad, pad, pad, pad), mode="replicate")
        g = _conv_bank(img_b, bank[:, None], compute_dtype)
        g = g.reshape(n, c, 2 * kdim + 2, hh, ww)

        cq = coeff.to(compute_dtype).permute(0, 1, 4, 2, 3)  # [N, 2, K, H, W]
        out_l = _contract(cq[:, 0], g[:, :, :kdim]) + g[:, :, kdim].float()
        out_r = (_contract(cq[:, 1], g[:, :, kdim + 1:2 * kdim + 1])
                 + g[:, :, 2 * kdim + 1].float())
        inv = 1.0 / (s + 1e-9)                             # [N, 2, H, W]
        out_l = (out_l * inv[:, 0, None]).permute(0, 2, 3, 1)
        out_r = (out_r * inv[:, 1, None]).permute(0, 2, 3, 1)
        return out_l, out_r
