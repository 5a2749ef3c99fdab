"""Explicit-GEMM forward of the PSF MLP, tap-major output
(PyTorch counterpart of sdirt_tpu/render/mlp_fast.py, bf16 trunk).

The left and x-mirrored right query sets go through ONE GEMM chain, and the
last layer is computed as W^T H^T so the PSF comes out tap-major,
``[ks*ks, N, 2, P]``, the layout the fused conv (fused_conv.py) reads with
neighbouring pixels at neighbouring addresses. Numerics follow the JAX
chain: bf16 operands, f32 accumulation, bias and ReLU in f32, activations
rounded to bf16 between layers. The GEMMs are plain ``torch`` products, as
the JAX package left them to XLA outside any Pallas kernel. The static-scale
int8 (w8a8) trunk of the ``fused_int8`` variant comes with a later slice.
"""

from __future__ import annotations

import torch


def dense_layers(net):
    """[(weight [out, in], bias [out]), ...] in layer order from a PSFMLP."""
    return [(lin.weight, lin.bias) for lin in net.layers()]


def stack_views(o):
    """[N, ..., 3] query points -> [N*2*P, 3] rows ordered (sample, view,
    pixel): per sample, left queries then x-mirrored right queries."""
    n = o.shape[0]
    flat = o.reshape(n, -1, 3)
    mirror = torch.tensor([-1.0, 1.0, 1.0], dtype=o.dtype, device=o.device)
    return torch.stack([flat, flat * mirror], 1).reshape(-1, 3)


def mm_f32(a, b):
    """bf16 x bf16 -> f32 product with f32 accumulation. On the card the
    tensor cores take the bf16 operands; on the CPU the operands are widened
    first, which gives the same exact products (8-bit mantissas)."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def mlp_psf_tapmajor(net, o, ks: int):
    """Evaluate the PSF MLP for both DP views, returning the UNNORMALISED PSF
    tap-major: [ks*ks, N, 2, P] bf16 (taps ky-major, sample, view
    left/right, P pixels per sample). The right view's kx flip is NOT
    applied; the fused conv indexes its taps mirrored instead."""
    layers = dense_layers(net)
    x = stack_views(o)                                     # [N*2*P, 3]
    h = x.to(torch.bfloat16)
    for w, b in layers[:-1]:
        h = mm_f32(h, w.to(torch.bfloat16).t()).add_(b).relu_()
        h = h.to(torch.bfloat16)
    w, b = layers[-1]                                      # [ks*ks, 512]
    psf = mm_f32(w.to(torch.bfloat16), h.t())              # [ks*ks, N*2*P]
    psf.add_(b[:, None]).relu_()        # in place: the f32 PSF is 1.4 GB
    n = o.shape[0]
    p = x.shape[0] // (2 * n)
    return psf.to(torch.bfloat16).reshape(ks * ks, n, 2, p)
