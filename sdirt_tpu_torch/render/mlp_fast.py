"""Explicit-GEMM forward of the PSF MLP, tap-major output, with a bf16 or a
static-scale int8 trunk (PyTorch counterpart of sdirt_tpu/render/mlp_fast.py).

The left and x-mirrored right query sets go through ONE GEMM chain, and the
last layer is computed as W^T H^T so the PSF comes out tap-major,
``[ks*ks, N, 2, P]``, the layout the fused conv (fused_conv.py) reads with
neighbouring pixels at neighbouring addresses. Numerics follow the JAX
chain: bf16 operands, f32 accumulation, bias and ReLU in f32, activations
rounded to bf16 between layers. On the card every bf16 layer, the head
included, is one launch of K3 (dense_bf16.py), which does the bias, ReLU and
rounding in its epilogue, as XLA fused them into its GEMMs on the TPU; on
the CPU it is the plain product and passes.

The ``fused_int8`` / ``basis_int8`` trunk (``quantize_mlp``, ``quant_trunk``)
runs the layers after the first two as int8 x int8 -> int32 products
(``torch._int_mm``, cuBLAS on the card) with symmetric per-output-channel
weight scales and a STATIC per-tensor activation scale per layer, calibrated
once in numpy over the query domain [-1, 1]^2 x [0, 1]. The requantisation
between layers (scale, bias, round, clip, -128, cast) is plain elementwise
``torch``: several passes over the [rows, width] activations per layer,
which XLA fused into the GEMM chain on the TPU.
"""

from __future__ import annotations

import numpy as np
import torch

from .dense_bf16 import dense_relu


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


def bf16_trunk(layers, x):
    """bf16 forward of ``layers`` (ReLU after each) on the rows x: bf16
    operands, f32 sums, bias and ReLU in f32, bf16 out; one K3 launch a
    layer on the card."""
    h = x.to(torch.bfloat16)
    for w, b in layers:
        h = dense_relu(h, w.to(torch.bfloat16), b)
    return h


def mlp_psf_tapmajor(net, o, ks: int, *, quant=None):
    """Evaluate the PSF MLP for both DP views, returning the UNNORMALISED PSF
    tap-major: [ks*ks, N, 2, P] bf16 (taps ky-major, sample, view
    left/right, P pixels per sample). The right view's kx flip is NOT
    applied; the fused conv indexes its taps mirrored instead.
    quant: None for the bf16 trunk, or the int8 pack of ``quantize_mlp``."""
    layers = dense_layers(net)
    x = stack_views(o)                                     # [N*2*P, 3]
    if quant is not None:
        h = quant_trunk(layers, quant, x)                  # [N*2*P, 512] f32
    else:
        h = bf16_trunk(layers[:-1], x)
    w, b = layers[-1]                                      # [ks*ks, 512]
    psf = dense_relu(h.to(torch.bfloat16), w.to(torch.bfloat16), b, tapmajor=True)
    n = o.shape[0]
    p = x.shape[0] // (2 * n)
    return psf.reshape(ks * ks, n, 2, p)


def mlp_psf_pixelmajor(net, o, ks: int, *, quant=None):
    """The same PSFs sum-normalised and pixel-major, [..., 2, ks, ks] with
    the right view kx-flipped (surrogate.pred_psf's layout), through the
    one-GEMM chain: for tests and the plain paths."""
    psf_tm = mlp_psf_tapmajor(net, o, ks, quant=quant)     # [ks*ks, N, 2, P]
    psf = psf_tm.float().permute(1, 3, 2, 0).reshape(*o.shape[:-1], 2, ks, ks)
    psf = torch.stack([psf[..., 0, :, :], psf[..., 1, :, :].flip(-1)], -3)
    return psf / (psf.sum((-1, -2), keepdim=True) + 1e-9)


# ---------------------------------------------------------------------------
# int8 (w8a8) trunk with static activation scales
# ---------------------------------------------------------------------------

def _calibrate_amax(np_layers, n_cal=65536, margin=1.05, seed=0):
    """Per-trunk-layer input amax over the closed query domain
    [-1, 1]^2 x [0, 1] (the x-mirrored right-view queries lie in the same
    domain), from a numpy forward of n_cal seeded points plus the 12
    corners. np_layers are Flax-layout (kernel [in, out], bias) f32 pairs.
    A copy of the JAX package's numpy code: the same draws, the same
    scales."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n_cal, 3)).astype(np.float32)
    x[:, 2] = rng.uniform(0, 1, n_cal)
    corners = np.array([[sx, sy, z] for sx in (-1, 1) for sy in (-1, 1)
                        for z in (0.0, 0.5, 1.0)], np.float32)
    x = np.concatenate([x, corners])
    h = np.maximum(x @ np_layers[0][0] + np_layers[0][1], 0.0)
    h = np.maximum(h @ np_layers[1][0] + np_layers[1][1], 0.0)
    amax = [float(h.max())]
    for w, b in np_layers[2:-1]:
        h = np.maximum(h @ w + b, 0.0)
        amax.append(float(h.max()))
    return [a * margin + 1e-12 for a in amax]


def quantize_mlp(net):
    """The static-scale int8 pack of the net's layers [2:-1] (for the basis
    student this includes the coefficient layer), on the net's device.

    Weights: symmetric per-output-channel scales ws = amax over the input
    axis / 127, q = round(w / ws) (numpy's round, half to even).
    Activations: the ReLU output entering layer i is quantised as
    clip(round(h / sa_i), 0, 255) - 128 with sa_i = amax_i / 255, so
    relu(acc * wse + be) undoes it with wse = sa * ws and
    be = b + 128 * colsum(q) * wse, both folded here.

    Returns {"wq": [int8 [out_i, in_i]] (the torch Linear layout; the Flax
    pack holds the transpose), "sc": [f32 [4, out_i]]} with sc rows
    0 = bias, 1 = wse, 2 = be, 3 = 1/sa of the layer's INPUT.
    """
    layers = dense_layers(net)
    dev = layers[0][0].device
    np_layers = [(w.detach().float().cpu().numpy().T,
                  b.detach().float().cpu().numpy()) for w, b in layers]
    amax = _calibrate_amax(np_layers)
    wq, sc = [], []
    for i, (w, b) in enumerate(np_layers[2:-1]):
        ws = np.abs(w).max(0) / 127.0 + 1e-12              # per out-channel
        q = np.round(w / ws).astype(np.int8)               # [in, out]
        sa = amax[i] / 255.0
        wse = sa * ws
        sci = np.zeros((4, w.shape[1]), np.float32)
        sci[0, :] = b
        sci[1, :] = wse
        sci[2, :] = b + 128.0 * q.astype(np.float32).sum(0) * wse
        sci[3, :] = 1.0 / sa
        wq.append(torch.from_numpy(np.ascontiguousarray(q.T)).to(dev))
        sc.append(torch.from_numpy(sci).to(dev))
    return {"wq": wq, "sc": sc}


def _requant(y, inv):
    """f32 activations -> int8: clip(round(y * inv), 0, 255) - 128, in
    place on y (round half to even, as jnp.round). The ReLU before it is
    implied: a negative y rounds to <= 0 and clips to 0."""
    return y.mul_(inv).round_().clamp_(0.0, 255.0).sub_(128.0).to(torch.int8)


def quant_trunk(layers, qd, x):
    """int8 (w8a8, static scales) forward of the trunk: layers 0-1 in
    bf16 (bf16 x bf16 for the first, the f32 activations times the bf16
    weights in f32 for the second, as the JAX chain promotes them), then
    layers [2:-1] as int8 x int8 -> int32 GEMMs with the requantisation in
    f32 between them. Returns the last quantised layer's ReLU output, f32
    [rows, out]."""
    (w0, b0), (w1, b1) = layers[:2]
    h = mm_f32(x.to(torch.bfloat16), w0.to(torch.bfloat16).t()).add_(b0).relu_()
    h = torch.mm(h, w1.to(torch.bfloat16).float().t()).add_(b1).relu_()
    hq = _requant(h, qd["sc"][0][3, 0])
    n = len(qd["wq"])
    for i in range(n):
        acc = torch._int_mm(hq, qd["wq"][i].t())           # int32 [rows, out]
        y = acc.float().mul_(qd["sc"][i][1]).add_(qd["sc"][i][2])
        del acc
        if i < n - 1:
            hq = _requant(y, qd["sc"][i + 1][3, 0])
        else:
            h = y.relu_()
    return h
