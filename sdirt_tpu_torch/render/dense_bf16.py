"""Dense bf16 layer of the PSF MLPs with its bias, ReLU and bf16 rounding in
the GEMM's epilogue (K3).

One launch computes ``relu(x @ w.T + b)`` rounded to bf16: bf16 operands,
f32 products and sums, the f32 bias and the ReLU on the f32 sums, one
round-to-nearest-even to bf16 on the way out, so the f32 activation never
reaches device memory. With ``tapmajor`` it writes the transpose,
``[out, rows]``, with the bias along the rows: the PSF head's tap-major
layout that K2 (fused_conv.py) reads.

The CUDA source is ../csrc/dense_bf16.cu (Hopper: TMA loads into an
mbarrier ring, wgmma, a persistent grid); it replaces no TPU kernel, since
XLA fuses the bias, ReLU and cast into its GEMMs on the TPU, and its header
comment has the design and the bound. It is compiled with nvcc into a
shared library with a plain C interface at first use in a process and
loaded with ctypes (utils/kernels.py).

On a CUDA tensor the wrapper launches the kernel or raises; only tensors on
the CPU take the plain PyTorch version, ``dense_relu_ref`` (a product with
an f32 result, then the bias, the ReLU and the cast as separate passes),
which is also what the kernel is held against on the card. The kernel has
no backward: the wrapper raises where autograd would have to record it.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ..utils import kernels

# csrc/dense_bf16.cu: the tile widths it is built for, and the row pitch
# TMA needs (a multiple of ALIGN bf16, 16 bytes)
TILE_N = (64, 128, 256)
ALIGN = 8
# the C function's own error codes (beside CUDA's)
ERRORS = {1001: "ptxas gave the kernel another register count than its "
                "setmaxnreg budget assumes (168 a thread)",
          1002: "cuTensorMapEncodeTiled is missing or refused the operands"}
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 2
             + [ctypes.c_longlong] + [ctypes.c_int] * 2 + [ctypes.c_void_p])

# launches of the CUDA kernel in this process (not of the plain version)
launches = 0


def tile_n(n: int, tapmajor: bool = False) -> int:
    """The kernel's tile width along the product's columns: the narrowest
    built width that covers a layer's ``n`` outputs (wider layers take
    several tiles of 256), and 256 along the rows of the tap-major head."""
    if tapmajor:
        return TILE_N[-1]
    return next((t for t in TILE_N if n <= t), TILE_N[-1])


@functools.cache
def _kernel():
    fn = kernels.library("dense_bf16").dense_bf16_relu
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def _check(x, w, b):
    if x.dim() != 2 or w.dim() != 2 or b.dim() != 1:
        raise ValueError(f"need x [rows, K], w [N, K] and b [N], got "
                         f"{tuple(x.shape)}, {tuple(w.shape)} and {tuple(b.shape)}")
    if x.shape[1] != w.shape[1] or b.shape[0] != w.shape[0] or x.shape[0] == 0:
        raise ValueError(f"shapes do not make a layer: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}, b {tuple(b.shape)}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16 or b.dtype != torch.float32:
        raise TypeError(f"need bf16 x and w and an f32 b, got {x.dtype}, {w.dtype} "
                        f"and {b.dtype}")
    if not (x.device == w.device == b.device):
        raise ValueError(f"x on {x.device}, w on {w.device}, b on {b.device}")
    if not (x.is_contiguous() and w.is_contiguous() and b.is_contiguous()):
        raise ValueError("x, w and b must be contiguous")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad or b.requires_grad):
        raise RuntimeError("dense_relu has no backward: call it under torch.no_grad()")


def dense_relu_ref(x, w, b, *, tapmajor: bool = False):
    """Plain PyTorch version: the product in f32, then the bias, the ReLU
    (in place: the f32 tensor is the largest of the layer) and the cast."""
    from .mlp_fast import mm_f32

    _check(x, w, b)
    if tapmajor:
        y = mm_f32(w, x.t())
        y.add_(b[:, None]).relu_()
    else:
        y = mm_f32(x, w.t()).add_(b).relu_()
    return y.to(torch.bfloat16)


def dense_relu(x, w, b, *, tapmajor: bool = False):
    """One dense layer with its ReLU, in bf16.

    x: [rows, K] bf16 activations; w: [N, K] bf16 (the torch Linear
    layout); b: [N] f32. Returns [rows, N] bf16, or with ``tapmajor`` the
    transpose [N, rows].
    """
    global launches
    _check(x, w, b)
    if x.device.type == "cpu":
        return dense_relu_ref(x, w, b, tapmajor=tapmajor)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    rows, k = x.shape
    n = w.shape[0]
    if k % ALIGN:
        # zero columns add exact zeros to the sums (the first layer's K = 3)
        x, w = F.pad(x, (0, -k % ALIGN)), F.pad(w, (0, -k % ALIGN))
        k = x.shape[1]
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("x and w must start on a 16-byte boundary (TMA)")
    out_rows, cols = (n, rows) if tapmajor else (rows, n)
    ld = -(-cols // ALIGN) * ALIGN
    out = torch.empty((out_rows, ld), dtype=torch.bfloat16, device=x.device)
    fn = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), rows, n, k, ld,
                tile_n(n, tapmajor), int(tapmajor), stream)
    if rc != 0:
        raise RuntimeError(f"dense_bf16_relu launch failed: "
                           f"{ERRORS.get(rc, f'CUDA error {rc}')}")
    launches += 1
    # a row length off the 16-byte grid (odd shapes only) was written with
    # a padded pitch
    return out if ld == cols else out[:, :cols].contiguous()
