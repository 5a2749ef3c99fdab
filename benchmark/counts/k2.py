"""Least time of the per-pixel DP convolution kernel (K2) at a shape: its
inputs read once (the f32 image, the bf16 tap-major PSF), its outputs
written once (two f32 views), or its f32 operations (per tap and pixel, a
multiply-add per view and channel and the two tap sums), whichever is
larger."""

from __future__ import annotations

from .peaks import F32_FLOPS, HBM_BYTES_PER_S


def bound_ms(n: int, h: int, w: int, c: int, ks: int) -> tuple[float, str]:
    nbytes = n * h * w * c * 4 + ks * ks * n * 2 * h * w * 2 + 2 * n * h * w * c * 4
    flops = ks * ks * n * h * w * (2 * 2 * c + 2)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
