"""Work of the per-pixel DP render, counted from shapes.

Per pixel and view, the PSF surrogate's dense layers as its checkpoint
defines them (2 x sum of in x out) and the per-pixel DP convolution
(2 x ks^2 x C: a multiply and an add per tap and channel). The same work is
counted whichever render variant computes it, so a variant that needs less
arithmetic shows as a higher share of the peak.
"""

from __future__ import annotations


def dense_flops(dims) -> int:
    """2 x sum(in x out) over the chain dims[0] -> dims[1] -> ..."""
    return 2 * sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def surrogate_dims(psfnet: dict) -> list[int]:
    """The Dense chain of a surrogate described by the configuration:
    3 -> W/4 -> W -> [W x layers] (-> K) -> ks^2."""
    w, ks = psfnet["hidden"], psfnet["ks"]
    dims = [3, w // 4] + [w] * (psfnet["hidden_layers"] + 1)
    if psfnet.get("basis_k"):
        dims.append(psfnet["basis_k"])
    return dims + [ks * ks]


def render_flops(psfnet: dict, h: int, w: int, c: int = 3) -> int:
    """FLOPs of one sample's render: both views, every pixel."""
    ks = psfnet["ks"]
    per_pixel = dense_flops(surrogate_dims(psfnet)) + 2 * ks * ks * c
    return 2 * h * w * per_pixel
