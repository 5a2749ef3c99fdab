"""Implicit PSF network (PyTorch counterpart of sdirt_tpu/psfnet/arch.py).

Two heads are ported: the production all-ReLU MLP, (x, y, z) -> ks^2
left-PSF taps, 3 -> hidden/4 -> hidden -> [hidden x hidden_layers] -> ks^2
with ReLU after every layer including the output; and the basis student,
the same trunk into a ReLU'd K-wide coefficient layer and a LINEAR K -> ks^2
basis expansion (render/basis.py renders it without a per-pixel PSF). The
layers are named ``Dense_<i>`` like the Flax tree, so the carried-across
weights map by name (utils/weights.py). The Lum, MLPConv and Siren heads
come with later slices.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def _trunk(hidden_features: int, hidden_layers: int) -> list[int]:
    return [3, hidden_features // 4] + [hidden_features] * (hidden_layers + 1)


class PSFMLP(nn.Module):
    """3 -> hidden/4 -> hidden -> [hidden x hidden_layers] -> out, all-ReLU.

    Weights start uninitialised; ``init_(generator)`` draws them like the
    Flax net (kaiming-uniform, fan_in, gain sqrt(2); zero biases), and
    ``load_state_dict`` replaces them with carried-across ones.
    """

    linear_head = False

    def __init__(self, out_features: int, hidden_features: int = 512,
                 hidden_layers: int = 8):
        super().__init__()
        self._add_layers(_trunk(hidden_features, hidden_layers) + [out_features])

    def _add_layers(self, dims):
        self.n_layers = len(dims) - 1
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            self.add_module(f"Dense_{i}", nn.utils.skip_init(
                nn.Linear, a, b, device="cpu"))

    def layers(self) -> list[nn.Linear]:
        return [getattr(self, f"Dense_{i}") for i in range(self.n_layers)]

    @torch.no_grad()
    def init_(self, generator: torch.Generator):
        for lin in self.layers():
            bound = math.sqrt(6.0 / lin.in_features)
            w = torch.rand(lin.weight.shape, generator=generator)
            lin.weight.copy_(w * 2 * bound - bound)
            lin.bias.zero_()
        return self

    def forward(self, x):
        layers = self.layers()
        for lin in layers[:-1]:
            x = torch.relu(lin(x))
        x = layers[-1](x)
        return x if self.linear_head else torch.relu(x)


class PSFMLPBasis(PSFMLP):
    """PSFMLP trunk -> ReLU'd K-wide coefficients -> LINEAR basis expansion
    to ks^2 taps: 3 -> W/4 -> W -> [W x hidden_layers] -> K -> ks^2, ReLU
    after every layer but the last. With a linear last layer the per-pixel
    DP convolution factors through the K basis kernels (render/basis.py).
    Its layers are PSFMLP's with one more Dense, so a PSFMLP checkpoint of
    the same width warm-starts the trunk (PSFNetLens.load_net)."""

    linear_head = True

    def __init__(self, out_features: int, hidden_features: int = 256,
                 hidden_layers: int = 8, basis_k: int = 64):
        nn.Module.__init__(self)
        self.basis_k = basis_k
        self._add_layers(_trunk(hidden_features, hidden_layers)
                         + [basis_k, out_features])


def build_psfnet(model_name: str, ks: int) -> PSFMLP:
    """``"mlp"`` (width 512), ``"mlp@W"`` (width W) or ``"mlpb@WxK"`` (the
    basis student of width W with K coefficients, K = 64 when the name has
    no ``xK``), on the CPU; other heads wait."""
    if model_name.startswith("mlpb@"):
        width, _, k = model_name.split("@")[1].partition("x")
        return PSFMLPBasis(out_features=ks * ks, hidden_features=int(width),
                           basis_k=int(k) if k else 64)
    if model_name == "mlp":
        return PSFMLP(out_features=ks * ks)
    if model_name.startswith("mlp@"):
        return PSFMLP(out_features=ks * ks,
                      hidden_features=int(model_name.split("@")[1]))
    raise ValueError(f"PSF network architecture not ported yet: {model_name}")
