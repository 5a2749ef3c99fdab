"""Implicit PSF network (PyTorch counterpart of sdirt_tpu/psfnet/arch.py).

Only the production all-ReLU MLP is ported here: (x, y, z) -> ks^2 left-PSF
taps, 3 -> hidden/4 -> hidden -> [hidden x hidden_layers] -> ks^2, ReLU after
every layer including the output. The layers are named ``Dense_<i>`` like the
Flax tree, so the carried-across weights map by name (utils/weights.py). The
basis student, Lum, MLPConv and Siren heads come with later slices.
"""

from __future__ import annotations

import math

import torch
from torch import nn


class PSFMLP(nn.Module):
    """3 -> hidden/4 -> hidden -> [hidden x hidden_layers] -> out, all-ReLU.

    Weights start uninitialised; ``init_(generator)`` draws them like the
    Flax net (kaiming-uniform, fan_in, gain sqrt(2); zero biases), and
    ``load_state_dict`` replaces them with carried-across ones.
    """

    def __init__(self, out_features: int, hidden_features: int = 512,
                 hidden_layers: int = 8):
        super().__init__()
        dims = [3, hidden_features // 4, hidden_features]
        dims += [hidden_features] * hidden_layers + [out_features]
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
        for lin in self.layers():
            x = torch.relu(lin(x))
        return x


def build_psfnet(model_name: str, ks: int) -> PSFMLP:
    """``"mlp"`` (width 512) or ``"mlp@W"`` (width W), on the CPU;
    other heads wait."""
    if model_name == "mlp":
        return PSFMLP(out_features=ks * ks)
    if model_name.startswith("mlp@"):
        return PSFMLP(out_features=ks * ks,
                      hidden_features=int(model_name.split("@")[1]))
    raise ValueError(f"PSF network architecture not ported yet: {model_name}")
