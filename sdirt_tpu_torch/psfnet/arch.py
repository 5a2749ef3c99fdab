"""Implicit PSF networks (PyTorch counterpart of sdirt_tpu/psfnet/arch.py).

The production all-ReLU MLP, (x, y, z) -> ks^2 left-PSF taps, 3 -> hidden/4
-> hidden -> [hidden x hidden_layers] -> ks^2 with ReLU after every layer
including the output; the basis student, the same trunk into a ReLU'd
K-wide coefficient layer and a LINEAR K -> ks^2 basis expansion
(render/basis.py renders it without a per-pixel PSF); the MLP with a
luminance output (``mlp+lum``); the MLP encoder + convolutional decoder
(``mlpconv``); and the sinusoidal network (``siren``). The layers are named
``Dense_<i>`` / ``ConvTranspose_<i>`` like the Flax tree, so the
carried-across weights map by name (utils/weights.py). Each net's
``init_(generator)`` draws its weights from Flax's initialisers'
distributions.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

# Flax's lecun_normal: a truncated normal of variance 1 / fan_in, cut at two
# standard deviations (the constant is the std of a unit normal so cut)
_TRUNC_STD = 0.87962566103423978


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator):
    std = (1.0 / fan_in) ** 0.5 / _TRUNC_STD
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)


def _uniform_(w: torch.Tensor, bound: float, generator):
    u = torch.rand(w.shape, generator=generator)
    w.copy_(u * 2 * bound - bound)


def resize_linear(x: torch.Tensor, size) -> torch.Tensor:
    """jax.image.resize(x, (N, C, *size), "linear") of an [N, C, H, W]
    tensor: half-pixel centres, the triangle kernel widened by the scale
    when downsampling (antialiased), each output's weights normalised,
    which F.interpolate's antialiased bilinear mode also computes."""
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=False, antialias=True)


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


class PSFMLPLum(PSFMLP):
    """The MLP predicting a PSF kernel plus a luminance scalar: the PSFMLP
    trunk (ReLU'd) into a LINEAR ks^2 + 1 output, returned as (psf [..., ks,
    ks], lum [..., 1])."""

    linear_head = True

    def __init__(self, out_features: int, hidden_features: int = 512,
                 hidden_layers: int = 8):
        nn.Module.__init__(self)
        self._add_layers(_trunk(hidden_features, hidden_layers) + [out_features])

    def forward(self, x):
        layers = self.layers()
        for lin in layers[:-1]:
            x = torch.relu(lin(x))
        x = layers[-1](x)
        ks = int(round((x.shape[-1] - 1) ** 0.5))
        return x[..., :-1].reshape(*x.shape[:-1], ks, ks), x[..., -1:]


class MLPConv(nn.Module):
    """MLP encoder + convolutional decoder, for high-frequency PSFs:
    3 -> 256 -> 256 -> 512 -> ks//4 squared (ReLU but the last), reshaped
    to a ks//4 map, two 3x3 convolutions to 64 channels, a 2x nearest
    upsample, two more, a bilinear resize to ks (jax.image.resize's), one
    more and a last 3x3 to the output channels, ReLU after each. Flax's
    stride-1 SAME ConvTranspose with its kernel unflipped is a plain
    correlation, which torch's ConvTranspose2d(padding=1) computes with the
    kernel flipped, as utils/weights.py carries it across."""

    def __init__(self, ks: int, channels: int = 1):
        super().__init__()
        self.ks, self.channels = ks, channels
        self.ks_mlp = ks // 4
        dims = [3, 256, 256, 512, channels * self.ks_mlp ** 2]
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            self.add_module(f"Dense_{i}", nn.Linear(a, b))
        chans = [channels] + [64] * 5 + [channels]
        for i, (a, b) in enumerate(zip(chans[:-1], chans[1:])):
            self.add_module(f"ConvTranspose_{i}",
                            nn.ConvTranspose2d(a, b, 3, stride=1, padding=1))

    @torch.no_grad()
    def init_(self, generator: torch.Generator):
        for i in range(4):
            lin = getattr(self, f"Dense_{i}")
            _uniform_(lin.weight, math.sqrt(6.0 / lin.in_features), generator)
            lin.bias.zero_()
        for i in range(6):
            conv = getattr(self, f"ConvTranspose_{i}")
            _lecun_normal_(conv.weight, conv.weight.shape[0] * 9, generator)
            conv.bias.zero_()
        return self

    def forward(self, x):
        h = x
        for i in range(4):
            h = getattr(self, f"Dense_{i}")(h)
            if i < 3:
                h = torch.relu(h)
        h = h.reshape(-1, self.ks_mlp, self.ks_mlp, self.channels).permute(0, 3, 1, 2)
        conv = [getattr(self, f"ConvTranspose_{i}") for i in range(6)]
        h = torch.relu(conv[1](torch.relu(conv[0](h))))
        h = h.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        h = torch.relu(conv[3](torch.relu(conv[2](h))))
        h = resize_linear(h, (self.ks, self.ks))
        h = torch.relu(conv[5](torch.relu(conv[4](h))))
        return h[:, 0].reshape(*x.shape[:-1], self.ks, self.ks)


class Siren(nn.Module):
    """Sinusoidal implicit network: hidden_layers of sin(w0 (W x + b)),
    then a linear layer; the first layer drawn uniform in +-1/fan_in, the
    others in +-sqrt(6/fan_in)/w0, the last LeCun-normal, biases zero."""

    linear_head = True

    def __init__(self, out_features: int, hidden_features: int = 256,
                 hidden_layers: int = 4, w0: float = 30.0):
        super().__init__()
        self.w0, self.n_layers = w0, hidden_layers + 1
        dims = [3] + [hidden_features] * hidden_layers + [out_features]
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            self.add_module(f"Dense_{i}", nn.Linear(a, b))

    def layers(self) -> list[nn.Linear]:
        return [getattr(self, f"Dense_{i}") for i in range(self.n_layers)]

    @torch.no_grad()
    def init_(self, generator: torch.Generator):
        layers = self.layers()
        for i, lin in enumerate(layers[:-1]):
            fan_in = lin.in_features
            bound = 1.0 / fan_in if i == 0 else math.sqrt(6.0 / fan_in) / self.w0
            _uniform_(lin.weight, bound, generator)
            lin.bias.zero_()
        _lecun_normal_(layers[-1].weight, layers[-1].in_features, generator)
        layers[-1].bias.zero_()
        return self

    def forward(self, x):
        layers = self.layers()
        for lin in layers[:-1]:
            x = torch.sin(self.w0 * lin(x))
        return layers[-1](x)


def build_psfnet(model_name: str, ks: int) -> nn.Module:
    """``"mlp"`` (width 512), ``"mlp@W"`` (width W), ``"mlpb@WxK"`` (the
    basis student of width W with K coefficients, K = 64 when the name has
    no ``xK``), ``"mlpconv"``, ``"mlp+lum"`` or ``"siren"``, on the CPU."""
    if model_name.startswith("mlpb@"):
        width, _, k = model_name.split("@")[1].partition("x")
        return PSFMLPBasis(out_features=ks * ks, hidden_features=int(width),
                           basis_k=int(k) if k else 64)
    if model_name == "mlp":
        return PSFMLP(out_features=ks * ks)
    if model_name.startswith("mlp@"):
        return PSFMLP(out_features=ks * ks,
                      hidden_features=int(model_name.split("@")[1]))
    if model_name == "mlpconv":
        return MLPConv(ks=ks)
    if model_name == "mlp+lum":
        return PSFMLPLum(out_features=ks * ks + 1)
    if model_name == "siren":
        return Siren(out_features=ks * ks)
    raise ValueError(f"Unsupported PSF network architecture: {model_name}")
