"""Basenet: the DfDP task wrapper, forward pass only (PyTorch counterpart of
sdirt_tpu/dfdp/basenet.py). Losses and the deblur head come with the
training slice."""

from __future__ import annotations

import torch
from torch import nn

from ..utils.device import resolve_device
from ..utils.weights import load_state
from .models.dddnet import YRStereonet3D


class Basenet(nn.Module):
    """DfDP wrapper holding the depth net. Weights start uninitialised:
    build it with ``build_basenet``."""

    def __init__(self, train_mode: str = "dfdp"):
        super().__init__()
        if train_mode != "dfdp":
            raise NotImplementedError(f"train_mode {train_mode!r} is not ported yet")
        self.dfdp_net = YRStereonet3D()

    def forward(self, stack_rgb):
        """stack_rgb: [B, 6, H, W], left RGB then right RGB. Returns a dict
        with the LOG depth [B, 1, H, W] under "pred_depth_est"."""
        if stack_rgb.shape[1] != 6:
            raise ValueError(f"need one DP view [B, 6, H, W], got "
                             f"{tuple(stack_rgb.shape)}")
        left, right = stack_rgb[:, :3], stack_rgb[:, 3:]
        return {"pred_depth_est": self.dfdp_net(left, right)}


@torch.no_grad()
def init_(net: nn.Module, generator: torch.Generator):
    """Draw fresh weights like the Flax net: kaiming-normal (fan_out, ReLU)
    convolutions, unit BatchNorm scale, zero shift and running mean, unit
    running variance."""
    for m in net.modules():
        if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d,
                          nn.ConvTranspose3d)):
            nn.init.kaiming_normal_(m.weight, mode="fan_out",
                                    nonlinearity="relu", generator=generator)
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
            m.num_batches_tracked.zero_()
    return net


def build_basenet(weights: str | None = None, seed: int = 0, device="cuda"):
    """The depth net in inference mode on ``device``: weights from an
    exported ``.npz`` tree, or drawn from ``seed`` when none is given."""
    dev = resolve_device(device)
    with torch.device("meta"):
        net = Basenet()
    net = init_(net.to_empty(device="cpu"), torch.Generator().manual_seed(seed))
    if weights is not None:
        load_state(net, weights)
    return net.to(dev).eval()
