"""Basenet: the DfDP task wrapper, its log-depth transform and its loss
(PyTorch counterpart of sdirt_tpu/dfdp/basenet.py, ``dfdp`` mode). The
deblur head (``train_mode="deblur"``) is not ported yet."""

from __future__ import annotations

import torch
from torch import nn

from ..utils.device import resolve_device
from ..utils.weights import load_state
from .models.dddnet import YRStereonet3D
from .models.layers import BatchNorm


def linear_depth(depth):
    """Masked log transform: depth > 0 pixels go to log depth, empty pixels
    stay 0. Returns (log_depth, mask)."""
    mask = depth > 1e-9
    out = torch.where(mask, torch.log(torch.where(mask, depth,
                                                  torch.ones_like(depth))), depth)
    return out, mask


def inverse_linear_depth(log_depth, mask=None):
    """exp transform back to metres (masked pixels keep their value)."""
    if mask is None:
        return torch.exp(log_depth)
    return torch.where(mask, torch.exp(torch.where(mask, log_depth,
                                                   torch.zeros_like(log_depth))),
                       log_depth)


def smooth_l1(pred, target):
    """SmoothL1 (beta 1), elementwise."""
    d = torch.abs(pred - target)
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)


def compute_loss(results: dict, gt_log_depth, mask, train_mode: str = "dfdp"):
    """Masked SmoothL1 on log depth: {"depth_est", "total"} (0-d tensors)."""
    if train_mode != "dfdp":
        raise NotImplementedError(
            f"train_mode {train_mode!r} is not ported yet (ROADMAP.md §1 item 5)")
    m = mask.to(gt_log_depth.dtype)
    denom = m.sum() + 1e-9
    depth_est = (smooth_l1(results["pred_depth_est"], gt_log_depth) * m).sum() / denom
    return {"depth_est": depth_est, "total": depth_est}


class Basenet(nn.Module):
    """DfDP wrapper holding the depth net. Weights start uninitialised:
    build it with ``build_basenet``."""

    def __init__(self, train_mode: str = "dfdp"):
        super().__init__()
        if train_mode != "dfdp":
            raise NotImplementedError(
                f"train_mode {train_mode!r} is not ported yet (ROADMAP.md §1 "
                "item 5)")
        self.dfdp_net = YRStereonet3D()

    def forward(self, stack_rgb):
        """stack_rgb: [B, 6, H, W], left RGB then right RGB. Returns a dict
        with the LOG depth [B, 1, H, W] under "pred_depth_est". In train mode
        (``net.train()``) BatchNorm normalises with the batch's statistics
        and updates its running ones."""
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
        elif isinstance(m, BatchNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
    return net


def build_basenet(weights: str | None = None, seed: int = 0, device="cuda",
                  train: bool = False):
    """The depth net on ``device``, in inference mode (train=False) or train
    mode: weights from an exported ``.npz`` tree, or drawn from ``seed``
    when none is given."""
    dev = resolve_device(device)
    with torch.device("meta"):
        net = Basenet()
    net = init_(net.to_empty(device="cpu"), torch.Generator().manual_seed(seed))
    if weights is not None:
        load_state(net, weights)
    return net.to(dev).train(train)
