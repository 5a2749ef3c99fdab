"""Basenet: the DfDP task wrapper, its log-depth transform and its loss
(PyTorch counterpart of sdirt_tpu/dfdp/basenet.py): the depth net on V
focus views, and in ``deblur`` mode the Mydeblur head with its three-term
loss."""

from __future__ import annotations

import torch
from torch import nn

from ..utils.device import resolve_device
from ..utils.weights import load_state
from .models.dddnet import Mydeblur, YRStereonet3D
from .models.layers import BatchNorm, CAMModule

TRAIN_MODES = ("dfdp", "deblur")


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


def compute_loss(results: dict, gt_log_depth, mask, gt_aif=None,
                 train_mode: str = "dfdp", total=None):
    """Masked SmoothL1 on log depth: {"depth_est", "total"} (0-d tensors).
    ``deblur`` adds "depth_fix" (the same on the refined depth) and "aif"
    (SmoothL1 of the all-in-focus image against ``gt_aif``, a plain mean),
    with total = 2 depth_est + depth_fix + aif.

    total: applied to every sum and count before they are divided (the
    data-parallel step passes an all_reduce over its ranks, so the loss is
    that of the whole batch); None for this batch alone."""
    if train_mode not in TRAIN_MODES:
        raise ValueError(f"train_mode {train_mode!r} not in {TRAIN_MODES}")
    reduce = (lambda t: t) if total is None else total
    m = mask.to(gt_log_depth.dtype)
    denom = reduce(m.sum()) + 1e-9

    def masked_sl1(pred):
        return reduce((smooth_l1(pred, gt_log_depth) * m).sum()) / denom

    depth_est = masked_sl1(results["pred_depth_est"])
    if train_mode == "dfdp":
        return {"depth_est": depth_est, "total": depth_est}
    if gt_aif is None:
        raise ValueError("the deblur loss needs the all-in-focus image gt_aif")
    depth_fix = masked_sl1(results["pred_depth_fix"])
    sl1 = smooth_l1(results["pred_aif"], gt_aif)
    aif = sl1.mean() if total is None else (
        total(sl1.sum()) / total(torch.tensor(float(sl1.numel()), dtype=sl1.dtype,
                                              device=sl1.device)))
    return {"depth_est": depth_est, "depth_fix": depth_fix, "aif": aif,
            "total": depth_est * 2 + depth_fix + aif}


class Basenet(nn.Module):
    """DfDP wrapper holding the depth net of ``n_views`` focus views, and
    in ``deblur`` mode the Mydeblur head (single view only, as in the JAX
    package). Weights start uninitialised: build it with
    ``build_basenet``."""

    def __init__(self, train_mode: str = "dfdp", n_views: int = 1):
        super().__init__()
        if train_mode not in TRAIN_MODES:
            raise ValueError(f"train_mode {train_mode!r} not in {TRAIN_MODES}")
        if train_mode == "deblur" and n_views != 1:
            raise ValueError("the deblur head expects a single-view stack, "
                             f"got n_views={n_views}")
        self.train_mode, self.n_views = train_mode, n_views
        self.dfdp_net = YRStereonet3D(n_views=n_views)
        if train_mode == "deblur":
            self.deblur_net = Mydeblur()

    def forward(self, stack_rgb):
        """stack_rgb: [B, 6V, H, W], view v in channels [6v, 6v + 6) as
        left RGB then right RGB; the left channels of every view, in view
        order, feed the feature tower as one image (likewise the right).
        Returns a dict of LOG depths [B, 1, H, W]: "pred_depth_est", and in
        deblur mode "pred_depth_fix" and the all-in-focus "pred_aif"
        [B, 3, H, W]. In train mode (``net.train()``) BatchNorm normalises
        with the batch's statistics and updates its running ones."""
        v = self.n_views
        if stack_rgb.dim() != 4 or stack_rgb.shape[1] != 6 * v:
            raise ValueError(f"need {v} DP view(s) [B, {6 * v}, H, W], got "
                             f"{tuple(stack_rgb.shape)}")
        if v == 1:
            left, right = stack_rgb[:, :3], stack_rgb[:, 3:]
        else:
            left = torch.cat([stack_rgb[:, 6 * i:6 * i + 3] for i in range(v)], 1)
            right = torch.cat([stack_rgb[:, 6 * i + 3:6 * i + 6]
                               for i in range(v)], 1)
        depth_est = self.dfdp_net(left, right)
        out = {"pred_depth_est": depth_est}
        if self.train_mode == "deblur":
            depth_fix, aif = self.deblur_net(left, right, depth_est)
            out.update(pred_depth_fix=depth_fix, pred_aif=aif)
        return out


@torch.no_grad()
def init_(net: nn.Module, generator: torch.Generator):
    """Draw fresh weights like the Flax net: kaiming-normal (fan_out, ReLU)
    convolutions in the depth net, LeCun truncated-normal (fan_in) ones with
    zero biases in the deblur head (Flax's defaults), unit BatchNorm scale,
    zero shift and running mean, unit running variance, zero attention
    gamma."""
    deblur = getattr(net, "deblur_net", None)
    head = set(deblur.modules()) if deblur is not None else set()
    for m in net.modules():
        if m in head and isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            # Flax's variance_scaling(1, fan_in, truncated_normal); a
            # transposed conv's input channels are torch's dim 0
            cin = m.weight.shape[0 if isinstance(m, nn.ConvTranspose2d) else 1]
            std = (1.0 / (cin * m.weight[0, 0].numel())) ** 0.5 / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std,
                                  generator=generator)
            nn.init.zeros_(m.bias)
        elif isinstance(m, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d,
                            nn.ConvTranspose3d)):
            nn.init.kaiming_normal_(m.weight, mode="fan_out",
                                    nonlinearity="relu", generator=generator)
        elif isinstance(m, BatchNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
        elif isinstance(m, CAMModule):
            m.gamma.zero_()
    return net


def build_basenet(weights: str | None = None, seed: int = 0, device="cuda",
                  train: bool = False, train_mode: str = "dfdp",
                  n_views: int = 1):
    """The depth net (``train_mode``, ``n_views``) on ``device``, in
    inference mode (train=False) or train mode: weights from an exported
    ``.npz`` tree, or drawn from ``seed`` when none is given."""
    dev = resolve_device(device)
    with torch.device("meta"):
        net = Basenet(train_mode, n_views)
    net = init_(net.to_empty(device="cpu"), torch.Generator().manual_seed(seed))
    if weights is not None:
        load_state(net, weights)
    return net.to(dev).train(train)
