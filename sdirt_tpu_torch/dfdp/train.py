"""DfDP inference step (PyTorch counterpart of sdirt_tpu/dfdp/train.py:
dfdp_infer). The train step comes with the training slice."""

from __future__ import annotations

import torch


@torch.no_grad()
def dfdp_infer(net, stack_rgb):
    """Depth in metres: exp of the net's log depth. stack_rgb: [B, 6, H, W]."""
    return torch.exp(net(stack_rgb)["pred_depth_est"].float())
