"""DfDP train and inference steps (PyTorch counterpart of
sdirt_tpu/dfdp/train.py); the net's ``train_mode`` picks the loss and what
inference returns.

The optimiser reproduces the JAX package's optax chain
``clip_by_global_norm(1.0)`` -> ``adamw(cosine(lr, T_max=total_steps))``:
the global norm clip is done by hand (optax divides by the norm when it is
not below the limit; torch's clip_grad_norm_ adds 1e-6 and clamps), AdamW
takes optax's constants (weight decay 1e-4 on every parameter), and the
learning rate of update t is cosine(t) from t = 0.
"""

from __future__ import annotations

import dataclasses

import torch

from ..parallel.mesh import all_reduce_autograd, average_gradients
from ..psfnet.train import ADAMW, cosine_annealing
from ..utils import trace
from .basenet import compute_loss, linear_depth

MAX_GRAD_NORM = 1.0


@dataclasses.dataclass
class DfDPTrainState:
    net: torch.nn.Module
    opt: torch.optim.Optimizer
    sched: torch.optim.lr_scheduler.LRScheduler
    step: int = 0


def create_dfdp_state(net: torch.nn.Module, lr: float,
                      total_steps: int) -> DfDPTrainState:
    """AdamW + cosine(T_max = total_steps) on ``net``, put in train mode.
    The scheduler steps after each update, so update t uses cosine(t)."""
    opt = torch.optim.AdamW(net.parameters(), lr=lr, **ADAMW)
    sched_fn = cosine_annealing(lr, max(total_steps, 1))
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda t: sched_fn(t) / lr)
    return DfDPTrainState(net=net.train(), opt=opt, sched=sched)


@torch.no_grad()
def clip_by_global_norm_(grads, max_norm: float = MAX_GRAD_NORM):
    """optax.clip_by_global_norm in place: g -> g / norm * max_norm when the
    global norm is not below max_norm. Returns the norm (not synchronised)."""
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in grads]))
    denom = torch.where(norm < max_norm, torch.ones_like(norm), norm / max_norm)
    torch._foreach_div_(grads, denom)
    return norm


def dfdp_grads(net, stack_rgb, gt_depth, gt_aif=None, data_group=None):
    """Forward in train mode (one BN statistics update) and backward of the
    net's loss: the masked SmoothL1 log-depth loss, and in deblur mode its
    three-term loss against the all-in-focus ``gt_aif`` [B, 3, H, W].
    Returns the loss dict (detached); the gradients are left in the
    parameters' ``.grad``.

    data_group: the batch is this rank's slice; the loss's sums are
    all_reduced over the group with autograd, so every rank computes the
    loss of the whole batch. Each all_reduce's backward sums the group's
    identical seeds, so a rank's gradient is the group size times its
    share, and the group's mean of the gradients (dfdp_train_step) is the
    whole batch's gradient."""
    gt_log, mask = linear_depth(gt_depth)
    for p in net.parameters():
        p.grad = None
    total = None
    if data_group is not None:
        total = lambda t: all_reduce_autograd(t, data_group)  # noqa: E731
    losses = compute_loss(net(stack_rgb), gt_log, mask, gt_aif,
                          net.train_mode, total=total)
    losses["total"].backward()
    return {k: v.detach() for k, v in losses.items()}


def dfdp_train_step(state: DfDPTrainState, stack_rgb, gt_depth,
                    gt_aif=None, data_group=None) -> dict:
    """One optimisation step on a rendered DP batch.

    stack_rgb: [B, 6V, H, W]; gt_depth: [B, 1, H, W] metres; gt_aif:
    [B, 3, H, W], the all-in-focus image (deblur mode only). Returns the
    loss dict of 0-d tensors (not synchronised). data_group: the data
    ranks of a data-parallel step (parallel/steps.py), whose gradients are
    averaged before the clip."""
    dev = stack_rgb.device
    with trace.span("train_step", dev):
        with trace.span("train_step.grads", dev):
            losses = dfdp_grads(state.net, stack_rgb, gt_depth, gt_aif,
                                data_group)
        average_gradients(state.net.parameters(), data_group)
        with trace.span("train_step.update", dev):
            clip_by_global_norm_([p.grad for p in state.net.parameters()])
            state.opt.step()
            state.sched.step()
        state.step += 1
    return losses


@torch.no_grad()
def dfdp_infer(net, stack_rgb):
    """Depth in metres: exp of the net's log depth (BatchNorm on its running
    statistics, whatever mode the net is in). stack_rgb: [B, 6V, H, W].
    In deblur mode returns (depth, refined depth in metres, all-in-focus
    image [B, 3, H, W])."""
    was_training = net.training
    net.eval()
    try:
        out = net(stack_rgb)
        depth = torch.exp(out["pred_depth_est"].float())
        if net.train_mode == "deblur":
            return (depth, torch.exp(out["pred_depth_fix"].float()),
                    out["pred_aif"])
        return depth
    finally:
        net.train(was_training)
