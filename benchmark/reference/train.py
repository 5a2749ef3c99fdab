"""Plain reference of the DfDP training step on given DP stacks: DDDNet
forward and backward, global-norm clip, AdamW with a cosine learning rate.

Per step t (from 0): the loss of the depth net on the stack against the
uploaded (float16) depth; the gradients scaled by 1 / norm when their
global norm is 1 or more; AdamW (betas 0.9 / 0.999, eps 1e-8, weight decay
1e-4 on every parameter) at lr_t = lr (1 + cos(pi t / T)) / 2.

The stacks are the program's own renders of the steps: the bf16 render's
rounding, summed in another order by the reference, moves a step's loss by
up to 2e-4 of itself, as much as TF32 in the depth net does, so the step is
followed from the program's render, and that render is compared with the
reference render by itself.
"""

from __future__ import annotations

import math

import torch

from . import dddnet, render

ADAMW = {"betas": (0.9, 0.999), "eps": 1e-8, "weight_decay": 1e-4}


def run_steps(tree, batches, lr, total_steps, device="cuda", tf32=False):
    """Train the net from ``tree`` on ``batches`` [(stack [B, 6, H, W] on
    the device, host depth [B, 1, H, W] in metres)]. Returns {"losses":
    [float], "grad1": {leaf: first clipped gradient}, "delta": {leaf:
    parameter change after the steps}} on the host."""
    net = dddnet.build(tree, device)
    start = {k: p.detach().clone() for k, p in net.named_parameters()}
    opt = torch.optim.AdamW(net.parameters(), lr=lr, **ADAMW)
    losses, grad1 = [], None
    for t, (stack, depth) in enumerate(batches):
        d = torch.from_numpy(depth.astype("float16")).to(device).float()
        with render.matmul_precision(tf32):
            opt.zero_grad(set_to_none=True)
            loss = dddnet.loss(net(stack.float()), d)
            loss.backward()
        grads = [p.grad for p in net.parameters()]
        with torch.no_grad():
            norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).float()
            if norm >= 1.0:
                for g in grads:
                    g.div_(norm)
        if t == 0:
            grad1 = {k: p.grad.detach().cpu().clone() for k, p in net.named_parameters()}
        for group in opt.param_groups:
            group["lr"] = lr * (1 + math.cos(math.pi * t / total_steps)) / 2
        opt.step()
        losses.append(loss.item())
    delta = {k: (p.detach() - start[k]).cpu() for k, p in net.named_parameters()}
    return {"losses": losses, "grad1": grad1, "delta": delta}
