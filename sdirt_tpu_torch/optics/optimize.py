"""Differentiable lens design (counterpart of sdirt_tpu/optics/optimize.py):
learning-rate scales per surface parameter, perturbation, shape correction,
and Adam with per-element learning rates.

The JAX package drives the surface parameters {c, k, d, ai} with
``optax.chain(scale_by_adam(), per-leaf scale, scale(-lr))``; torch's Adam
takes one rate per group, so ``LensAdam`` writes the bias-corrected moments
by hand with optax's constants (b1 0.9, b2 0.999, eps 1e-8, eps_root 0).
"""

from __future__ import annotations

import numpy as np
import torch

from .surfaces import KIND_STOP, SurfaceStack, sag_r2

PARAM_KEYS = ("c", "k", "d", "ai")


def surface_param_labels(stack: SurfaceStack, aper_idx=None,
                         lr=(1e-4, 1e-4, 1e-1, 1e-4), ai_decay: float = 0.1) -> dict:
    """Per-element learning-rate scales {c, k, d, ai} (f32, on the stack's
    device): separate rates for c, d, k; the asphere terms a4... decay by
    ``ai_decay`` per order, a2 frozen; zero curvature for stops and the
    aperture surface, zero where k or an asphere term is zero."""
    s = stack.num_surfaces
    lr_c, lr_d, lr_k, lr_ai = lr
    k_np = stack.k.detach().cpu().numpy()
    ai_np = stack.ai.detach().cpu().numpy()
    c_scale = np.full(s, lr_c, np.float32)
    d_scale = np.full(s, lr_d, np.float32)
    k_scale = np.where(k_np != 0, lr_k, 0.0).astype(np.float32)
    c_scale[stack.kind.cpu().numpy() == KIND_STOP] = 0.0
    if aper_idx is not None:
        c_scale[aper_idx] = 0.0
    ai_scale = np.zeros_like(ai_np)
    for j in range(1, ai_scale.shape[1]):
        ai_scale[:, j] = lr_ai * ai_decay ** (j - 1)
    ai_scale[ai_np == 0.0] = 0.0
    dev = stack.c.device
    return {k: torch.from_numpy(v).to(dev) for k, v in
            (("c", c_scale), ("k", k_scale), ("d", d_scale), ("ai", ai_scale))}


def optimizable_params(stack: SurfaceStack) -> dict:
    """{c, k, d, ai}: detached copies that require gradients."""
    return {k: getattr(stack, k).detach().clone().requires_grad_(True)
            for k in PARAM_KEYS}


def apply_params(stack: SurfaceStack, params: dict) -> SurfaceStack:
    return stack.replace(**params)


class LensAdam(torch.optim.Optimizer):
    """Adam with a per-element learning-rate scale: for each parameter p
    with scale s, the optax chain scale_by_adam -> times s -> times
    -base_lr:

        mu = (1 - b1) g + b1 mu,    nu = (1 - b2) g^2 + b2 nu,
        p -= base_lr * s * (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t) + eps_root) + eps)
    """

    def __init__(self, params: dict, scales: dict, base_lr: float = 1.0,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 eps_root: float = 0.0):
        groups = [{"params": [params[k]], "scale": scales[k]} for k in params]
        super().__init__(groups, dict(base_lr=base_lr, b1=b1, b2=b2, eps=eps,
                                      eps_root=eps_root))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["b1"], group["b2"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["count"] = 0
                    st["mu"] = torch.zeros_like(p)
                    st["nu"] = torch.zeros_like(p)
                g = p.grad
                st["count"] += 1
                st["mu"] = (1 - b1) * g + b1 * st["mu"]
                st["nu"] = (1 - b2) * (g * g) + b2 * st["nu"]
                t = st["count"]
                mu_hat = st["mu"] / torch.tensor(1 - b1 ** t, dtype=p.dtype, device=p.device)
                nu_hat = st["nu"] / torch.tensor(1 - b2 ** t, dtype=p.dtype, device=p.device)
                update = mu_hat / (torch.sqrt(nu_hat + group["eps_root"]) + group["eps"])
                p.add_(-group["base_lr"] * (update * group["scale"]))
        return loss


def make_lens_optimizer(params: dict, scales: dict, base_lr: float = 1.0) -> LensAdam:
    """Adam with per-leaf learning-rate scaling over {c, k, d, ai}."""
    return LensAdam(params, scales, base_lr=base_lr)


def perturbation_shapes(stack: SurfaceStack) -> tuple:
    """The shapes of perturb_stack's five normal draws (c, k, ai, d, r)."""
    s = stack.num_surfaces
    return ((s,), (s,), tuple(stack.ai.shape), (s,), (s,))


def perturb_stack(stack: SurfaceStack, generator=None, ratio=0.001,
                  thickness_precision=0.0005, diameter_precision=0.001,
                  draws=None) -> SurfaceStack:
    """Manufacturing error: multiplicative jitter on the nonzero c, k and
    asphere terms, additive on the nonzero vertex positions d and on the
    radii. draws: five standard-normal arrays of perturbation_shapes
    (drawn from ``generator`` in that order when None)."""
    if draws is None:
        draws = [torch.randn(sh, generator=generator, device=generator.device)
                 for sh in perturbation_shapes(stack)]
    n1, n2, n3, n4, n5 = (x.to(stack.c) if torch.is_tensor(x) else
                          torch.tensor(x, dtype=stack.c.dtype, device=stack.c.device)
                          for x in draws)
    c = torch.where(stack.c != 0, stack.c * (1 + n1 * ratio), stack.c)
    k = torch.where(stack.k != 0, stack.k * (1 + n2 * ratio), stack.k)
    ai = torch.where(stack.ai != 0, stack.ai * (1 + n3 * ratio), stack.ai)
    d = torch.where(stack.d != 0, stack.d + n4 * thickness_precision, stack.d)
    r = stack.r + n5 * diameter_precision
    return stack.replace(c=c, k=k, ai=ai, d=d, r=r)


def correct_shape(lens) -> bool:
    """Repair degenerate geometry during lens optimisation: the first
    surface back to z = 0 (the sensor moved with it), a fixed gap behind a
    front aperture, overlapping surfaces pushed 0.2 mm apart, then
    prune_surf. Returns whether any surfaces overlapped."""
    stack = lens.stack
    d_np = stack.d.detach().cpu().numpy().copy()
    changed = False
    move = d_np[0]
    d_np -= move
    lens.d_sensor -= move
    if lens.aper_idx == 0:
        d_aper = 0.1
        aper_r = float(stack.r[0])
        sag1 = -float(sag_r2(torch.tensor(aper_r ** 2, dtype=torch.float32,
                                          device=stack.c.device),
                             stack.c[1], stack.k[1], stack.ai[1]))
        if sag1 > 0:
            d_aper += sag1
        delta = d_np[1] - d_aper
        for i in lens.find_diff_surf():
            d_np[i] -= delta
    diff = lens.find_diff_surf()
    for a, b in zip(diff[:-1], diff[1:]):
        if d_np[a] > d_np[b]:
            d_np[b] += 0.2
            changed = True
    lens.stack = stack.replace(d=torch.from_numpy(d_np.astype(np.float32)).to(stack.c.device))
    lens._pupil_cache = {}
    lens.prune_surf()
    return changed
