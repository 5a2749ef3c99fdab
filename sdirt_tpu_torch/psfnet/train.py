"""PSF-surrogate fitting against ray-traced supervision (PyTorch counterpart
of sdirt_tpu/psfnet/train.py).

Every step draws field points around a focus setting, traces their DP PSFs
as ground truth and takes one AdamW step of the net on the squared error.
The traced PSF carries no gradient; only the net is differentiated. The
trace is chosen by ``SDIRT_TRACE``: ``fused`` (the default: K1 through
``dp_psf_fused``, its plain version on the CPU), ``scan`` (the
per-surface trace of ``dp_psf``) or ``specialized`` (``dp_psf`` with the
lens's static description). A name the port does not know raises.

The fit trains ``lens.net`` in place (the JAX code copies the parameters
into a train state and writes them back at every checkpoint and at the end;
here they are the same tensors).
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch

from ..dp.fused_trace import make_fused_plan
from ..dp.psf import compute_psf_rgb, dp_psf, dp_psf_fused, lens_scalars
from ..optics.sampling import point_source_grid
from ..utils.checkpoint import TrainCheckpointer
from .arch import resize_linear

TRACE_MODES = ("fused", "scan", "specialized")

# optax.adamw's defaults, set explicitly (torch's weight decay is 1e-2)
ADAMW = {"betas": (0.9, 0.999), "eps": 1e-8, "weight_decay": 1e-4}


def cosine_annealing(base_lr: float, t_max: int, eta_min: float = 0.0):
    """torch.optim.lr_scheduler.CosineAnnealingLR's closed form, periodic
    past t_max (the fit sets t_max = iters // 3: 1.5 periods)."""

    def schedule(step):
        return eta_min + (base_lr - eta_min) * (1 + math.cos(math.pi * step / t_max)) / 2

    return schedule


@dataclasses.dataclass
class PSFNetTrainState:
    net: torch.nn.Module
    opt: torch.optim.Optimizer
    sched: torch.optim.lr_scheduler.LRScheduler
    step: int = 0


def create_train_state(net: torch.nn.Module, lr: float = 1e-4,
                       iters: int = 10000) -> PSFNetTrainState:
    """AdamW with the closed-form cosine (t_max = iters // 3): the learning
    rate of update t is schedule(t) from t = 0 (the scheduler steps after
    each update). The moments start at zero, as optax.adamw's do."""
    opt = torch.optim.AdamW(net.parameters(), lr=lr, **ADAMW)
    sched_fn = cosine_annealing(lr, max(iters // 3, 1))
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda t: sched_fn(t) / lr)
    return PSFNetTrainState(net=net.train(), opt=opt, sched=sched)


def draw_training_samples(generator, bs: int, n_foc: int):
    """The random numbers of one batch of training points: the focus index,
    (x, y) uniforms and the depth normal, [bs] each."""
    dev = generator.device
    idx = int(torch.randint(0, n_foc, (), generator=generator, device=dev))
    ux = torch.rand(bs, generator=generator, device=dev)
    uy = torch.rand(bs, generator=generator, device=dev)
    g = torch.randn(bs, generator=generator, device=dev)
    return idx, ux, uy, g


def training_points(idx: int, ux, uy, g, foc_z_arr, d_min: float, d_max: float):
    """(x, y) uniform on [-1, 1], z piecewise-Gaussian around the focus
    setting foc_z_arr[idx]. Returns (inp [bs, 3] with normalised z,
    points [bs, 3] with depth in mm)."""
    foc_z = torch.tensor(np.asarray(foc_z_arr, np.float32)[idx], device=ux.device)
    x = (ux - 0.5) * 2
    y = (uy - 0.5) * 2
    g = torch.clamp(g, -3.0, 3.0)
    z = torch.where(g > 0, (1 - foc_z) * g / 3 + foc_z, foc_z * g / 3 + foc_z)
    inp = torch.stack([x, y, z], -1)
    depth = z * (d_max - d_min) + d_min
    return inp, torch.stack([x, y, depth], -1)


def fit_step(state: PSFNetTrainState, inp, psf_gt):
    """One AdamW step of the MLP on mean((pred - psf_gt)^2); returns the
    loss (a 0-d tensor, not synchronised)."""
    bs, ks = psf_gt.shape[0], psf_gt.shape[-1]
    state.opt.zero_grad(set_to_none=True)
    loss = torch.mean((state.net(inp).reshape(bs, ks, ks) - psf_gt) ** 2)
    loss.backward()
    state.opt.step()
    state.sched.step()
    state.step += 1
    return loss.detach()


def trace_mode() -> str:
    """The supervision's trace: ``SDIRT_TRACE``, ``fused`` when unset."""
    mode = os.environ.get("SDIRT_TRACE", "fused")
    if mode not in TRACE_MODES:
        raise ValueError(f"SDIRT_TRACE={mode!r}: one of {TRACE_MODES}")
    return mode


def make_psf_fn(lens):
    """psf_fn(points, generator, spp, ks, chunk) -> the left DP PSFs
    [N, ks, ks] (max-normalised) of the lens's points through the trace
    that trace_mode() names."""
    mode = trace_mode()
    scalars = lens_scalars(lens)
    if mode == "fused":
        plan = make_fused_plan(lens)
        return lambda pts, gen, spp, ks, chunk: dp_psf_fused(
            pts, gen, scalars, plan, spp=spp, ks=ks, chunk=chunk)[0]
    eta, skip = lens.eta_arrays(0.589, True)
    desc = lens.static_desc() if mode == "specialized" else None
    return lambda pts, gen, spp, ks, chunk: dp_psf(
        lens.stack, eta, skip, pts, gen, scalars, spp=spp, ks=ks, chunk=chunk,
        static_desc=desc)[0]


def make_train_step(lens, *, bs: int, spp: int, ks: int):
    """The sample + trace + fit step of a PSFNetLens: step(state, generator)
    -> loss. The ground truth is the left view of make_psf_fn's trace."""
    psf_fn = make_psf_fn(lens)
    foc_z_arr, d_min, d_max = lens.foc_z_arr, lens.d_min, lens.d_max

    def train_step(state: PSFNetTrainState, generator):
        samples = draw_training_samples(generator, bs, len(foc_z_arr))
        inp, points = training_points(*samples, foc_z_arr, d_min, d_max)
        inp, points = inp.to(lens.device), points.to(lens.device)
        with torch.no_grad():
            psf_gt = psf_fn(points, generator, spp, ks, 2048)
        return fit_step(state, inp, psf_gt)

    return train_step


def eval_points(lens, bs: int):
    """The held-out points: a sqrt(bs) x sqrt(bs) xy grid, z along the
    +-3 sigma band of the middle focus setting. Returns (inp, points)
    [bs, 3] numpy, normalised z and depth in mm."""
    foc_z = float(lens.foc_z_arr[1])
    psf_grid = int(round(bs ** 0.5))
    if psf_grid * psf_grid != bs:
        raise ValueError(f"eval bs must be a perfect square, got {bs}")
    hb = 1 / (2 * psf_grid)
    x, y = np.meshgrid(np.linspace(-1 + hb, 1 - hb, psf_grid),
                       np.linspace(1 - hb, -1 + hb, psf_grid), indexing="xy")
    x, y = x.reshape(-1).astype(np.float32), y.reshape(-1).astype(np.float32)
    g = np.linspace(-3, 3, bs).astype(np.float32)
    z = np.where(g > 0, (1 - foc_z) * g / 3 + foc_z, foc_z * g / 3 + foc_z)
    z[g == 0] = 0.0
    depth = z * (lens.d_max - lens.d_min) + lens.d_min
    return (np.stack([x, y, z], -1).astype(np.float32),
            np.stack([x, y, depth], -1).astype(np.float32))


def eval_loss(pred, psf_gt):
    """Held-out (L1, L2) of sum-normalised PSFs."""
    gt_n = psf_gt / (psf_gt.sum((-1, -2), keepdim=True) + 1e-9)
    pd_n = pred / (pred.sum((-1, -2), keepdim=True) + 1e-9)
    return torch.mean(torch.abs(pd_n - gt_n)), torch.mean((pd_n - gt_n) ** 2)


def make_eval_fn(lens, *, bs: int = 1024, spp: int = 65536, ks: int = 21):
    """Held-out L1 / L2: eval_fn(net, generator) -> (l1, l2) 0-d tensors.
    The points go through make_psf_fn's trace in chunks of 128 (ray chunk
    8192 in the splat), one generator draw after another."""
    psf_fn = make_psf_fn(lens)
    inp, points = (torch.from_numpy(a).to(lens.device) for a in eval_points(lens, bs))
    cbs = bs if bs <= 128 or bs % 128 else 128

    @torch.no_grad()
    def eval_fn(net, generator):
        psf_gt = torch.cat([psf_fn(points[i:i + cbs], generator, spp, ks, 8192)
                            for i in range(0, bs, cbs)])
        return eval_loss(net(inp).reshape(bs, ks, ks), psf_gt)

    return eval_fn


def fit_psfnet(lens, iters: int = 10000, bs: int = 128, lr: float = 1e-4,
               spp: int = 2048, evaluate_every: int = 1000,
               result_dir: str | None = None, seed: int = 0, log_fn=print,
               resume: bool = False, eval_bs: int = 1024, eval_spp: int = 65536,
               keep_states: int = 3) -> dict:
    """The train loop: iters + 1 steps, an evaluation and a checkpoint after
    every step i with (i + 1) % evaluate_every == 0, the net written to
    ``result_dir/psfnet_<model>.npz`` at the end. resume=True restores the
    full train state from the newest checkpoint under result_dir/state.

    Returns {"losses": [per step], "evals": [(i, l1, l2)], "start": step}.
    """
    state = create_train_state(lens.net, lr, iters)
    step_fn = make_train_step(lens, bs=bs, spp=spp, ks=lens.kernel_size)
    eval_fn = make_eval_fn(lens, ks=lens.kernel_size, bs=eval_bs, spp=eval_spp)

    ckpt = None
    start = 0
    if result_dir is not None:
        ckpt = TrainCheckpointer(f"{result_dir}/state", max_to_keep=keep_states)
        if resume:
            restored = ckpt.restore_latest(state)
            if restored is not None:
                start = restored
                log_fn(f"resumed from step {start}")

    generator = torch.Generator(device=lens.device).manual_seed(seed * 1000003 + start)
    losses, evals = [], []
    for i in range(start, iters + 1):
        losses.append(step_fn(state, generator))
        if (i + 1) % evaluate_every == 0:
            l1, l2 = (float(v) for v in eval_fn(state.net, generator))
            log_fn(f"{i}, {l1}, {l2}")
            evals.append((i, l1, l2))
            if ckpt is not None:
                ckpt.save(i + 1, state)
    lens.net.eval()
    if result_dir is not None:
        lens.save_net(f"{result_dir}/psfnet_{lens.model_name}.npz")
    return {"losses": [float(v) for v in losses], "evals": evals, "start": start}



@torch.no_grad()
def get_training_psf_map(lens, generator=None, bs: int = 8, psf_grid=(11, 11),
                         psf_map_size=(128, 128), spp: int = 2048, draws=None):
    """PSF-map training batches (for map-predicting nets): depths drawn
    around a random focus setting, a grid of RGB PSFs traced per depth,
    tiled into a map and resized (jax.image.resize's antialiased linear).

    draws: (focus index, the depth normals [bs]), drawn from ``generator``
    when None. Returns (inp [bs, 2] = (z, foc_z), maps [bs, 3, H, W]).
    """
    if draws is None:
        dev = generator.device
        draws = (int(torch.randint(0, len(lens.foc_z_arr), (), generator=generator,
                                   device=dev)),
                 torch.randn(bs, generator=generator, device=dev))
    idx, g = draws
    foc_z = float(np.asarray(lens.foc_z_arr)[idx])
    g = torch.clamp(torch.as_tensor(g, dtype=torch.float32), -3, 3)
    z = torch.where(g > 0, (1 - foc_z) * g / 3 + foc_z, foc_z * g / 3 + foc_z)
    depth = z * (lens.d_max - lens.d_min) + lens.d_min
    inp = torch.stack([z, torch.full_like(z, foc_z)], -1)
    gh, gw = psf_grid
    ks = lens.kernel_size
    maps = []
    for i in range(bs):
        pts = point_source_grid(depth=float(depth[i]), grid=max(gh, gw),
                                center=True)[:gh, :gw].reshape(-1, 3)
        psfs = compute_psf_rgb(lens, pts, generator, spp=spp, ks=ks)
        m = psfs.reshape(gh, gw, 3, ks, ks).permute(2, 0, 3, 1, 4)
        m = m.reshape(1, 3, gh * ks, gw * ks)
        maps.append(resize_linear(m, psf_map_size)[0])
    return inp, torch.stack(maps)
