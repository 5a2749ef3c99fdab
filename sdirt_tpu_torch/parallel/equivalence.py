"""What one rank of a sharded step computes, for holding a multi-process run
against the one-rank step on the same samples (tests/test_torch_parallel.py,
chip_smoke.py).

Each function has ``launch``'s signature ``fn(rank, world, device, spec)``
and returns plain numbers and numpy arrays. Called directly with world 1
(no process group), it is the one-rank step itself. ``spec`` is a dict:

  * psf_rank: dp_psf_fused over a (1, world) mesh: "lens", "ks", "spp",
    "points" [N, 3], "pupil_main" [spp, 2], "pupil_chief" [spp_chief, 2];
  * fit_rank: ``steps`` steps of make_sharded_psfnet_step over an
    ("n_data", world / n_data) mesh with SGD ("lr"), from a "seed"-ed net
    "model" and generator: "lens", "ks", "bs", "spp";
  * dfdp_rank: ``steps`` data-parallel DfDP steps over a (world, 1) mesh
    from the "weights" net (seeded when None), in "dtype", "train_mode",
    "lr", "total_steps" (SGD at "lr" when "sgd"), on "stacks" [S, B, 6, H, W] (and "aifs" in
    deblur mode), or rendering each rank's slice of "aif" [S, B, 3, H, W]
    and "depth" [S, B, 1, H, W] through the "config"'s training lens (in
    "render_in" pieces, 1 by default), without cuDNN when "cudnn_off";
  * sequence: runs [(name of one of the above, spec), ...] in turn, one
    launch for several checks.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..utils.weights import torch_to_flax
from .mesh import Mesh, make_mesh, shard_batch


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def psf_rank(rank, world, dev, spec):
    from ..dp import fused_trace
    from ..dp.psf import dp_psf_fused, lens_scalars
    from ..optics.lens import Lens

    mesh = make_mesh(1, world)
    lens = Lens(spec["lens"], sensor_res=(512, 768), device=dev)
    before = fused_trace.launches
    with torch.no_grad():
        psf_l, psf_r = dp_psf_fused(
            torch.as_tensor(spec["points"], device=dev), None, lens_scalars(lens),
            fused_trace.make_fused_plan(lens), spp=spec["spp"], ks=spec["ks"],
            spp_chief=len(spec["pupil_chief"]),
            pupil_main=torch.as_tensor(spec["pupil_main"], device=dev),
            pupil_chief=torch.as_tensor(spec["pupil_chief"], device=dev),
            rays_group=mesh.rays_group)
    return {"psf_l": psf_l.cpu().numpy(), "psf_r": psf_r.cpu().numpy(),
            "k1_launches": fused_trace.launches - before}


def fit_rank(rank, world, dev, spec):
    from ..dp import fused_trace
    from ..psfnet.surrogate import PSFNetLens
    from ..psfnet.train import PSFNetTrainState
    from .steps import make_sharded_psfnet_step

    n_data = spec.get("n_data", 1)
    mesh = make_mesh(n_data, world // n_data)
    lens = PSFNetLens(spec["lens"], model_name=spec.get("model", "mlp"),
                      kernel_size=spec["ks"], sensor_res=(512, 768),
                      seed=spec.get("seed", 0), device=dev)
    net = lens.net.train()
    opt = torch.optim.SGD(net.parameters(), lr=spec["lr"])
    state = PSFNetTrainState(net=net, opt=opt,
                             sched=torch.optim.lr_scheduler.LambdaLR(opt, lambda t: 1.0))
    step = make_sharded_psfnet_step(lens, mesh, bs=spec["bs"], spp=spec["spp"],
                                    ks=spec["ks"])
    gen = torch.Generator(device=dev).manual_seed(spec.get("seed", 0))
    before = fused_trace.launches
    losses, ms = [], []
    for _ in range(spec.get("steps", 1)):
        _sync(dev)
        t0 = time.perf_counter()
        losses.append(float(step(state, gen)))
        ms.append(1e3 * (time.perf_counter() - t0))
    params = torch.cat([p.detach().reshape(-1) for p in net.parameters()])
    return {"losses": losses, "params": params.cpu().numpy(), "step_ms": ms,
            "k1_launches": fused_trace.launches - before}


def dfdp_rank(rank, world, dev, spec):
    from ..dfdp.basenet import build_basenet
    from ..dfdp.train import create_dfdp_state
    from ..render import fused_conv
    from .steps import make_sharded_dfdp_step

    mesh = make_mesh(world, 1)
    if spec.get("cudnn_off"):
        # cuDNN picks its convolution algorithms by batch size, ~1e-4 of a
        # loss apart in f32; PyTorch's own convolutions run sample by sample
        torch.backends.cudnn.enabled = False
    mode = spec.get("train_mode", "dfdp")
    dtype = getattr(torch, spec.get("dtype", "float32"))
    net = build_basenet(spec.get("weights"), seed=spec.get("seed", 0), device=dev,
                        train=True, train_mode=mode).to(dtype)
    state = create_dfdp_state(net, spec["lr"], spec["total_steps"])
    if spec.get("sgd"):
        # linear in the gradient: an Adam step turns rounding-level gradient
        # differences into whole-step sign flips
        state.opt = torch.optim.SGD(net.parameters(), lr=spec["lr"])
        state.sched = torch.optim.lr_scheduler.LambdaLR(state.opt, lambda t: 1.0)
    step = make_sharded_dfdp_step(mesh, mode)
    lens = None
    if "config" in spec:
        from ..dfdp.factory import get_lens
        from ..dfdp_net import _render_batch
        from ..utils.config import load_config

        lens = get_lens(load_config(spec["config"]), device=dev)[0]
    before = fused_conv.launches
    losses, ms = [], []
    for s in range(spec["steps"]):
        if lens is None:
            stack = torch.as_tensor(shard_batch(spec["stacks"][s], mesh), device=dev,
                                    dtype=dtype)
            depth = torch.as_tensor(shard_batch(spec["depths"][s], mesh), device=dev,
                                    dtype=dtype)
            aif = (torch.as_tensor(shard_batch(spec["aifs"][s], mesh), device=dev,
                                   dtype=dtype) if mode == "deblur" else None)
        else:
            n = spec.get("render_in", 1)
            mine = shard_batch([spec["aif"][s], spec["depth"][s]], mesh)
            with torch.no_grad():
                parts = [_render_batch(lens, *shard_batch(mine, Mesh(n, 1, rank=i)))
                         for i in range(n)]
            stack, depth, aif = (torch.cat(t) for t in zip(*parts))
            aif = aif if mode == "deblur" else None
        _sync(dev)
        t0 = time.perf_counter()
        out = step(state, stack, depth, aif)
        losses.append({k: float(v) for k, v in out.items()})
        ms.append(1e3 * (time.perf_counter() - t0))
    stats = {k: v for k, v in torch_to_flax(net.state_dict()).items()
             if k.startswith("batch_stats/")}
    params = torch.cat([p.detach().reshape(-1).double() for p in net.parameters()])
    return {"losses": losses, "batch_stats": stats,
            "params": params.cpu().numpy(), "step_ms": ms,
            "k2_launches": fused_conv.launches - before}


def sequence(rank, world, dev, jobs):
    """The results of several of the functions above, run in turn."""
    return [globals()[name](rank, world, dev, spec) for name, spec in jobs]
