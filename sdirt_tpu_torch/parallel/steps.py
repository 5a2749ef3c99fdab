"""Multi-GPU training steps: the ray- and point-split PSF-surrogate fit step
and the data-parallel DfDP step (PyTorch counterpart of
sdirt_tpu/parallel/steps.py).

  * PSF fit: every rank draws the whole batch's samples from the same
    generator; the field points split over 'data', the main bundle's
    Monte-Carlo rays over 'rays' (each rank traces its share through K1),
    and the raw splat grids are summed over 'rays' before the
    max-normalisation (dp/psf.py:dp_psf_fused). Gradients are averaged over
    'data'; the parameters stay replicated.
  * DfDP: each rank takes its slice of the batch (and of the all-in-focus
    target in deblur mode). The loss's sums and BatchNorm's batch moments
    are all_reduced over 'data' with autograd (dfdp/basenet.py,
    dfdp/models/layers.py), as XLA reduces them in the JAX step, so the
    step equals the one-rank step on the whole batch; gradients are
    averaged over 'data'.
"""

from __future__ import annotations

import torch

from ..dfdp.models.layers import sync_batchnorm
from ..dfdp.train import dfdp_train_step
from ..dp.fused_trace import make_fused_plan
from ..dp.psf import dp_psf_fused, lens_scalars
from ..psfnet.train import (PSFNetTrainState, draw_training_samples, fit_step,
                            trace_mode, training_points)
from .mesh import Mesh, broadcast_module


def make_sharded_psfnet_step(lens, mesh: Mesh, *, bs: int, spp: int, ks: int,
                             chunk: int = 2048):
    """The fit step of psfnet/train.make_train_step over a (data, rays)
    mesh: step(state, generator) -> the loss of the whole batch (0-d
    tensor). bs must divide by n_data and spp by n_rays."""
    if bs % mesh.n_data:
        raise ValueError(f"bs {bs} does not split over {mesh.n_data} data ranks")
    if spp % mesh.n_rays:
        raise ValueError(f"{spp} rays do not split over {mesh.n_rays} rays ranks")
    if trace_mode() != "fused":
        raise ValueError(f"SDIRT_TRACE={trace_mode()}: the sharded step traces "
                         "through K1 (fused) only")
    scalars, plan = lens_scalars(lens), make_fused_plan(lens)
    foc_z_arr, d_min, d_max = lens.foc_z_arr, lens.d_min, lens.d_max
    per = bs // mesh.n_data
    lo = mesh.data_index * per
    broadcast_module(lens.net)

    def step(state: PSFNetTrainState, generator):
        samples = draw_training_samples(generator, bs, len(foc_z_arr))
        inp, points = training_points(*samples, foc_z_arr, d_min, d_max)
        inp = inp.to(lens.device)[lo:lo + per]
        points = points.to(lens.device)[lo:lo + per]
        with torch.no_grad():
            psf_gt = dp_psf_fused(points, generator, scalars, plan, spp=spp,
                                  ks=ks, chunk=chunk, rays_group=mesh.rays_group)[0]
        return fit_step(state, inp, psf_gt, data_group=mesh.data_group)

    return step


def make_sharded_dfdp_step(mesh: Mesh, train_mode: str = "dfdp"):
    """Data-parallel DfDP step: step(state, stack_rgb, gt_depth, gt_aif=None)
    on this rank's slices (parallel.mesh.shard_batch) -> the loss dict of
    the whole batch. In 'deblur' mode gt_aif is the rank's slice of the
    all-in-focus target."""

    def step(state, stack_rgb, gt_depth, gt_aif=None):
        if state.net.train_mode != train_mode:
            raise ValueError(f"a {state.net.train_mode} net in a {train_mode} step")
        sync_batchnorm(state.net, mesh.data_group)
        return dfdp_train_step(state, stack_rgb, gt_depth, gt_aif,
                               data_group=mesh.data_group)

    return step
