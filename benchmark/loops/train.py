"""Closed-loop DfDP training, as ``dfdp_net.train`` runs an epoch: per step
``next()`` on the program's ``DataLoader`` over ``SyntheticRGBD`` (worker
threads, shuffled from the seed), the noisy training render, then
``dfdp_train_step`` (DDDNet forward and backward, clip, AdamW, cosine);
the losses are read back every ``readback_every`` steps. No validation,
evaluation or checkpoint.

Set-up builds the one training state (the depth net warm-started from the
configuration's checkpoint) and drives it through ``check_steps`` steps of
the window's own call. The check compares those steps' renders with the
reference render, and follows the steps with the reference's depth net on
the program's renders (reference/train.py says why): each step's loss, the
first clipped gradient and the parameters' change, leaf by leaf. The window
then goes on with the same state and loader.

Records per step outside the profiled ones: the host's wait for the batch
(``data_wait_ms``), the render and the train step (CUDA events,
``render_ms``, ``dddnet_ms``); the window's host seconds and steps.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from .. import devtrace
from ..counts import dddnet as dddnet_counts, peaks, render as render_counts
from ..reference import train as ref_train, weights as ref_weights
from . import common

BETA1 = 0.9


def total_steps(cfg) -> int:
    """The cosine's length: the run's optimiser steps (anneal_over_steps)."""
    return cfg["epochs"] * (cfg["data"]["synthetic_len"] // cfg["bs"])


def setup(ctx):
    from sdirt_tpu_torch.dfdp.basenet import build_basenet
    from sdirt_tpu_torch.dfdp.train import create_dfdp_state
    from sdirt_tpu_torch.utils.weights import load_state

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    common.full_precision()
    common.select_variant(cfg, ctx.variant)
    common.phase(ctx, "imports")
    lens = common.build_lens(cfg, dev)
    common.phase(ctx, "lens")
    net = build_basenet(seed=0, device=dev, train=True)
    state = create_dfdp_state(net, cfg["lr"], total_steps(cfg))
    load_state(state.net, common.path(cfg["depth_net"]["weights"]))
    common.phase(ctx, "depth net")
    ds = common.scenes(cfg, tr["dataset_len"], ctx.seed)
    loader = common.loader(ds, cfg["bs"], tr["loader_workers"], ctx.seed, shuffle=True)
    st = {"lens": lens, "state": state, "batches": iter(loader),
          "gen": torch.Generator(device=dev).manual_seed(ctx.seed),
          "pending": [], "losses": [], "inputs": [], "stacks": []}
    start = {k: p.detach().clone() for k, p in state.net.named_parameters()}
    for i in range(tr["check_steps"]):
        step(st, ctx, record=True)
        if i == 0:
            # AdamW's first moment after one step is (1 - beta1) g; a
            # parameter the step never reached has none: a zero gradient
            moments = state.opt.state
            st["grad1"] = {k: (moments[p]["exp_avg"] / (1 - BETA1) if "exp_avg"
                               in moments.get(p, {}) else torch.zeros_like(p)).cpu()
                           for k, p in state.net.named_parameters()}
    drain(st)
    common.phase(ctx, "first steps")
    st["delta"] = {k: (p.detach() - start[k]).cpu()
                   for k, p in state.net.named_parameters()}
    st["check_losses"] = list(st["losses"])
    return st


def drain(st):
    """Read back the pending losses (a synchronising read, as the trainer's
    every-8-steps drain); a non-finite loss raises."""
    for losses in st["pending"]:
        total = float(losses["total"])
        if not math.isfinite(total):
            raise FloatingPointError(f"non-finite train loss {total}")
        st["losses"].append(total)
    st["pending"].clear()


def step(st, ctx, record=False, timing=None, trace_on=False):
    from sdirt_tpu_torch.dfdp.train import dfdp_train_step

    dev = ctx.device
    with devtrace.span("data_wait", trace_on):
        t = devtrace.mark(torch.device("cpu"))
        aif, depth = next(st["batches"])
        wait_ms = devtrace.elapsed_ms(t, devtrace.mark(torch.device("cpu")))
    if record:
        st["inputs"].append((aif, depth, st["gen"].get_state()))
    m0 = devtrace.mark(dev)
    with devtrace.span("render_batch", trace_on):
        stack, depth_dev, _ = common.render_stack(st["lens"], aif, depth, st["gen"])
    m1 = devtrace.mark(dev)
    if record:
        st["stacks"].append(stack)
    with devtrace.span("train_step", trace_on):
        losses = dfdp_train_step(st["state"], stack, depth_dev)
    m2 = devtrace.mark(dev)
    if timing is not None:
        timing.append((wait_ms, m0, m1, m2))
    st["pending"].append(losses)
    if len(st["pending"]) >= ctx.traffic["readback_every"]:
        with devtrace.span("loss_readback", trace_on):
            drain(st)


def window(st, ctx, seconds, trace_on, until_step=0):
    tr, dev, cfg = ctx.traffic, ctx.device, ctx.config
    prof = devtrace.StepProfiler(dev, trace_on, tr["profile_first"], tr["profile_steps"])
    timing, profiled = [], set(range(tr["profile_first"],
                                     tr["profile_first"] + tr["profile_steps"]))
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < seconds or i < until_step:
        prof.before(i)
        step(st, ctx, timing=timing, trace_on=trace_on and prof.active)
        prof.after(i)
        i += 1
    drain(st)
    devtrace.sync(dev)
    wall = time.perf_counter() - t0
    kept = [t for k, t in enumerate(timing) if not (trace_on and k in profiled)]
    waits = [t[0] for t in timing]
    h, w = cfg["res"]
    bs = cfg["bs"]
    least = (bs * render_counts.render_flops(cfg["psfnet"], h, w) / peaks.BF16_FLOPS
             + dddnet_counts.train_step_flops(bs, h, w) / peaks.F32_FLOPS)
    rec = {"loop": "train", "n_steps": i, "window_s": wall,
           "profile": prof.result, "profiled_wall_s": prof.wall_s,
           "least_step_s": least,
           "data_wait_ms": [t[0] for t in kept],
           "render_ms": [devtrace.elapsed_ms(t[1], t[2]) for t in kept],
           "dddnet_ms": [devtrace.elapsed_ms(t[2], t[3]) for t in kept],
           "window_note": f"data wait {sum(waits) / 1e3:.3f} s in all, "
                          f"longest {max(waits, default=0.0):.1f} ms"}
    return {"train_pairs_per_s": bs * i / wall}, rec


def release(st):
    """Free the program's training state, lens and loader."""
    for k in ("lens", "state", "batches", "pending"):
        st.pop(k, None)


def leaf_gap(got: dict, want: dict, leaves) -> float:
    """The worst leaf's gap of norms, |‖got‖ - ‖want‖|, against the larger
    of the reference leaf's norm and the median leaf's."""
    norms = {k: float(torch.linalg.vector_norm(want[k].double())) for k in leaves}
    floor = float(np.median(list(norms.values())))
    return max(abs(float(torch.linalg.vector_norm(got[k].double())) - norms[k])
               / max(norms[k], floor, 1e-30) for k in leaves)


def compare(st, ref) -> dict:
    """Each step's loss, the first clipped gradient per leaf, and each
    leaf's change over the steps. Leaves whose reference gradient norm is
    under a thousandth of the median leaf's move by round-off alone under
    AdamW: they are left out of the change."""
    losses = st["check_losses"]
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(losses, ref["losses"]))
    g = {k: float(torch.linalg.vector_norm(v.double())) for k, v in ref["grad1"].items()}
    median = float(np.median(list(g.values())))
    moved = [k for k in ref["delta"] if g[k] >= 1e-3 * median]
    return {"loss_gap": loss_gap,
            "grad_gap": leaf_gap(st["grad1"], ref["grad1"], list(ref["grad1"])),
            "update_gap": leaf_gap(st["delta"], ref["delta"], moved)}


def reference_steps(st, ctx, tf32=False):
    """The reference's steps on the program's rendered stacks."""
    cfg = ctx.config
    tree = ref_weights.load_tree(common.path(cfg["depth_net"]["weights"]))
    batches = [(stack, depth) for stack, (_, depth, _) in zip(st["stacks"], st["inputs"])]
    return ref_train.run_steps(tree, batches, cfg["lr"], total_steps(cfg),
                               ctx.device, tf32=tf32)


def render_check(st, ctx) -> dict:
    """The set-up steps' renders against the reference render."""
    want = common.reference_render(ctx.config, st["inputs"], ctx.device)
    gaps = common.render_gaps(st["stacks"], want)
    return {f"render_{k}": v for k, v in gaps.items()}


def check(st, ctx):
    return {**render_check(st, ctx), **compare(st, reference_steps(st, ctx))}
