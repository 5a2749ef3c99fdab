"""Closed-loop training render: one batch after another through the
trainer's noisy render (``dfdp_net._render_batch``: uint8 / f16 upload, the
configuration's render variant, DP noise), over a pool of scenes made from
the seed in set-up and cycled.

Traffic keys: ``scene_pool`` (scenes made in set-up), ``loader_workers``,
``warm_batches`` (renders before the window), ``check_batches`` of the
first ``check_span`` window batches compared with the reference (drawn
from the seed), ``profile_first`` / ``profile_steps`` (the profiled steps
of a traced run).

Records: the gap between consecutive CUDA events recorded after each
batch (``step_ms``), the window's host seconds, batches, and the profile.
"""

from __future__ import annotations

import random
import time

import torch

from .. import devtrace
from ..counts import peaks, render as render_counts
from . import common


def setup(ctx):
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    common.full_precision()
    common.select_variant(cfg, ctx.variant)
    common.phase(ctx, "imports")
    lens = common.build_lens(cfg, dev)
    common.phase(ctx, "lens")
    ds = common.scenes(cfg, tr["scene_pool"], ctx.seed)
    pool = list(common.loader(ds, cfg["bs"], tr["loader_workers"], ctx.seed,
                              shuffle=False))
    common.phase(ctx, "scenes")
    warm = torch.Generator(device=dev).manual_seed(0)
    for i in range(tr["warm_batches"]):
        common.render_stack(lens, *pool[i % len(pool)], warm)
    devtrace.sync(dev)
    common.phase(ctx, "warm-up")
    return {"lens": lens, "pool": pool}


def window(st, ctx, seconds, trace_on, until_step=0):
    tr, dev = ctx.traffic, ctx.device
    pool, lens = st["pool"], st["lens"]
    picks = set(random.Random(ctx.seed).sample(range(tr["check_span"]),
                                               tr["check_batches"]))
    gen = torch.Generator(device=dev).manual_seed(ctx.seed)
    prof = devtrace.StepProfiler(dev, trace_on, tr["profile_first"], tr["profile_steps"])
    kept, marks = [], [devtrace.mark(dev)]
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < seconds or i < until_step:
        aif, depth = pool[i % len(pool)]
        prof.before(i)
        state = gen.get_state() if i in picks else None
        with devtrace.span("render_batch", trace_on):
            stack, _, _ = common.render_stack(lens, aif, depth, gen)
        if state is not None:
            kept.append((i % len(pool), state, stack))
        marks.append(devtrace.mark(dev))
        prof.after(i)
        i += 1
    devtrace.sync(dev)
    wall = time.perf_counter() - t0
    step_ms = [devtrace.elapsed_ms(a, b) for a, b in zip(marks[:-1], marks[1:])]
    st["kept"] = kept
    bs = ctx.config["bs"]
    h, w = ctx.config["res"]
    per_sample = render_counts.render_flops(ctx.config["psfnet"], h, w)
    rec = {"loop": "render", "n_steps": i, "window_s": wall, "step_ms": step_ms,
           "profile": prof.result,
           "profiled_wall_s": prof.wall_s,
           "least_step_s": bs * per_sample / peaks.BF16_FLOPS,
           "k2_shape": (bs, h, w, 3, ctx.config["psfnet"]["ks"]),
           "window_note": f"longest step {max(step_ms, default=0.0):.1f} ms"}
    e2e = {"render_pairs_per_s": bs * i / wall, "step_ms_p95": common.p95(step_ms)}
    return e2e, rec


def release(st):
    """Free the program's lens and surrogate; the compared stacks stay."""
    st.pop("lens", None)


def check(st, ctx):
    if not st["kept"]:
        return {"max_abs_gap": float("nan"), "mean_abs_gap": float("nan")}
    batches = [(*st["pool"][j], state) for j, state, _ in st["kept"]]
    want = common.reference_render(ctx.config, batches, ctx.device)
    return common.render_gaps([s for _, _, s in st["kept"]], want)
