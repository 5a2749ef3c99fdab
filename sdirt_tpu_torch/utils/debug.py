"""Failure detection for debug runs (PyTorch counterpart of
sdirt_tpu/utils/debug.py).

The production trace never stops on a bad ray: invalid rays are masked out.
``checked_trace`` is the opt-in instrumented trace. It runs the port's
surface steps one at a time and watches every torch operation for a NaN in
its output, as checkify's float checks watch every primitive, then checks
the traced positions, directions and validity as the JAX version does. Its
report also names the first surface, in tracing order, at which a NaN
appeared.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from ..optics.surfaces import NEWTON_FAST_ITERS, surface_step


def _has_nan(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point() and bool(
        torch.isnan(x).any())


class _NanWatch(TorchFunctionMode):
    """Records the first operation whose output holds a NaN."""

    def __init__(self):
        super().__init__()
        self.first = None

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.first is None:
            outs = out if isinstance(out, (tuple, list)) else (out,)
            if any(_has_nan(o) for o in outs):
                self.first = getattr(func, "__name__", str(func))
        return out


class TraceReport:
    """checkify's Error, in short: ``get()`` is the report or None,
    ``throw()`` raises it. ``surface`` is the first surface (index into the
    stack) at which a NaN was generated, or None."""

    def __init__(self, message: str | None, surface: int | None):
        self.message, self.surface = message, surface

    def get(self) -> str | None:
        return self.message

    def throw(self):
        if self.message is not None:
            raise FloatingPointError(self.message)


def checked_trace(rays, stack, eta, skip, forward: bool = True,
                  maxiter: int = NEWTON_FAST_ITERS):
    """Trace as optics/surfaces.py:trace_rays does (incoherent) with
    non-finite checks. Returns (TraceReport, rays)."""
    kinds = stack.kind.tolist()
    skips = [bool(s > 0) for s in torch.as_tensor(skip).tolist()]
    order = range(stack.num_surfaces)
    watch = _NanWatch()
    surface = None
    for i in (order if forward else reversed(order)):
        p = {"c": stack.c[i], "k": stack.k[i], "ai": stack.ai[i], "d": stack.d[i],
             "r": stack.r[i], "eta": eta[i], "kind": kinds[i], "skip": skips[i]}
        with watch:
            rays = surface_step(rays, p, forward=forward, maxiter=maxiter)
        if watch.first is not None and surface is None:
            surface = i
    if watch.first is not None:
        message = f"nan generated by {watch.first} at surface {surface}"
    elif not bool(torch.isfinite(rays.o).all()):
        message = "non-finite ray positions after trace"
    elif not bool(torch.isfinite(rays.d).all()):
        message = "non-finite ray directions after trace"
    elif not math.isfinite(float(rays.ra.sum())):
        message = "non-finite validity mask"
    else:
        message = None
    return TraceReport(message, surface), rays


def assert_finite_loss(loss, context: str = "loss"):
    """Host-side NaN guard for training loops: the loss as a float, or
    FloatingPointError."""
    val = float(loss)
    if not np.isfinite(val):
        raise FloatingPointError(f"non-finite {context}: {val}")
    return val
