"""Device timing and the profiler's trace: CUDA events, the bounded
``torch.profiler`` window of a traced run, and what is read from its Chrome
trace (device busy time, kernel time by name, idle gaps by host activity).
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW_SPAN = "profiled_steps"


def mark(device):
    """A point in time: a recorded CUDA event on the card, the host clock
    elsewhere (where every operation has finished when it returns)."""
    if device.type != "cuda":
        return time.perf_counter()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def elapsed_ms(a, b) -> float:
    if isinstance(a, float):
        return 1e3 * (b - a)
    return a.elapsed_time(b)


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def span(name: str, on: bool):
    """A named host span in the profiler's trace (a no-op when off)."""
    return torch.profiler.record_function(name) if on else contextlib.nullcontext()


class StepProfiler:
    """torch.profiler over steps [first, first + count) of a loop, left on
    a synchronised device. ``result`` holds what was read from the trace,
    None until it has run (and when disabled)."""

    def __init__(self, device, enabled: bool, first: int, count: int):
        self.device, self.enabled = device, enabled
        self.first, self.last = first, first + count - 1
        self.prof = self.region = None
        self.wall_s = 0.0
        self.result = None

    def before(self, step: int):
        if not self.enabled or step != self.first:
            return
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        # no synchronisation here: the device goes on with the work queued
        # before, and the window opens at the first kernel recorded
        self._t0 = time.perf_counter()
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.region = torch.profiler.record_function(WINDOW_SPAN)
        self.region.__enter__()

    def after(self, step: int):
        if self.prof is None or step != self.last:
            return
        sync(self.device)
        self.region.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.wall_s = time.perf_counter() - self._t0
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        self.prof = None
        self.result = read_trace(events)
        self.result["steps"] = self.last - self.first + 1

    @property
    def active(self) -> bool:
        return self.prof is not None


def _union(spans):
    merged = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def read_trace(events) -> dict:
    """From a Chrome trace's events: the profiled window (the WINDOW_SPAN
    annotation, from the first device activity recorded in it: the work
    queued before the profiler started is not recorded), device busy seconds in it (the union of kernel, memcpy and
    memset intervals), kernel seconds and launches by name, and the ten
    longest idle gaps of the device, each named by the innermost benchmark
    span and host operator running at the gap's middle."""
    win = [e for e in events if e.get("name") == WINDOW_SPAN and e.get("ph") == "X"]
    if not win:
        raise RuntimeError("the trace holds no profiled window")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    starts = [float(e["ts"]) for e in events
              if e.get("cat") in DEVICE_CATS and e.get("ph") == "X"]
    w0 = max(w0, min(starts, default=w0))
    dev, by_name = [], {}
    for e in events:
        if e.get("cat") not in DEVICE_CATS or e.get("ph") != "X":
            continue
        a = max(float(e["ts"]), w0)
        b = min(float(e["ts"]) + float(e["dur"]), w1)
        if b <= a:
            continue
        dev.append((a, b))
        n, s = by_name.get(e["name"], (0, 0.0))
        by_name[e["name"]] = (n + 1, s + (b - a) / 1e6)
    busy = _union(dev)
    busy_s = sum(b - a for a, b in busy) / 1e6
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    host = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"], e.get("cat"))
            for e in events if e.get("ph") == "X"
            and e.get("cat") in ("cpu_op", "user_annotation")
            and e.get("name") != WINDOW_SPAN]

    def doing(t):
        inner = {}
        for a, b, name, cat in host:
            if a <= t <= b and (cat not in inner or b - a < inner[cat][0]):
                inner[cat] = (b - a, name)
        parts = [inner[c][1] for c in ("user_annotation", "cpu_op") if c in inner]
        return " / ".join(parts) or "no host span"

    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    kernels = sorted(((k, n, s) for k, (n, s) in by_name.items()), key=lambda r: -r[2])
    return {"window_s": (w1 - w0) / 1e6, "busy_s": busy_s, "kernels": kernels,
            "idle_gaps": [[doing((a + b) / 2), (b - a) / 1e6] for a, b in longest]}
