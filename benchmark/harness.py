"""The benchmark's harness: finds a cell's configuration, traffic mix,
limits and per-layer readers by name, runs the cell's loop once, decides
``correct`` against the plain reference, and assembles the result line.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the name ``BENCHMARK.json`` gives it:

    configs/<config>.json     sizes, checkpoints, precisions, the source
    traffic/<traffic>.json    the loop kind (loops/<loop>.py) and its
                              parameters (batch, pool, window shape, checks)
    limits/<workload>.json    the limit of each number ``correct`` compares
    metrics/<metric>.py       read(rec) -> value or None, one per-layer metric
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import torch

from . import devtrace

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
BANNED = ("jax", "jaxlib", "flax", "sdirt_tpu")


def process_start() -> float:
    """The process's start on the time.time() clock (Linux /proc), else the
    first import of this module."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(l.split()[1]) for l in f if l.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return _IMPORTED


_IMPORTED = time.time()


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark_spec(root: str = ROOT) -> dict:
    return load_json(root, "BENCHMARK.json")


def find_workload(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def load_reader(metric: str):
    """metrics/<metric>.py as a module (its name may hold dots)."""
    path = os.path.join(BENCH_DIR, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(spec: dict, workload: str, kind: str) -> list[dict]:
    """The end_to_end or per_layer metrics that a workload reports."""
    return [m for m in spec[kind]
            if "workloads" not in m or workload in m["workloads"]]


def banned_modules() -> list[str]:
    """Loaded modules whose top-level name is a banned one (compared whole)."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops.intersection(BANNED))


def device_info(device) -> dict:
    info = {"platform": "gpu" if device.type == "cuda" else device.type,
            "kind": torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu", "count": 1}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i",
                              str(device.index or 0)], capture_output=True,
                             text=True, timeout=20)
        info["power_limit_w"] = float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        pass
    return info


def make_context(workload: dict, seed: int, device, overrides=None,
                 variant=None) -> SimpleNamespace:
    """The cell's configuration, traffic and limits, with ``overrides``
    (a dict of "config" / "traffic" key updates, for small CPU runs)."""
    overrides = overrides or {}
    config = load_json(BENCH_DIR, "configs", f"{workload['config']}.json")
    traffic = load_json(BENCH_DIR, "traffic", f"{workload['traffic']}.json")
    config.update(overrides.get("config", {}))
    traffic.update(overrides.get("traffic", {}))
    limits_path = os.path.join(BENCH_DIR, "limits", f"{workload['name']}.json")
    limits = load_json(limits_path) if os.path.exists(limits_path) else {}
    return SimpleNamespace(workload=workload, config=config, traffic=traffic,
                           limits=limits, seed=seed, device=torch.device(device),
                           variant=variant, phases={})


def run_loop(ctx, seconds: float, trace_on: bool, until_step: int = 0) -> dict:
    """Set up, measure and check one cell; returns the raw outcome:
    {"e2e", "rec", "checks", "attempted", "memory_peak_bytes"}."""
    loop = importlib.import_module(f"benchmark.loops.{ctx.traffic['loop']}")
    dev = ctx.device
    state = loop.setup(ctx)
    devtrace.sync(dev)
    setup_s = time.time() - process_start()
    setup_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    e2e, rec = loop.window(state, ctx, seconds, trace_on, until_step)
    window_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    rec["peak_mem_bytes"] = window_peak
    loop.release(state)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = loop.check(state, ctx)
    return {"e2e": {**e2e, "setup_s": setup_s}, "rec": rec, "checks": checks,
            "attempted": rec["n_steps"], "memory_peak_bytes": max(setup_peak, window_peak)}


def judge(checks: dict, limits: dict) -> tuple[bool, dict]:
    """Every compared number against its limit: correct when each is finite
    and at most its limit, and every number has a limit."""
    table = {k: {"value": v, "limit": limits.get(k)} for k, v in checks.items()}
    ok = bool(table) and all(
        t["limit"] is not None and math.isfinite(t["value"]) and t["value"] <= t["limit"]
        for t in table.values())
    return ok, table


def result_line(ctx, out: dict, trace_on: bool, spec: dict) -> dict:
    """The JSON object of a run: metrics by name, the device, the breakdown
    of a traced run, and last the numbers compared with their limits."""
    name = ctx.workload["name"]
    metrics = {}
    if trace_on:
        for m in metrics_of(spec, name, "per_layer"):
            value = load_reader(m["name"]).read(out["rec"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in metrics_of(spec, name, "end_to_end"):
            if m["name"] in out["e2e"]:
                metrics[m["name"]] = {"value": out["e2e"][m["name"]], "unit": m["unit"]}
    correct, table = judge(out["checks"], ctx.limits)
    device = {**device_info(ctx.device), "memory_peak_bytes": out["memory_peak_bytes"]}
    line = {"correct": correct, "attempted": out["attempted"], "failed": 0,
            "metrics": metrics, "device": device}
    prof = out["rec"].get("profile")
    if trace_on and prof is not None:
        device.update(busy_s=prof["busy_s"], window_s=prof["window_s"])
        line["breakdown"] = {
            "device_ops": [[k, s] for k, _, s in prof["kernels"][:10]],
            "idle_gaps": prof["idle_gaps"][:10]}
    line["checks"] = table
    return line


def main(args) -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on an NVIDIA GPU only",
              file=sys.stderr)
        return 2
    spec = benchmark_spec()
    workload = find_workload(spec, args.workload)
    if torch.cuda.device_count() < workload["chips"]:
        print(f"{workload['name']} needs {workload['chips']} devices, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    ctx = make_context(workload, args.seed, "cuda:0")
    out = run_loop(ctx, float(args.seconds), bool(args.trace))
    banned = banned_modules()
    if banned:
        print(f"modules loaded that the benchmark must not load: {banned}",
              file=sys.stderr)
        return 3
    line = result_line(ctx, out, bool(args.trace), spec)
    print("set-up phases (s since process start): " + ", ".join(
        f"{k} {v:.2f}" for k, v in ctx.phases.items()), file=sys.stderr)
    print(f"window: {out['rec']['n_steps']} steps in {out['rec']['window_s']:.3f} s, "
          f"{out['rec']['window_note']}", file=sys.stderr)
    for k, t in line["checks"].items():
        print(f"check {k}: {t['value']!r} limit {t['limit']!r}", file=sys.stderr)
    print(f"correct: {line['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
