"""Readings that a cell's limits are set from, taken on the card in one
process: the numbers ``correct`` compares for the program on many seeds
(the lower readings), for the cell's control (the upper readings) and for
the planted faults of a training cell. The benchmark's runs never run this.

    python3 benchmark/calibrate.py --workload <name> --seeds 11 12 ... \\
        [--control-seeds 21 22 23] [--out readings.json]

Render cells: the program renders ``check_span`` batches per seed (the
window runs until every compared batch is done); the control is the
program's own lower-precision path, the configuration's
``control_variant`` (the int8 trunk). Training cells: the set-up's steps,
no window; the control is the reference's depth net with TF32 on in the
program's place; the fault is half of each batch left out of the step (the
loss, and BatchNorm's moments, taken over the rest).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def render_readings(workload, seeds, control_seeds, device):
    from benchmark import harness

    out = {"program": [], "control": []}
    for tag, ss in (("program", seeds), ("control", control_seeds)):
        for seed in ss:
            ctx = harness.make_context(workload, seed, device)
            if tag == "control":
                ctx.variant = ctx.config["control_variant"]
            t0 = time.perf_counter()
            res = harness.run_loop(ctx, 0.0, False, until_step=ctx.traffic["check_span"])
            out[tag].append({"seed": seed, **res["checks"],
                             "seconds": time.perf_counter() - t0})
            print(tag, out[tag][-1], flush=True)
    return out


def empty_cache():
    import torch

    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def train_readings(workload, seeds, control_seeds, device):
    from benchmark import harness
    from benchmark.loops import train

    out = {"program": [], "control": [], "half_batch": []}
    for seed in seeds:
        ctx = harness.make_context(workload, seed, device)
        t0 = time.perf_counter()
        st = train.setup(ctx)
        train.release(st)
        empty_cache()
        ref = train.reference_steps(st, ctx)
        out["program"].append({"seed": seed, **train.render_check(st, ctx),
                               **train.compare(st, ref),
                               "losses": st["check_losses"], "ref_losses": ref["losses"],
                               "seconds": time.perf_counter() - t0})
        print("program", out["program"][-1], flush=True)
        if seed in control_seeds:
            ctl = train.reference_steps(st, ctx, tf32=True)
            as_program = {"check_losses": ctl["losses"], "grad1": ctl["grad1"],
                          "delta": ctl["delta"]}
            out["control"].append({"seed": seed, **train.compare(as_program, ref)})
            print("control", out["control"][-1], flush=True)
        del st
        empty_cache()
    import sdirt_tpu_torch.dfdp.train as program_train

    whole = program_train.dfdp_train_step

    def half_batch(state, stack, depth, *a, **k):
        n = stack.shape[0] // 2
        return whole(state, stack[:n], depth[:n], *a, **k)

    program_train.dfdp_train_step = half_batch
    try:
        for seed in control_seeds:
            ctx = harness.make_context(workload, seed, device)
            st = train.setup(ctx)
            train.release(st)
            empty_cache()
            out["half_batch"].append({"seed": seed,
                                      **train.compare(st, train.reference_steps(st, ctx))})
            print("half_batch", out["half_batch"][-1], flush=True)
            del st
            empty_cache()
    finally:
        program_train.dfdp_train_step = whole
    return out


def summarise(readings: dict) -> dict:
    """Per number: the largest program reading and the smallest of every
    other kind."""
    names = [k for k in readings["program"][0] if k.endswith("_gap")]
    summary = {}
    for name in names:
        row = {"program_max": max(r[name] for r in readings["program"])}
        for kind, rows in readings.items():
            have = [r[name] for r in rows if name in r]
            if kind != "program" and have:
                row[f"{kind}_min"] = min(have)
        summary[name] = row
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", default=None, help="write every reading here (JSON)")
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    sys.path[0] = ROOT
    from benchmark import harness

    workload = harness.find_workload(harness.benchmark_spec(), args.workload)
    traffic = harness.load_json(ROOT, "benchmark", "traffic", f"{workload['traffic']}.json")
    readings = {"render": render_readings, "train": train_readings}[traffic["loop"]](
        workload, args.seeds, args.control_seeds, args.device)
    result = {"workload": args.workload, "device": harness.device_info(
        __import__("torch").device(args.device)), "readings": readings,
              "summary": summarise(readings)}
    print(json.dumps(result["summary"], indent=1))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
