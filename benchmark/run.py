"""Run one cell of the sdirt_tpu_torch benchmark once, on one NVIDIA GPU.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Prints, as the last line of standard output,
one JSON object: correct, attempted, failed, metrics (the cell's end-to-end
metrics with --trace 0, its per-layer metrics with --trace 1), device (and
with --trace 1 a breakdown), and last the numbers compared with their
limits. Exits non-zero with no result when no CUDA device is visible.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".bench_cache")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    # build and kernel caches at fixed paths inside the checkout
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["USE_FLAX"] = "0"
    # the package's modules by their package names only, not this folder's
    sys.path[0] = ROOT
    from benchmark import harness

    return harness.main(args)


if __name__ == "__main__":
    sys.exit(main())
