"""Supervised training: run ``python -m sdirt_tpu_torch.dfdp_net --stage
train`` in a child process and relaunch it into its resume path when it
dies (the stall watchdog's exit 43, ``utils/stall.py``; the OOM killer's
137; any other abnormal exit), a bounded number of times so that a config
error cannot loop for ever. Every trainer checkpoints its full train state
each epoch (``train_state_dir`` in the config), so a relaunch loses at most
an epoch.

  python -m sdirt_tpu_torch.run_train_supervised CONFIG [extra dfdp_net args]

``MAX_RETRIES`` (environment, default 8) bounds the relaunches; the child
runs in the repository's root, as ``scripts/run_train_supervised.sh`` runs
the JAX trainer. Exits 0 once the trainer exits 0, else 1 after the last
relaunch.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from datetime import datetime, timezone

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAUSE_S = 15.0


def train_command(config: str, extra=()) -> list[str]:
    """The trainer's command line."""
    return [sys.executable, "-m", "sdirt_tpu_torch.dfdp_net", "--config", config,
            "--stage", "train", *extra]


def _now() -> str:
    return datetime.now(timezone.utc).strftime("%Y-%m-%dT%H:%M:%SZ")


def supervise(config: str, extra=(), pause_s: float = PAUSE_S) -> int:
    """Run the trainer until it exits 0 (returns 0) or has been relaunched
    MAX_RETRIES times (returns 1), pausing ``pause_s`` after each failure.
    A child killed by a signal reports 128 + the signal, as a shell does."""
    max_retries = int(os.environ.get("MAX_RETRIES", "8"))
    for attempt in range(max_retries + 1):
        if attempt > 0:
            print(f"=== supervised relaunch #{attempt} ({_now()}) ===", flush=True)
        rc = subprocess.call(train_command(config, extra), cwd=ROOT)
        rc = 128 - rc if rc < 0 else rc
        if rc == 0:
            print("=== training completed cleanly ===", flush=True)
            return 0
        print(f"=== trainer exited rc={rc} ({_now()}); resuming from last epoch "
              "state ===", flush=True)
        time.sleep(pause_s)
    print(f"=== giving up after {max_retries} relaunches ===", flush=True)
    return 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("config")
    ap.add_argument("extra", nargs=argparse.REMAINDER,
                    help="further dfdp_net arguments")
    args = ap.parse_args(argv)
    return supervise(args.config, args.extra)


if __name__ == "__main__":
    sys.exit(main())
