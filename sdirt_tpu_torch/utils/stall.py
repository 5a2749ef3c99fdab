"""Stall watchdog: notice a wedged trainer, dump every thread's stack, exit
with a distinctive code (PyTorch port's copy of sdirt_tpu/utils/stall.py).

Every trainer checkpoints its full train state each epoch and resumes from
it, so a supervisor that relaunches on ``STALL_EXIT_CODE`` turns a hang into
a lost epoch at most.
"""

from __future__ import annotations

import faulthandler
import os
import sys
import threading
import time

STALL_EXIT_CODE = 43


class StallWatchdog:
    """Exit the process if ``beat()`` is not called within ``timeout_s``.

    Usage:
        wd = StallWatchdog(timeout_s=2400)   # arm
        ... wd.beat() at every progress point ...
        wd.close()                            # disarm (end of run)
    """

    def __init__(self, timeout_s: float = 2400.0, poll_s: float = 30.0,
                 label: str = "train"):
        self.timeout_s = float(timeout_s)
        self.poll_s = float(poll_s)
        self.label = label
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="stall-watchdog")
        self._thread.start()

    def beat(self):
        self._last = time.monotonic()

    def close(self):
        self._stop.set()

    def _run(self):
        while not self._stop.wait(self.poll_s):
            idle = time.monotonic() - self._last
            if idle > self.timeout_s:
                print(f"\n=== STALL WATCHDOG [{self.label}]: no progress for "
                      f"{idle:.0f}s (> {self.timeout_s:.0f}s); dumping all "
                      f"thread stacks and exiting {STALL_EXIT_CODE} for "
                      f"supervised resume ===", file=sys.stderr, flush=True)
                faulthandler.dump_traceback(file=sys.stderr)
                sys.stderr.flush()
                os._exit(STALL_EXIT_CODE)
