"""Logging, seeding and host-memory helpers of the port's entry points
(PyTorch counterpart of part of sdirt_tpu/utils/logging.py)."""

from __future__ import annotations

import logging
import os
import random

import numpy as np
import torch


def set_seed(seed: int = 0):
    """Seed Python's, numpy's and torch's global generators."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def set_logger(result_dir: str | None = None):
    """Console logging, and ``<result_dir>/train.log`` when given, on the
    root logger."""
    root = logging.getLogger()
    root.setLevel(logging.INFO)
    for h in list(root.handlers):
        root.removeHandler(h)
    fmt = logging.Formatter("%(asctime)s - %(message)s")
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    root.addHandler(sh)
    if result_dir is not None:
        os.makedirs(result_dir, exist_ok=True)
        fh = logging.FileHandler(f"{result_dir}/train.log")
        fh.setFormatter(fmt)
        root.addHandler(fh)


def host_rss_gb() -> float:
    """Resident set size of this process in GiB (the trainer's re-exec
    check reads it after every epoch)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 2**20   # kB -> GiB
    except OSError:
        pass
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
