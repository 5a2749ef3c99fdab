"""Logging, seeding, profiling and memory helpers of the port's entry
points (PyTorch counterpart of sdirt_tpu/utils/logging.py)."""

from __future__ import annotations

import contextlib
import logging
import os
import random
import time

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


@contextlib.contextmanager
def profile_trace(log_dir: str | None):
    """A ``torch.profiler`` scope that writes a Chrome trace (viewable in
    Perfetto or chrome://tracing) into ``log_dir``: CPU activity, and CUDA
    activity where a card is present. Yields the profiler, whose
    ``trace_path`` names the file once the scope has closed; ``None`` gives
    a no-op scope that yields None."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.trace_path = os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(prof.trace_path)


class RaysPerSecond:
    """Accumulating throughput counter for the trace-and-splat north star."""

    def __init__(self):
        self.rays = 0
        self.seconds = 0.0

    @contextlib.contextmanager
    def measure(self, n_rays: int):
        t0 = time.perf_counter()
        yield
        self.seconds += time.perf_counter() - t0
        self.rays += n_rays

    @property
    def rays_per_sec(self) -> float:
        return self.rays / self.seconds if self.seconds else 0.0


def print_memory(tag: str = ""):
    """Per CUDA device: memory in use and its peak (the caching allocator's
    ``torch.cuda.memory_stats``) and the device's total (``mem_get_info``),
    in GiB. Prints nothing without a card, as the JAX function prints
    nothing for a device without memory statistics."""
    if not torch.cuda.is_available():
        return
    for i in range(torch.cuda.device_count()):
        dev = torch.device("cuda", i)
        stats = torch.cuda.memory_stats(dev)
        used = stats.get("allocated_bytes.all.current", 0) / 2**30
        peak = stats.get("allocated_bytes.all.peak", 0) / 2**30
        lim = torch.cuda.mem_get_info(dev)[1] / 2**30
        print(f"{tag} {dev}: {used:.2f} GiB in use "
              f"(peak {peak:.2f} / limit {lim:.2f})")


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


def batch_LPIPS(img, img_clean):
    """Perceptual distance of a batch: the weight-free MS-SSIM + GMSD proxy
    (``dfdp/perceptual.batch_perceptual``), 0 for identical images and
    monotone with degradation, but not on the LPIPS scale. The ``lpips``
    package is a dependency of neither package: the JAX function takes this
    branch wherever it is absent, and the port does not look for it."""
    from ..dfdp.perceptual import batch_perceptual

    return batch_perceptual(img, img_clean)
