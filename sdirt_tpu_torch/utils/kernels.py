"""Build and load the port's CUDA kernels.

Every source under ``sdirt_tpu_torch/csrc/`` is compiled by nvcc for sm_90a
into a shared library with a plain C interface, at first use in a process,
and loaded with ctypes. One call builds all of them, one nvcc process per
source, all started together, so a process pays for one build of the
slowest file. The libraries go to ``csrc/build/`` (git-ignored). There is no
nvcc and no card on a CPU-only machine: the wrappers then run their plain
PyTorch versions, and only for tensors that lie on the CPU.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")
# per-source flags: the ray trace keeps every multiply and add separately
# rounded, as its plain version does (csrc/fused_trace.cu, Numerics)
SOURCES = {
    "fused_dp_conv": (),
    "fused_trace": ("--fmad=false",),
}

# nvcc builds in this process (build() compiles all sources once)
builds = 0
# nvcc's report per source (the -Xptxas -v lines: registers, spills, stack)
build_log: dict[str, str] = {}
build_seconds = 0.0
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                           "kernels are compiled at first use on the card's "
                           "machine")
    return found


def build(timeout: float = 600.0) -> dict[str, ctypes.CDLL]:
    """Compile every kernel source in parallel (once per process, within
    ``timeout`` seconds) and load the libraries."""
    global builds, build_seconds
    if _libs:
        return _libs
    t0 = time.perf_counter()
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name, flags in SOURCES.items():
        src = os.path.join(CSRC, f"{name}.cu")
        tmp = os.path.join(BUILD_DIR, f"{name}.so.{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *flags, "-o", tmp, src], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), src, tmp)
    failed = []
    try:
        for name, (proc, src, tmp) in procs.items():
            left = max(1.0, timeout - (time.perf_counter() - t0))
            out, _ = proc.communicate(timeout=left)
            build_log[name] = out
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {src}:\n{out}")
    finally:
        for proc, _, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError("\n".join(failed))
    libs = {}
    for name, (_, _, tmp) in procs.items():
        so = os.path.join(BUILD_DIR, f"{name}.so")
        os.replace(tmp, so)
        libs[name] = ctypes.CDLL(so)
    builds += 1
    build_seconds = time.perf_counter() - t0
    _libs.update(libs)
    return _libs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building all at first use."""
    return build()[name]
