"""Build and load the port's native libraries.

Every CUDA source under ``sdirt_tpu_torch/csrc/`` is compiled by nvcc for
sm_90a into a shared library with a plain C interface, at first use in a
process, and loaded with ctypes. One call builds all of them, one nvcc
process per source, all started together, so a process pays for one build of
the slowest file. ``compile_all`` does the compiling, with the compiler as
a parameter: the host C++ decoders of ``native/`` go through it with g++.

A library is named after a digest of its source, compiler and flags
(``<name>-<digest>.so`` in ``csrc/build/``, git-ignored). ``reuse=True``
loads such a file when it exists instead of compiling again, so the ranks
of a multi-process run (parallel/mesh.py) load what their parent built;
``reuse=False`` always compiles. There is no nvcc and no card on a CPU-only
machine: the CUDA wrappers then run their plain PyTorch versions, and only
for tensors that lie on the CPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3")
NVCC_FLAGS = (*ARCH_FLAGS, "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")
SOURCES = ("fused_dp_conv", "fused_trace")

# nvcc builds in this process (build() compiles all sources once)
builds = 0
# nvcc's report per source (the -Xptxas -v lines: registers, spills, stack)
build_log: dict[str, str] = {}
build_seconds = 0.0
# the file each library was loaded from
lib_paths: dict[str, str] = {}
_libs: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """The path of nvcc (CUDA_HOME, /usr/local/cuda or the PATH)."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                           "kernels are compiled at first use on the card's "
                           "machine")
    return found


def library_path(name: str, src: str, argv) -> str:
    """``BUILD_DIR/<name>-<digest>.so``, the digest over the source's bytes
    and the command line that compiles it."""
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read() + "\0".join(argv).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"{name}-{digest}.so")


def compile_all(jobs: dict, timeout: float = 600.0, reuse: bool = True):
    """Compile shared libraries in parallel and load them.

    jobs: {name: (source, argv)}, argv the compiler's command line without
    its output (``-o <file>`` is appended) -- every source's compiler is
    started before any is waited for. Returns ({name: CDLL}, {name: the
    compiler's output}, whether anything was compiled). A failing compiler
    raises RuntimeError with its output; so does running out of ``timeout``
    seconds."""
    t0 = time.perf_counter()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs, paths, logs = {}, {}, {}
    for name, (src, argv) in jobs.items():
        paths[name] = library_path(name, src, argv)
        if reuse and os.path.exists(paths[name]):
            continue
        tmp = f"{paths[name]}.{os.getpid()}.tmp"
        procs[name] = (subprocess.Popen(
            [*argv, "-o", tmp], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), src, tmp)
    failed = []
    try:
        for name, (proc, src, tmp) in procs.items():
            left = max(1.0, timeout - (time.perf_counter() - t0))
            try:
                logs[name], _ = proc.communicate(timeout=left)
            except subprocess.TimeoutExpired:
                failed.append(f"{os.path.basename(proc.args[0])} ran past "
                              f"{timeout:.0f} s on {src}")
                continue
            if proc.returncode != 0:
                failed.append(f"{os.path.basename(proc.args[0])} failed on "
                              f"{src}:\n{logs[name]}")
    finally:
        for proc, _, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError("\n".join(failed))
    for name, (_, _, tmp) in procs.items():
        os.replace(tmp, paths[name])
    return ({name: ctypes.CDLL(p) for name, p in paths.items()}, logs,
            bool(procs))


def build(timeout: float = 600.0, reuse: bool = True) -> dict[str, ctypes.CDLL]:
    """Compile every kernel source in parallel (once per process, within
    ``timeout`` seconds) and load the libraries; ``reuse`` as compile_all."""
    global builds, build_seconds
    if _libs:
        return _libs
    t0 = time.perf_counter()
    compiler = nvcc()
    jobs = {name: (src, [compiler, *NVCC_FLAGS, src])
            for name, src in ((n, os.path.join(CSRC, f"{n}.cu")) for n in SOURCES)}
    libs, logs, compiled = compile_all(jobs, timeout, reuse)
    lib_paths.update({name: library_path(name, *job) for name, job in jobs.items()})
    build_log.update(logs)
    builds += compiled
    build_seconds = time.perf_counter() - t0
    _libs.update(libs)
    return _libs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building all at first use."""
    return build()[name]
