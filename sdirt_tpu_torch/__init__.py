"""PyTorch / CUDA port of sdirt_tpu for one NVIDIA H100.

The JAX package ``sdirt_tpu`` is the reference this package is held
against; nothing here imports it (or JAX). Modules keep the JAX package's
file names, so each counterpart is easy to find. Public functions keep the
JAX layouts: NHWC into the render, tap-major ``[ks*ks, N, 2, H*W]`` for the
PSF, NCHW into the depth net.

Entry points take an explicit ``device`` (default ``"cuda"``) and raise when
no card is present; the CPU runs only when the caller asks for it, and then
every kernel wrapper takes its plain PyTorch version.
"""
