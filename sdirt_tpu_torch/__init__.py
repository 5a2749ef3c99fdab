"""PyTorch / CUDA port of sdirt_tpu for one NVIDIA H100.

The JAX package ``sdirt_tpu`` is the reference this package is held
against; nothing here imports it (or JAX). Modules keep the JAX package's
file names, so each counterpart is easy to find. Public functions keep the
JAX layouts: NHWC into the render, tap-major ``[ks*ks, N, 2, H*W]`` for the
PSF, NCHW into the depth net.

Entry points take an explicit ``device`` (default ``"cuda"``) and raise when
no card is present; the CPU runs only when the caller asks for it, and then
every kernel wrapper takes its plain PyTorch version.

The top-level names are the JAX package's, and lazy (PEP 562): ``import
sdirt_tpu_torch`` imports no module of the package until a name is used.
"""

__version__ = "0.2.0"

_EXPORTS = {
    "Lens": "sdirt_tpu_torch.optics.lens",
    "PSFNetLens": "sdirt_tpu_torch.psfnet.surrogate",
    "Rays": "sdirt_tpu_torch.core.rays",
    "Material": "sdirt_tpu_torch.core.materials",
    "trace_rays": "sdirt_tpu_torch.optics.surfaces",
    "SurfaceStack": "sdirt_tpu_torch.optics.surfaces",
    "compute_psf": "sdirt_tpu_torch.dp.psf",
    "forward_integral": "sdirt_tpu_torch.dp.splat",
    "DPParams": "sdirt_tpu_torch.dp.splat",
    "coherent_psf": "sdirt_tpu_torch.dp.coherent",
    "render_dp": "sdirt_tpu_torch.render.pipeline",
    "Basenet": "sdirt_tpu_torch.dfdp.basenet",
    "ThinLens": "sdirt_tpu_torch.psfnet.thinlens",
}

__all__ = sorted(_EXPORTS) + ["__version__"]


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        value = getattr(importlib.import_module(_EXPORTS[name]), name)
        globals()[name] = value
        return value
    raise AttributeError(f"module 'sdirt_tpu_torch' has no attribute {name!r}")


def __dir__():
    return __all__
