"""Multi-GPU paths: the process grid (mesh.py) and the sharded steps
(steps.py). The steps are re-exported lazily (PEP 562): steps.py imports
the training modules, which import mesh.py, so an eager import here would
cycle."""

from .mesh import Mesh, launch, make_mesh, shard_batch  # noqa: F401

_STEPS = ("make_sharded_dfdp_step", "make_sharded_psfnet_step")


def __getattr__(name):
    if name in _STEPS:
        from . import steps

        value = getattr(steps, name)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
