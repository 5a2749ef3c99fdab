"""Multi-GPU paths: the process grid (mesh.py) and the sharded steps
(steps.py, imported from there: it imports the training modules, which
import mesh.py)."""

from .mesh import Mesh, launch, make_mesh, shard_batch  # noqa: F401
