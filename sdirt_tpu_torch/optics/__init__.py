from .surfaces import SurfaceStack, trace_rays, surface_step  # noqa: F401
from .lens import Lens  # noqa: F401
from . import sampling  # noqa: F401
