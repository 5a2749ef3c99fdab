from .constants import *  # noqa: F401,F403
from .materials import Material  # noqa: F401
from .rays import Rays, normalize  # noqa: F401
