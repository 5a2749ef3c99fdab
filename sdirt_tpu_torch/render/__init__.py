from .camera import degamma, dp_noise, gamma  # noqa: F401
from .perpixel import local_dp_conv, psf_map_conv, uniform_psf_conv  # noqa: F401
from .pipeline import render_dp  # noqa: F401
