from .psf import compute_psf, compute_psf_rgb, dp_psf, lens_scalars  # noqa: F401
from .splat import DPParams, dp_split_weights, forward_integral  # noqa: F401
