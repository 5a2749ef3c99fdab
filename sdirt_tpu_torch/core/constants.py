"""Physical and numerical constants (copied from sdirt_tpu/core/constants.py).

Values are behaviour, not style: tolerances and sample counts shape the
traced PSFs, and the PSF surrogate's depth normalisation and the per-lens
sensor distances shape the rendered images.
"""

# Wavelengths [um]
DEFAULT_WAVE = 0.589
WAVE_RGB = (0.656, 0.589, 0.486)

# Ray sampling
GEO_SPP = 2048          # samples/point for geometric optics calculations

# Numerics
MINT = 1e-5
MAXT = 1e5
DELTA = 1e-6
EPSILON = 1e-9          # replaces 0 in denominators

# Newton iteration: the closed-form sphere seed makes 2 loose iterations
# enough (golden-validated on both shipped lenses); 1 breaks backward tracing
# and the refocused chief-ray pipeline
NEWTON_MAXITER = 10
NEWTON_FAST_ITERS = 2
NEWTON_TOL_TIGHT = 10e-6   # [mm] == 10 nm
NEWTON_TOL_LOOSE = 50e-6   # [mm]
NEWTON_STEP_BOUND = 5.0    # [mm] max step per Newton iteration

# PSF surrogate working range [mm] (objects live at negative z)
DMIN = 200.0
DMAX = 20000.0

# Maximum number of even-asphere coefficients carried by the stacked surface
# representation (a2..a16). Shipped lenses use at most 6.
MAX_AI_TERMS = 8

# sensor distance [mm] that PSFNetLens pins per lens, without recomputing
# fov or f-number (sdirt_tpu/psfnet/surrogate.py:70-75)
D_SENSOR = {"rf35mm": 80.447, "rf50mm": 62.25}
