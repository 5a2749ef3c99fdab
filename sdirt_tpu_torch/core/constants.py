"""Constants of the render path (copied from sdirt_tpu/core/constants.py).

Values are behaviour, not style: the PSF surrogate's depth normalisation and
the per-lens sensor distances shape the rendered images.
"""

# PSF surrogate working range [mm] (objects live at negative z)
DMIN = 200.0
DMAX = 20000.0

# sensor distance [mm] that PSFNetLens pins per lens, without recomputing
# fov or f-number (sdirt_tpu/psfnet/surrogate.py:70-75)
D_SENSOR = {"rf35mm": 80.447, "rf50mm": 62.25}
