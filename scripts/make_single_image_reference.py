#!/usr/bin/env python
"""The JAX package's single-image render (sdirt_tpu/render/perpixel.py:
render_single_image) on the CPU at its published defaults, for
chip_smoke.py's check of the PyTorch port's render on the card.

  sdirt_tpu_torch/reference/single_image_jax_cpu.npz

The lens is rf50mm as apps/fit_psfnet.py loads it (PSFNetLens, mlp, ks 21,
512x768), refocused to 1 m; the image is one 512x768 flat capture of
real_sample_set/ (uint8); the depth -3000 mm; psf_grid 21, psf_ks 44 (traced
at 45), GEO_SPP rays per point and wavelength, key PRNGKey(0). The render
is run op by op (``jax.disable_jit()``), as the port's CPU test holds it:
the jitted run rounds the f32 trace otherwise (its values are kept beside).

What it holds:

  image, image_sum      the capture (relative path) and its uint8 sum
  refocus_xy            the refocus's GEO_SPP first-surface samples [mm]
  d_sensor              the sensor distance after the refocus [mm]
  depth, psf_grid, psf_ks
  pupil_main, pupil_chief   [3, GEO_SPP, 2] mm: the pupil samples the
                        render's compute_psf_rgb draws per wavelength (R, G,
                        B), split from the key as it splits it
  pick                  2048 seeded flat pixel positions of the output
  values, values_jit    the output there, [2048, 3], op by op and jitted
  channel_sum, channel_sum_jit   float64 sum of each output channel, [3]
  psf_sum               each point's max-normalised PSF sum, [441, 3]

Usage:
  JAX_PLATFORMS=cpu python scripts/make_single_image_reference.py
"""

from __future__ import annotations

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import cv2
import jax
import numpy as np

from sdirt_tpu.core.constants import GEO_SPP
from sdirt_tpu.dp.psf import compute_psf_rgb, lens_scalars
from sdirt_tpu.optics.sampling import point_source_grid, sample_disk
from sdirt_tpu.psfnet.surrogate import PSFNetLens
from sdirt_tpu.render.perpixel import render_single_image

OUT = os.path.join(ROOT, "sdirt_tpu_torch", "reference", "single_image_jax_cpu.npz")
IMAGE = os.path.join("real_sample_set", "flat", "001", "1500", "f20", "l.png")
LENS = os.path.join(ROOT, "lenses", "rf50mm", "lens_web.json")
DEPTH = -3000.0
PSF_GRID = 21
PSF_KS = 44
N_PICK = 2048


def main():
    t0 = time.perf_counter()
    lens = PSFNetLens(LENS, model_name="mlp", kernel_size=21, sensor_res=(512, 768))
    r0 = float(np.asarray(lens.stack.r)[0])
    refocus_xy = np.asarray(sample_disk(jax.random.PRNGKey(0), (GEO_SPP,), r0))
    lens.refocus(-1000.0 + lens.d_sensor)

    img = cv2.cvtColor(cv2.imread(os.path.join(ROOT, IMAGE)), cv2.COLOR_BGR2RGB)
    assert img.shape == (512, 768, 3) and img.dtype == np.uint8

    key = jax.random.PRNGKey(0)
    pupilr = lens_scalars(lens)["pupilr"]
    mains, chiefs = [], []
    for k in jax.random.split(key, 3):
        k_chief, k_main = jax.random.split(k)
        mains.append(np.asarray(sample_disk(k_main, (GEO_SPP,), pupilr)))
        chiefs.append(np.asarray(sample_disk(k_chief, (GEO_SPP,), pupilr * 0.25)))

    with jax.disable_jit():
        out = render_single_image(lens, img, DEPTH, psf_grid=PSF_GRID, psf_ks=PSF_KS,
                                  key=key)
        pts = point_source_grid(depth=DEPTH, grid=PSF_GRID).reshape(-1, 3)
        psfs = np.asarray(compute_psf_rgb(lens, pts, key=key, ks=PSF_KS + 1))
    out_jit = render_single_image(lens, img, DEPTH, psf_grid=PSF_GRID, psf_ks=PSF_KS,
                                  key=key)
    h, w, _ = out.shape
    pick = np.sort(np.random.default_rng(0).choice(h * w, N_PICK, replace=False))
    np.savez_compressed(
        OUT, image=IMAGE, image_sum=np.int64(img.astype(np.int64).sum()),
        refocus_xy=refocus_xy, d_sensor=np.float64(lens.d_sensor),
        depth=np.float64(DEPTH), psf_grid=np.int64(PSF_GRID), psf_ks=np.int64(PSF_KS),
        pupil_main=np.stack(mains), pupil_chief=np.stack(chiefs), pick=pick,
        values=out.reshape(-1, 3)[pick], values_jit=out_jit.reshape(-1, 3)[pick],
        channel_sum=out.astype(np.float64).sum((0, 1)),
        channel_sum_jit=out_jit.astype(np.float64).sum((0, 1)),
        psf_sum=psfs.astype(np.float64).sum((-1, -2)))
    gap = np.abs(out - out_jit)
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes) in {time.perf_counter() - t0:.1f} s; "
          f"d_sensor {lens.d_sensor:.6f} mm; jitted vs op by op: max {gap.max():.3e}, "
          f"mean {gap.mean():.3e}")


if __name__ == "__main__":
    main()
