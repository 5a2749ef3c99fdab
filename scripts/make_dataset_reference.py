#!/usr/bin/env python
"""A small NYUv2-layout tree for the PyTorch port's real-data path
(``NYUdata_train``), written with OpenCV from seeded JAX-package scenes.

  sdirt_tpu_torch/reference/datasets/nyu2_train/<scene>/<i>.jpg   colour
  sdirt_tpu_torch/reference/datasets/nyu2_train/<scene>/<i>.png   depth

2 scenes x 4 pairs at NYU's 640x480. The content is
``SyntheticRGBD(style="v5", seed=2024 + scene)`` item i (eval mode, so no
photometric jitter); the colour frame is written by ``cv2.imwrite`` as a
quality-95 JPEG at OpenCV's default 4:2:0 sampling, the depth as an 8-bit
PNG of round(depth * 25.5), the NYU loader's scale (so 10 m at most).
No NYU data is in the repository; this tree stands in for it in
chip_smoke.py and tests/test_torch_real_data.py. OpenCV runs without IPP,
so the scenes are those the port generates.

Usage:
  JAX_PLATFORMS=cpu python scripts/make_dataset_reference.py
"""

from __future__ import annotations

import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import cv2
import numpy as np

OUT = os.path.join(ROOT, "sdirt_tpu_torch", "reference", "datasets", "nyu2_train")
SCENES, PAIRS, RES = 2, 4, (480, 640)


def main():
    cv2.ipp.setUseIPP(False)
    from sdirt_tpu.dfdp.datasets import SyntheticRGBD

    shutil.rmtree(OUT, ignore_errors=True)
    total = 0
    for s in range(SCENES):
        scene = os.path.join(OUT, f"scene_{s:02d}")
        os.makedirs(scene)
        ds = SyntheticRGBD(RES, length=PAIRS, seed=2024 + s, train=False, style="v5")
        for i in range(PAIRS):
            aif, depth = ds[i]
            rgb = np.clip(aif.transpose(1, 2, 0) * 255.0 + 0.5, 0, 255).astype(np.uint8)
            d8 = np.clip(np.round(depth[0] * 25.5), 0, 255).astype(np.uint8)
            jpg, png = os.path.join(scene, f"{i:04d}.jpg"), os.path.join(scene, f"{i:04d}.png")
            assert cv2.imwrite(jpg, rgb[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, 95])
            assert cv2.imwrite(png, d8)
            total += os.path.getsize(jpg) + os.path.getsize(png)
    print(f"wrote {SCENES} x {PAIRS} pairs to {OUT}: {total / 1e6:.3f} MB")


if __name__ == "__main__":
    main()
