#!/usr/bin/env python
"""Reference numbers of the coherent demo, from the JAX package on the CPU,
for the PyTorch port's check on the card (chip_smoke.py).

``apps/coherent_demo.py`` at its defaults (rf50mm refocused to 1 m with the
JAX default key, depths -1000, -1100 and -1300 mm, ks 65, ps 1.5 um,
M 512, and ``--image``): the lens's d_sensor, and per depth the ring
contrasts (coherent, incoherent) and the radial profiles of the
max-normalised PSFs, plus the image mode's probe contrasts. The coherent
grid is deterministic quadrature, so one run is the reference; the port's
check traces at this d_sensor, since the refocus draws Monte-Carlo
samples.

Each depth is run twice: as the app runs it (jitted: XLA compiles the
trace into one program, which rounds the f32 phase in its own way) and
op by op (``jax.disable_jit()``: each operation rounded as written, the
arithmetic the port follows). The coherent PSF is f32-limited (a ray's
first step, t ~ 1 m, carries ~0.6 rad of phase rounding), so the two JAX
runs differ from each other by as much as the port differs from the
jitted one; the port is held to the op-by-op run. Written to

  sdirt_tpu_torch/reference/coherent_jax_cpu.json

Usage (about 1 minute on 8 CPU cores):
  JAX_PLATFORMS=cpu python scripts/make_coherent_reference.py
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np

OUT = os.path.join(ROOT, "sdirt_tpu_torch", "reference", "coherent_jax_cpu.json")
LENS = "lenses/rf50mm/lens_web.json"
DEPTHS = (-1000.0, -1100.0, -1300.0)
KS, PS, M = 65, 0.0015, 512


def jax_app():
    spec = importlib.util.spec_from_file_location(
        "jax_coherent_demo", os.path.join(ROOT, "apps", "coherent_demo.py"))
    app = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(app)
    return app


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    from sdirt_tpu.dp.coherent import coherent_psf_grid
    from sdirt_tpu.optics.lens import Lens

    app = jax_app()
    lens = Lens(os.path.join(ROOT, LENS), sensor_res=(512, 768))
    lens.refocus(-1000 + lens.d_sensor)
    runs = {"jit": {}, "op_by_op": {}}
    for mode, depths in runs.items():
        for depth in DEPTHS:
            t0 = time.perf_counter()
            if mode == "jit":
                coh, inc = coherent_psf_grid(lens, depth, grid=1, ks=KS, M=M, ps=PS)
            else:
                with jax.disable_jit():
                    coh, inc = coherent_psf_grid(lens, depth, grid=1, ks=KS, M=M, ps=PS)
            coh, inc = np.asarray(coh)[0, 0], np.asarray(inc)[0, 0]
            seconds = time.perf_counter() - t0
            pc, pi = app.radial_profile(coh), app.radial_profile(inc)
            depths[str(depth)] = {
                "contrast_coherent": app.ring_contrast(pc),
                "contrast_incoherent": app.ring_contrast(pi),
                "profile_coherent": [float(v) for v in pc],
                "profile_incoherent": [float(v) for v in pi],
                "seconds": seconds}
            print(mode, depth, depths[str(depth)]["contrast_coherent"],
                  depths[str(depth)]["contrast_incoherent"], flush=True)
    img_coh, img_inc, probes = app.interference_image(lens, DEPTHS, KS, PS, M)
    image = []
    for py, px, depth in probes:
        r = KS // 2
        crop_c = img_coh[py - r: py + r + 1, px - r: px + r + 1]
        crop_i = img_inc[py - r: py + r + 1, px - r: px + r + 1]
        image.append({"depth": float(depth),
                      "contrast_coherent": app.ring_contrast(app.radial_profile(crop_c)),
                      "contrast_incoherent": app.ring_contrast(app.radial_profile(crop_i))})
    out = {
        "what": "apps/coherent_demo.py at its defaults with --image: rf50mm "
                "refocused to 1 m (JAX default key), coherent_psf_grid(grid=1) per "
                "depth, op by op (depths) and jitted (depths_jit); the image probes "
                "as the app runs them (jitted)",
        "lens": LENS, "d_sensor": float(lens.d_sensor), "hfov": float(lens.hfov),
        "ks": KS, "ps": PS, "M": M, "depths": runs["op_by_op"], "depths_jit": runs["jit"],
        "image_probes": image,
        "backend": jax.default_backend(), "jax": jax.__version__,
        "command": "JAX_PLATFORMS=cpu python scripts/make_coherent_reference.py",
    }
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
