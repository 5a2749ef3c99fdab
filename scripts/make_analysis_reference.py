#!/usr/bin/env python
"""Reference numbers of the fit's lens analysis, from the JAX package on the
CPU, for the PyTorch port's check on the card (chip_smoke.py).

The lens is built as ``apps/fit_psfnet.py`` builds it (PSFNetLens on the
Canon RF50mm at 512x768, ks 21, ``refocus(-1000 + d_sensor)``) and
``sdirt_tpu.optics.analysis.analysis`` runs at -500 and -20000 mm from the
sensor, as the app runs it without ``--skip-analysis``. Refocus and
analysis draw Monte-Carlo samples, so the whole measurement is repeated
under three keys; the files keep:

  sdirt_tpu_torch/reference/analysis_jax_cpu.json
      each run's RMS radii (average, on-axis, off-axis, mm) and d_sensor,
      their mean, spread (max - min) and a tolerance of 5x the spread; for
      the 9 x 9 x 3 PSF map (per-cell max-normalised), the spread (the
      largest mean |difference| between two keys' maps) and 5x it;
  sdirt_tpu_torch/reference/analysis_psf_map_<depth>.png
      the mean of the three keys' PSF maps, 8-bit (its rounding, at most
      1/510, is stated in the JSON).

Usage (about 3 minutes on 8 CPU cores):
  JAX_PLATFORMS=cpu python scripts/make_analysis_reference.py
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np

REF_DIR = os.path.join(ROOT, "sdirt_tpu_torch", "reference")
OUT = os.path.join(REF_DIR, "analysis_jax_cpu.json")
LENS = "lenses/rf50mm/lens_web.json"
KEYS = (0, 1, 2)
DEPTHS0 = (-500, -20000)
TOL_SPREADS = 5.0
KS = 21


def one_run(seed: int, tmp: str) -> dict:
    import jax

    from sdirt_tpu.optics.analysis import analysis, draw_psf_map
    from sdirt_tpu.psfnet.surrogate import PSFNetLens

    lens = PSFNetLens(os.path.join(ROOT, LENS), kernel_size=KS, sensor_res=(512, 768))
    d_sensor = lens.d_sensor
    lens.refocus(-1000.0 + d_sensor, key=jax.random.PRNGKey(seed))
    out = {"d_sensor": float(lens.d_sensor), "depths": {}}
    for depth0 in DEPTHS0:
        depth = depth0 + d_sensor
        key = jax.random.PRNGKey(seed)
        t0 = time.perf_counter()
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            rms = analysis(lens, save_name=f"{tmp}/{int(depth)}", depth=depth, ks=KS,
                           key=key)
        seconds = time.perf_counter() - t0
        # analysis() draws its PSF map with this key; the same call again
        # returns the map it drew
        psf_map = draw_psf_map(lens, save_name=f"{tmp}/{int(depth)}", ks=KS,
                               depth=depth, key=key)
        out["depths"][str(depth)] = {"rms_avg": rms[0], "rms_on": rms[1],
                                     "rms_off": rms[2], "seconds": seconds,
                                     "printed": printed.getvalue().strip(),
                                     "psf_map": psf_map}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    from sdirt_tpu_torch.utils.png import write_png

    with tempfile.TemporaryDirectory() as tmp:
        runs = {seed: one_run(seed, tmp) for seed in KEYS}
    stats, maps = {}, {}
    vals = np.array([r["d_sensor"] for r in runs.values()])
    stats["d_sensor"] = {"mean": float(vals.mean()), "spread": float(np.ptp(vals)),
                         "tolerance": TOL_SPREADS * float(np.ptp(vals))}
    for depth in runs[KEYS[0]]["depths"]:
        per = [r["depths"][depth] for r in runs.values()]
        st = {}
        for k in ("rms_avg", "rms_on", "rms_off"):
            v = np.array([p[k] for p in per])
            st[k] = {"mean": float(v.mean()), "spread": float(np.ptp(v)),
                     "tolerance": TOL_SPREADS * float(np.ptp(v))}
        m = [p.pop("psf_map") for p in per]
        spread = max(float(np.abs(a - b).mean()) for i, a in enumerate(m) for b in m[i + 1:])
        mean_map = np.clip(np.mean(m, axis=0), 0, 1)
        png = f"analysis_psf_map_{int(float(depth))}.png"
        write_png(os.path.join(os.path.dirname(args.out), png), mean_map)
        st["psf_map"] = {"png": png, "shape": list(mean_map.shape),
                         "spread_mean_abs": spread,
                         "tolerance_mean_abs": TOL_SPREADS * spread,
                         "png_rounding_max": 1.0 / 510}
        stats[depth] = st
        print(depth, json.dumps(st), flush=True)
    out = {
        "what": "apps/fit_psfnet.py lens (PSFNetLens rf50mm, ks 21, refocus(-1000 + "
                "d_sensor)), sdirt_tpu/optics/analysis.py:analysis at -500 and -20000 "
                "mm from the sensor",
        "lens": LENS, "sensor_res": [512, 768], "ks": KS,
        "backend": jax.default_backend(), "jax": jax.__version__,
        "keys": list(KEYS), "tolerance_rule": f"{TOL_SPREADS}x spread (max - min over "
        "the keys; for the PSF map the largest mean |difference| of two keys' maps)",
        "runs": {f"key{k}": v for k, v in runs.items()}, "stats": stats,
        "command": "JAX_PLATFORMS=cpu python scripts/make_analysis_reference.py",
    }
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
