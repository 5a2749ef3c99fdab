#!/usr/bin/env python
"""Reference numbers of the depth-side tools, from the JAX package's scripts
on the CPU, at the settings chip_smoke.py runs the PyTorch port's tools on
the card (its phase 23):

  * scripts/eval_depth_ckpt.py --ckpt ckpt/rf50mm/Sdirt_best_acc1
    --val-len 2 at 512x768: every synthetic style (the ``scan`` render;
    OpenCV's IPP off, so the scenes are the port's) and the real sample
    sets, acc1 and MAE as the script prints them;
  * scripts/dp_disparity_probe.py at its defaults (surrogate), the printed
    table and the same quantities unrounded (the script's formulas on the
    same surrogate PSFs);
  * scripts/dp_disparity_probe.py --traced (200 000 rays per point) with
    its keys (0, 1), and again with keys (2, 3); the run's spread is the
    largest difference of a depth's disparity between the two;
  * scripts/finetune_real_loo.py --steps 2 --sets box at 512x768:
    zero-shot and held-out acc1 / MAE per box scene.

  sdirt_tpu_torch/reference/depth_tools_jax_cpu.json

Usage:
  JAX_PLATFORMS=cpu python scripts/make_depth_tools_reference.py
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import os
import re
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np

OUT = os.path.join(ROOT, "sdirt_tpu_torch", "reference", "depth_tools_jax_cpu.json")
DEPTHS = (0.3, 0.5, 0.7, 0.9, 1.0, 1.2, 1.5, 2.0, 3.0, 5.0, 9.0)
TRACED_SPP = 200_000
TOL_SPREADS = 5


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(name, argv) -> tuple[str, float]:
    mod = _script(name)
    sys.argv = [name, *argv]
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        mod.main()
    text = buf.getvalue()
    print(text, flush=True)
    return text, time.perf_counter() - t0


def _disparity(psf, ks):
    """dp_disparity_probe.py's centroids and sigma, unrounded."""
    xx = np.arange(ks) - ks // 2
    cl = (psf[0].sum(0) * xx).sum() / psf[0].sum()
    cr = (psf[1].sum(0) * xx).sum() / psf[1].sum()
    sig = np.sqrt((psf[0].sum(0) * (xx - cl) ** 2).sum() / psf[0].sum())
    return float(cl - cr), float(sig)


def probe_rows(traced: bool, keys=(0, 1)):
    """dp_disparity_probe.py's loop with unrounded output; ``keys`` are the
    left and right PRNG keys of the traced PSFs."""
    import jax
    import jax.numpy as jnp

    from sdirt_tpu.psfnet.surrogate import PSFNetLens

    ks = 21
    lens = PSFNetLens("lenses/rf50mm/lens_web.json", kernel_size=ks, sensor_res=(512, 768))
    if traced:
        lens.refocus(-1000.0 + lens.d_sensor)
    else:
        lens.load_net("ckpt/rf50mm/F4_PSFNet_mlp")
    rows = []
    for d_m in DEPTHS:
        depth_mm = -d_m * 1e3 + lens.d_sensor
        if traced:
            pts = np.array([[0.0, 0.0, depth_mm]], np.float32)
            psfl = np.asarray(lens.psf(pts, spp=TRACED_SPP,
                                       key=jax.random.PRNGKey(keys[0])))[0]
            psfr = np.asarray(lens.psf(pts * np.array([-1, 1, 1], np.float32),
                                       spp=TRACED_SPP,
                                       key=jax.random.PRNGKey(keys[1])))[0, :, ::-1]
            psf = np.stack([psfl, psfr])
        else:
            z = lens.depth2z(jnp.array([depth_mm]))
            o = jnp.stack([jnp.zeros(1), jnp.zeros(1), z], -1)
            psf = np.asarray(lens.pred(o[None])).reshape(-1, 2, ks, ks)[0]
        disp, sig = _disparity(psf, ks)
        rows.append({"depth_m": d_m, "disparity_px": disp, "sigma_px": sig})
    return rows


def main():
    import cv2
    import jax

    jax.config.update("jax_platforms", "cpu")
    cv2.ipp.setUseIPP(False)
    os.chdir(ROOT)
    os.environ["SDIRT_RENDER_VARIANT"] = "scan"
    out = {"what": "the JAX package's depth-side scripts on the CPU, at the "
                   "settings of chip_smoke.py phase 23",
           "backend": jax.default_backend(), "jax": jax.__version__,
           "render_variant": "scan",
           "command": "JAX_PLATFORMS=cpu python scripts/make_depth_tools_reference.py"}

    text, secs = _run("eval_depth_ckpt", ["--ckpt", "ckpt/rf50mm/Sdirt_best_acc1",
                                          "--val-len", "2", "--cpu"])
    rows = {m[0]: {"acc1": float(m[1]), "mae": float(m[2])} for m in re.findall(
        r"^\[(v\d|real \w+)\] (?:val )?acc1 ([\d.]+)\s+mae ([\d.]+)", text, re.M)}
    out["eval_depth_ckpt"] = {"argv": "--ckpt ckpt/rf50mm/Sdirt_best_acc1 --val-len 2",
                              "res": [512, 768], "rows": rows, "seconds": secs,
                              "tolerance": 0.005}

    text, secs = _run("dp_disparity_probe", ["--cpu"])
    out["probe"] = {"printed": text, "rows": probe_rows(False), "seconds": secs,
                    "tolerance_px": 0.01}

    text, secs = _run("dp_disparity_probe", ["--cpu", "--traced"])
    a, b = probe_rows(True, (0, 1)), probe_rows(True, (2, 3))
    spread = max(abs(x["disparity_px"] - y["disparity_px"]) for x, y in zip(a, b))
    out["probe_traced"] = {
        "printed": text, "spp": TRACED_SPP, "rows_keys01": a, "rows_keys23": b,
        "spread_px": spread, "tolerance_px": TOL_SPREADS * spread,
        "tolerance_rule": f"{TOL_SPREADS}x the largest disparity difference of a "
                          "depth between the two key pairs", "seconds": secs}

    text, secs = _run("finetune_real_loo", ["--ckpt", "ckpt/rf50mm/Sdirt_best_acc1",
                                            "--steps", "2", "--sets", "box", "--cpu"])
    folds = [{"scene": int(m[0]), "acc1": float(m[1]), "mae": float(m[2]),
              "zero_shot_acc1": float(m[3]), "zero_shot_mae": float(m[4])}
             for m in re.findall(r"^\[fold box/(\d+)\] held-out acc1 ([\d.]+) mae "
                                 r"([\d.]+) \(zero-shot ([\d.]+)/([\d.]+)\)", text, re.M)]
    out["finetune_real_loo"] = {"argv": "--steps 2 --sets box", "res": [512, 768],
                                "folds": folds, "printed": text, "seconds": secs}
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
