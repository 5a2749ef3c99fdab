#!/usr/bin/env python
"""Reference numbers of the PSF-surrogate fit path, from the JAX package on
the CPU, for the PyTorch port's check on the card (chip_smoke.py).

The lens is built as ``apps/fit_psfnet.py`` builds it (PSFNetLens on the
Canon RF50mm at 512x768, ks 21, then ``refocus(-1000 + d_sensor)``), the
shipped surrogate ``ckpt/rf50mm/F4_PSFNet_mlp`` is loaded, and the fit's
held-out evaluation (``make_eval_fn``: 1024 field points x 65536 rays, ray
traced ground truth, sum-normalised L1/L2) is run on it. Refocus and eval
both draw Monte-Carlo samples, so the whole measurement is repeated under
three keys; the file keeps each run, their mean and their spread
(max - min), and a tolerance of 5x the spread for each value:

  sdirt_tpu_torch/reference/fit_psfnet_jax_cpu.json

Usage (about 2 minutes on 8 CPU cores):
  JAX_PLATFORMS=cpu python scripts/make_fit_psfnet_reference.py
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np

OUT = os.path.join(ROOT, "sdirt_tpu_torch", "reference",
                   "fit_psfnet_jax_cpu.json")
LENS = "lenses/rf50mm/lens_web.json"
SURROGATE = "ckpt/rf50mm/F4_PSFNet_mlp"
KEYS = (0, 1, 2)
TOL_SPREADS = 5.0


def one_run(seed: int, bs: int, spp: int, ks: int) -> dict:
    import jax

    from sdirt_tpu.dp.psf import lens_scalars
    from sdirt_tpu.psfnet.surrogate import PSFNetLens
    from sdirt_tpu.psfnet.train import _trace_impl, make_eval_fn

    lens = PSFNetLens(os.path.join(ROOT, LENS), kernel_size=ks,
                      sensor_res=(512, 768))
    lens.load_net(os.path.join(ROOT, SURROGATE))
    lens.refocus(-1000.0 + lens.d_sensor, key=jax.random.PRNGKey(seed))
    eval_fn = make_eval_fn(lens, bs=bs, spp=spp, ks=ks)
    eta, skip = lens.eta_arrays(0.589, True)
    t0 = time.perf_counter()
    l1, l2 = eval_fn(lens.params, jax.random.PRNGKey(seed), lens.stack, eta,
                     skip, lens_scalars(lens))
    return {"d_sensor": float(lens.d_sensor), "eval_l1": float(l1),
            "eval_l2": float(l2), "trace": _trace_impl(lens)[0],
            "eval_seconds": time.perf_counter() - t0}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--eval-bs", type=int, default=1024)
    ap.add_argument("--eval-spp", type=int, default=65536)
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    runs = {}
    for seed in KEYS:
        runs[f"key{seed}"] = one_run(seed, args.eval_bs, args.eval_spp, 21)
        print(seed, runs[f"key{seed}"], flush=True)
    stats = {}
    for k in ("d_sensor", "eval_l1", "eval_l2"):
        vals = np.array([r[k] for r in runs.values()])
        spread = float(vals.max() - vals.min())
        stats[k] = {"mean": float(vals.mean()), "spread": spread,
                    "tolerance": TOL_SPREADS * spread}
    out = {
        "what": "apps/fit_psfnet.py lens (PSFNetLens, refocus(-1000 + "
                "d_sensor)) with the shipped surrogate, held-out eval of "
                "sdirt_tpu/psfnet/train.py:make_eval_fn",
        "lens": LENS, "surrogate": SURROGATE, "sensor_res": [512, 768],
        "ks": 21, "eval_bs": args.eval_bs, "eval_spp": args.eval_spp,
        "backend": jax.default_backend(), "jax": jax.__version__,
        "keys": list(KEYS), "tolerance_rule": f"{TOL_SPREADS}x spread "
        "(max - min over the keys)", "runs": runs, "stats": stats,
        "command": "JAX_PLATFORMS=cpu python scripts/make_fit_psfnet_reference.py",
    }
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(stats, indent=1))


if __name__ == "__main__":
    main()
