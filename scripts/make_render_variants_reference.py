#!/usr/bin/env python
"""Write the JAX package's flat-capture scores per render variant, the
reference the PyTorch port's variant gate is held against.

For each lens in LENSES and each (surrogate, variant) in ROWS, the JAX app's
own ``test_dp_images`` (apps/dfdp_net.py) renders the bundled F/20 flat
captures (real_sample_set/flat) to F/4 with that variant
(SDIRT_RENDER_VARIANT) and scores them against the real F/4 captures: PSNR,
SSIM and the perceptual distance of both views per scene. The surrogate is
the config's ``mlp`` (configs/dfdp_by_sdirt_<lens>.yml), rendered with scan,
scan_f32 (scan with the network in f32) and fused_int8 (Pallas in interpret
mode), or the lens's promoted basis
student ``mlpb@256x48`` (ckpt/<lens>/PROMOTED_SURROGATE.json), rendered with
scan, basis and basis_int8; both are loaded with the JAX package's loaders.
Run on the CPU, at 512x768, ks 21 (about 15 minutes):

  JAX_PLATFORMS=cpu python scripts/make_render_variants_reference.py

writes sdirt_tpu_torch/reference/render_variants_jax_cpu.json.
"""

from __future__ import annotations

import ast
import importlib.util
import json
import logging
import os
import re
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

OUT = os.path.join(ROOT, "sdirt_tpu_torch", "reference",
                   "render_variants_jax_cpu.json")
LENSES = ("rf50mm", "rf35mm")
BASIS = "mlpb@256x48"
ROWS = (("mlp", "scan"), ("mlp", "scan_f32"), ("mlp", "fused_int8"), (BASIS, "scan"),
        (BASIS, "basis"), (BASIS, "basis_int8"))
COLUMNS = ("idx", "distance_mm", "psnr_l", "psnr_r", "ssim_l", "ssim_r",
           "perc_l", "perc_r")
_ROW = re.compile(r"\[idx, depth \(mm\), psnr_l, psnr_r, ssim_l, ssim_r, "
                  r"perc_l, perc_r\] : (\[.*\])")


class _Rows(logging.Handler):
    """Collects the per-scene rows test_dp_images logs."""

    def __init__(self):
        super().__init__()
        self.rows = []

    def emit(self, record):
        if m := _ROW.search(record.getMessage()):
            self.rows.append(dict(zip(COLUMNS, ast.literal_eval(m.group(1)))))


def scores(app, cfg, lens_name, net, variant, results_dir):
    """Per-scene scores of one (surrogate, variant) on the lens's flat set."""
    from sdirt_tpu.dfdp.factory import get_flat_sample_set, get_lens

    cfg = {**cfg, "results_dir": results_dir,
           "test": dict(cfg["test"])}
    if net != "mlp":
        cfg["test"].update(psfnet_model=net,
                           psfnet_path=f"./ckpt/{lens_name}/F4_PSFNet_{net}")
    _, lens = get_lens(cfg)
    # scan_f32: the scan variant with the network in f32 (the JAX gate's
    # --f32-baseline row)
    os.environ["SDIRT_RENDER_VARIANT"] = "scan" if variant == "scan_f32" else variant
    if variant == "scan_f32":
        os.environ["SDIRT_RENDER_MLP_BF16"] = "0"
    else:
        os.environ.pop("SDIRT_RENDER_MLP_BF16", None)
    handler = _Rows()
    logging.getLogger().addHandler(handler)
    try:
        app.test_dp_images(lens, get_flat_sample_set(cfg), "flat", cfg)
    finally:
        logging.getLogger().removeHandler(handler)
    return handler.rows


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    os.chdir(ROOT)
    spec = importlib.util.spec_from_file_location(
        "jax_dfdp_net", os.path.join(ROOT, "apps", "dfdp_net.py"))
    app = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(app)
    commit = subprocess.run(["git", "rev-parse", "HEAD"], capture_output=True,
                            text=True, cwd=ROOT).stdout.strip() or None
    out = {"command": "JAX_PLATFORMS=cpu python "
                      "scripts/make_render_variants_reference.py",
           "commit": commit, "res": [512, 768], "ks": 21,
           "flat_set": "real_sample_set/flat", "lenses": {}}
    with tempfile.TemporaryDirectory() as tmp:
        for lens_name in LENSES:
            config = f"configs/dfdp_by_sdirt_{lens_name}.yml"
            cfg = app.config(config)
            rows = {}
            for net, variant in ROWS:
                rows[f"{net}/{variant}"] = scores(app, cfg, lens_name, net,
                                                  variant, tmp)
                print(f"{lens_name} {net} {variant}: {rows[f'{net}/{variant}']}",
                      flush=True)
            out["lenses"][lens_name] = {"config": config, "rows": rows}
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(OUT)


if __name__ == "__main__":
    main()
