#!/usr/bin/env python
"""Export the shipped orbax checkpoints that the PyTorch port's serve path
needs to ``.npz`` files, and turn the JAX package's ``--stage sample`` log
into the port's reference numbers.

The port (``sdirt_tpu_torch``) runs on a machine with neither JAX nor orbax,
so the two trees of ``configs/dfdp_by_sdirt_rf50mm.yml`` are restored here,
on the CPU, with the JAX package's own loaders and written as flat float32
trees (``"params/Dense_0/kernel"``, ``"batch_stats/.../mean"``, ...):

  ckpt/rf50mm/F4_PSFNet_mlp    -> sdirt_tpu_torch/weights/rf50mm/F4_PSFNet_mlp.npz
  ckpt/rf50mm/Sdirt_best_acc1  -> sdirt_tpu_torch/weights/rf50mm/Sdirt_best_acc1.npz

Usage:
  JAX_PLATFORMS=cpu python scripts/export_torch_weights.py
  JAX_PLATFORMS=cpu SDIRT_RENDER_VARIANT=scan \\
      python apps/dfdp_net.py --stage sample > stage_sample.log 2>&1
  python scripts/export_torch_weights.py --reference-log stage_sample.log
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np

OUT_DIR = os.path.join(ROOT, "sdirt_tpu_torch", "weights", "rf50mm")
REF_JSON = os.path.join(ROOT, "sdirt_tpu_torch", "reference",
                        "stage_sample_jax_cpu.json")
PSFNET = "ckpt/rf50mm/F4_PSFNet_mlp"
DEPTHNET = "ckpt/rf50mm/Sdirt_best_acc1"


def _flat(tree, prefix):
    import flax

    flat = flax.traverse_util.flatten_dict(tree, sep="/")
    return {f"{prefix}/{k}": np.asarray(v, np.float32) for k, v in flat.items()}


def psfnet_tree():
    """The F/4 rf50mm PSF surrogate, restored by PSFNetLens.load_net."""
    from sdirt_tpu.psfnet.surrogate import PSFNetLens

    lens = PSFNetLens(os.path.join(ROOT, "lenses/rf50mm/lens_web.json"),
                      sensor_res=(512, 768), kernel_size=21)
    lens.load_net(os.path.join(ROOT, PSFNET))
    return _flat(lens.params["params"], "params")


def depthnet_tree():
    """The shipped DDDNet, restored by restore_inference_ckpt against an
    abstract template of the net at 128x192 (the smallest input the
    two-scale SPP of the feature tower accepts; parameter shapes do not
    depend on it)."""
    import jax
    import jax.numpy as jnp

    from sdirt_tpu.dfdp.basenet import Basenet
    from sdirt_tpu.utils.checkpoint import restore_inference_ckpt

    dev = jax.sharding.SingleDeviceSharding(jax.devices()[0])
    shapes = jax.eval_shape(lambda: Basenet().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 6, 128, 192)), train=False))
    abstract = jax.tree.map(
        lambda s: jax.ShapeDtypeStruct(s.shape, s.dtype, sharding=dev), shapes)
    params, stats = restore_inference_ckpt(os.path.join(ROOT, DEPTHNET),
                                           abstract["params"],
                                           abstract["batch_stats"])
    return {**_flat(params, "params"), **_flat(stats, "batch_stats")}


def export(out_dir=OUT_DIR):
    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    for name, tree in (("F4_PSFNet_mlp", psfnet_tree()),
                       ("Sdirt_best_acc1", depthnet_tree())):
        path = os.path.join(out_dir, f"{name}.npz")
        np.savez(path, **tree)
        paths[name] = path
        print(f"{path}: {len(tree)} arrays, "
              f"{sum(v.size for v in tree.values())} float32 values")
    return paths


_FLAT_ROW = re.compile(r"\[idx, depth \(mm\), psnr_l, psnr_r, ssim_l, ssim_r"
                       r".*\] : (\[.*\])")
_DEPTH_SET = re.compile(r"Test Depth Est on (\w+)Sample")
_MSE_MAE = re.compile(r"Avg_mse/mae\(\d+\): ([-\d.e]+), ([-\d.e]+)")
_ACC = re.compile(r"Avg_acc_est\(\d+\): ([-\d.e]+), ([-\d.e]+), ([-\d.e]+)")


def parse_stage_sample_log(text: str) -> dict:
    """The per-scene flat-capture scores and the per-set depth metrics that
    apps/dfdp_net.py --stage sample logs."""
    flat, depth, current = [], {}, None
    for line in text.splitlines():
        if m := _FLAT_ROW.search(line):
            row = ast.literal_eval(m.group(1))
            flat.append(dict(zip(("idx", "distance_mm", "psnr_l", "psnr_r",
                                  "ssim_l", "ssim_r"), row[:6])))
        elif m := _DEPTH_SET.search(line):
            current = m.group(1)
        elif (m := _MSE_MAE.search(line)) and current:
            depth[current] = {"mse": float(m.group(1)),
                              "mae": float(m.group(2))}
        elif (m := _ACC.search(line)) and current:
            depth[current].update(acc1=float(m.group(1)),
                                  acc2=float(m.group(2)),
                                  acc3=float(m.group(3)))
            current = None
    if not flat or set(depth) != {"box", "f2d", "casual"}:
        raise ValueError("log holds no complete --stage sample run")
    return {
        "command": "JAX_PLATFORMS=cpu SDIRT_RENDER_VARIANT=scan "
                   "python apps/dfdp_net.py --stage sample",
        "config": "configs/dfdp_by_sdirt_rf50mm.yml",
        "flat": flat,
        "depth": depth,
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--reference-log",
                    help="write the reference JSON from this --stage sample "
                         "log instead of exporting weights")
    args = ap.parse_args()
    if args.reference_log:
        with open(args.reference_log) as f:
            ref = parse_stage_sample_log(f.read())
        os.makedirs(os.path.dirname(REF_JSON), exist_ok=True)
        with open(REF_JSON, "w") as f:
            json.dump(ref, f, indent=1)
            f.write("\n")
        print(REF_JSON)
        return
    import jax

    jax.config.update("jax_platforms", "cpu")
    export()


if __name__ == "__main__":
    main()
