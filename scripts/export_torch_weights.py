#!/usr/bin/env python
"""Export the shipped orbax checkpoints that the PyTorch port loads to
``.npz`` files, and turn the JAX package's ``--stage sample`` log into the
port's reference numbers.

The port (``sdirt_tpu_torch``) runs on a machine with neither JAX nor orbax,
so the trees are restored here, on the CPU, with the JAX package's own
loaders and written as flat float32 trees (``"params/Dense_0/kernel"``,
``"batch_stats/.../mean"``, ...), ``ckpt/<lens>/<name>`` ->
``sdirt_tpu_torch/weights/<lens>/<name>.npz``, for each of EXPORTS: the
surrogates and depth nets of configs/dfdp_by_sdirt_{rf50mm,rf35mm}.yml,
both lenses' promoted basis students (ckpt/*/PROMOTED_SURROGATE.json), the
far-field A/B's F/1.8 ks-35 surrogate and its two depth nets
(configs/dfdp_f{4,18}_farfield_256.yml), the 256-wide F/4 surrogates (the
second view of a multi-focus stack; on rf35mm the warm start of a basis
student and the student that gate_rf35_student gates by default) and the
deblur demo net with its Mydeblur head. Only the inference leaves are written: parameters and
BatchNorm statistics.

``psfnet_init_tree`` gives a seeded Flax initialisation of any surrogate
architecture (``mlpconv``, ``siren``, ``mlp+lum``, ...) in the same
layout, for nets the repository ships no checkpoint of (the port's tests
load it into the port's modules).

Usage:
  JAX_PLATFORMS=cpu python scripts/export_torch_weights.py
  JAX_PLATFORMS=cpu SDIRT_RENDER_VARIANT=scan \\
      python apps/dfdp_net.py --stage sample [--config CFG] > stage_sample.log 2>&1
  python scripts/export_torch_weights.py --reference-log stage_sample.log [--config CFG]
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

WEIGHTS_DIR = os.path.join(ROOT, "sdirt_tpu_torch", "weights")
REF_DIR = os.path.join(ROOT, "sdirt_tpu_torch", "reference")
REF_JSON = os.path.join(REF_DIR, "stage_sample_jax_cpu.json")
DEFAULT_CONFIG = "configs/dfdp_by_sdirt_rf50mm.yml"
EXPORTS = (("rf50mm", "F4_PSFNet_mlp"), ("rf50mm", "Sdirt_best_acc1"),
           ("rf50mm", "F4_PSFNet_mlpb@256x48"), ("rf35mm", "F4_PSFNet_mlp"),
           ("rf35mm", "F4_PSFNet_mlpb@256x48"), ("rf35mm", "Sdirt_best_acc1"),
           ("rf50mm", "F18_PSFNet_mlp_ks35"), ("rf50mm", "F4_PSFNet_mlp@256"),
           ("rf50mm", "Sdirt_f4_farfield"), ("rf50mm", "Sdirt_f18_farfield"),
           ("rf50mm", "Sdirt_deblur_demo_cpu"), ("rf35mm", "F4_PSFNet_mlp@256"))
# depth nets with the Mydeblur head (Basenet(train_mode="deblur"))
DEBLUR_NETS = ("Sdirt_deblur_demo_cpu",)


def _flat(tree, prefix):
    import flax

    flat = flax.traverse_util.flatten_dict(tree, sep="/")
    return {f"{prefix}/{k}": np.asarray(v, np.float32) for k, v in flat.items()}


def psfnet_arch(name: str):
    """(model name, ks) of a surrogate checkpoint named
    ``<prefix>_PSFNet_<model>[_ks<ks>]`` (ks 21 when the name has none)."""
    model = name.split("PSFNet_")[1]
    model, _, ks = model.partition("_ks")
    return model, int(ks or 21)


def psfnet_tree(lens="rf50mm", name="F4_PSFNet_mlp"):
    """A PSF surrogate ``ckpt/<lens>/<name>`` (architecture and ks from the
    name, psfnet_arch), restored by PSFNetLens.load_net."""
    from sdirt_tpu.psfnet.surrogate import PSFNetLens

    model, ks = psfnet_arch(name)
    surrogate = PSFNetLens(os.path.join(ROOT, f"lenses/{lens}/lens_web.json"),
                           model_name=model, sensor_res=(512, 768),
                           kernel_size=ks)
    surrogate.load_net(os.path.join(ROOT, "ckpt", lens, name))
    return _flat(surrogate.params["params"], "params")


def psfnet_init_tree(model: str, ks: int, seed: int = 0):
    """A surrogate architecture's Flax initialisation under PRNGKey(seed),
    flat, as the port's load_state takes it."""
    import jax
    import jax.numpy as jnp

    from sdirt_tpu.psfnet.arch import build_psfnet

    params = build_psfnet(model, ks).init(jax.random.PRNGKey(seed),
                                          jnp.zeros((1, 3), jnp.float32))
    return _flat(params["params"], "params")


def depthnet_tree(lens="rf50mm", name="Sdirt_best_acc1"):
    """A shipped DDDNet ``ckpt/<lens>/<name>`` (with the Mydeblur head for
    DEBLUR_NETS), restored by restore_inference_ckpt against an abstract
    template of the net at 128x192 (the smallest input the two-scale SPP of
    the feature tower accepts; parameter shapes do not depend on it)."""
    import jax
    import jax.numpy as jnp

    from sdirt_tpu.dfdp.basenet import Basenet
    from sdirt_tpu.utils.checkpoint import restore_inference_ckpt

    dev = jax.sharding.SingleDeviceSharding(jax.devices()[0])
    mode = "deblur" if name in DEBLUR_NETS else "dfdp"
    shapes = jax.eval_shape(lambda: Basenet(train_mode=mode).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 6, 128, 192)), train=False))
    abstract = jax.tree.map(
        lambda s: jax.ShapeDtypeStruct(s.shape, s.dtype, sharding=dev), shapes)
    params, stats = restore_inference_ckpt(os.path.join(ROOT, "ckpt", lens,
                                                        name),
                                           abstract["params"],
                                           abstract["batch_stats"])
    return {**_flat(params, "params"), **_flat(stats, "batch_stats")}


def tree(lens, name):
    return (depthnet_tree(lens, name) if name.startswith("Sdirt")
            else psfnet_tree(lens, name))


def export(weights_dir=WEIGHTS_DIR, exports=EXPORTS):
    paths = {}
    for lens, name in exports:
        t = tree(lens, name)
        os.makedirs(os.path.join(weights_dir, lens), exist_ok=True)
        path = os.path.join(weights_dir, lens, f"{name}.npz")
        np.savez(path, **t)
        paths[lens, name] = path
        print(f"{path}: {len(t)} arrays, "
              f"{sum(v.size for v in t.values())} float32 values")
    return paths


_FLAT_ROW = re.compile(r"\[idx, depth \(mm\), psnr_l, psnr_r, ssim_l, ssim_r"
                       r".*\] : (\[.*\])")
_DEPTH_SET = re.compile(r"Test Depth Est on (\w+)Sample")
_MSE_MAE = re.compile(r"Avg_mse/mae\(\d+\): ([-\d.e]+), ([-\d.e]+)")
_ACC = re.compile(r"Avg_acc_est\(\d+\): ([-\d.e]+), ([-\d.e]+), ([-\d.e]+)")


def parse_stage_sample_log(text: str, config: str = DEFAULT_CONFIG) -> dict:
    """The per-scene flat-capture scores (PSNR, SSIM, perceptual distance)
    and the per-set depth metrics that apps/dfdp_net.py --stage sample
    logs."""
    flat, depth, current = [], {}, None
    for line in text.splitlines():
        if m := _FLAT_ROW.search(line):
            row = ast.literal_eval(m.group(1))
            flat.append(dict(zip(("idx", "distance_mm", "psnr_l", "psnr_r",
                                  "ssim_l", "ssim_r", "perc_l", "perc_r"), row)))
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
    command = ("JAX_PLATFORMS=cpu SDIRT_RENDER_VARIANT=scan "
               "python apps/dfdp_net.py --stage sample")
    if config != DEFAULT_CONFIG:
        command += f" --config {config}"
    return {
        "command": command,
        "config": config,
        "flat": flat,
        "depth": depth,
    }


def reference_json(config: str) -> str:
    """Where the reference of a config's --stage sample run is kept."""
    if config == DEFAULT_CONFIG:
        return REF_JSON
    lens = re.search(r"rf\d+mm", config).group(0)
    return os.path.join(REF_DIR, f"stage_sample_{lens}_jax_cpu.json")


def main():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--reference-log",
                    help="write the reference JSON from this --stage sample "
                         "log instead of exporting weights")
    ap.add_argument("--config", default=DEFAULT_CONFIG,
                    help="the config the --stage sample run was given")
    args = ap.parse_args()
    if args.reference_log:
        with open(args.reference_log) as f:
            ref = parse_stage_sample_log(f.read(), args.config)
        path = reference_json(args.config)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(ref, f, indent=1)
            f.write("\n")
        print(path)
        return
    import jax

    jax.config.update("jax_platforms", "cpu")
    export()


if __name__ == "__main__":
    main()
