#!/usr/bin/env python
"""Reference numbers of the deblur head (``--train-mode deblur``), from the
JAX package on the CPU, for the PyTorch port's checks (chip_smoke.py
phase 16, tests/test_torch_deblur.py).

  stage_sample_deblur_jax_cpu.json   the depth part of ``apps/dfdp_net.py
      --stage sample --train-mode deblur`` on a copy of
      configs/dfdp_synthetic_train_128_deblur_cpu.yml that names the
      shipped deblur net (``train.dfdpnet_pretrained:
      ./ckpt/rf50mm/Sdirt_deblur_demo_cpu``; the shipped config names
      none): per real sample set, the depth metrics of the depth net and
      acc1..3 of the refined depth (the JAX app accumulates these but does
      not log them, so this script runs its loop itself:
      ``dfdp_infer(..., train_mode="deblur")`` into ``ResultsMonitor``).
  train_step_deblur_jax_cpu.json     three deblur ``dfdp_train_step``s of
      Sdirt_deblur_demo_cpu at 128x192, bs 2, lr 1e-4 (cosine over the 3
      steps) in float64, on the stored renders of train_step_stacks.npz
      (scripts/make_train_step_reference.py) with their all-in-focus
      images, SyntheticRGBD(style="v5", seed=0) items 0-5 (OpenCV without
      IPP) as the JAX app uploads them (uint8), stored in
      train_step_deblur_aif.npz.

Usage:
  JAX_PLATFORMS=cpu python scripts/make_deblur_reference.py
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import numpy as np

REF_DIR = os.path.join(ROOT, "sdirt_tpu_torch", "reference")
CONFIG = "configs/dfdp_synthetic_train_128_deblur_cpu.yml"
NET = "./ckpt/rf50mm/Sdirt_deblur_demo_cpu"
WEIGHTS = "sdirt_tpu_torch/weights/rf50mm/Sdirt_deblur_demo_cpu.npz"
SAMPLE_JSON = os.path.join(REF_DIR, "stage_sample_deblur_jax_cpu.json")
STEP_JSON = os.path.join(REF_DIR, "train_step_deblur_jax_cpu.json")
STACKS = os.path.join(REF_DIR, "train_step_stacks.npz")
AIF = os.path.join(REF_DIR, "train_step_deblur_aif.npz")
RES, BS, STEPS, LR, TOTAL = (128, 192), 2, 3, 1e-4, 3
# the port's float32 CPU steps on the stored stacks (tests/test_torch_deblur.py)
# and the card's cuDNN algorithms: as train_step_jax_cpu.json
STORED_RTOL = 1e-3


def stage_sample_deblur() -> dict:
    """Depth and refined-depth metrics of the shipped deblur net on the
    config's real sample sets, as the JAX app's test_depth computes them."""
    import jax

    from make_farfield_reference import with_depth_net
    from sdirt_tpu.dfdp.datasets import DataLoader
    from sdirt_tpu.dfdp.factory import get_depth_sample_set
    from sdirt_tpu.dfdp.monitor import ResultsMonitor
    from sdirt_tpu.dfdp.train import create_dfdp_state, dfdp_infer
    from sdirt_tpu.utils.checkpoint import restore_inference_ckpt
    import yaml

    old = os.getcwd()
    os.chdir(ROOT)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            with open(with_depth_net(CONFIG, NET, tmp)) as f:
                args = yaml.safe_load(f)
        args["res"] = tuple(args["res"])
        state, _ = create_dfdp_state(jax.random.PRNGKey(0), float(args["lr"]), 1,
                                     (1, 6, *args["res"]), "deblur")
        params, stats = restore_inference_ckpt(NET, state.params,
                                               state.batch_stats)
        out = {}
        for tag, ds in zip(("box", "f2d", "casual"), get_depth_sample_set(args)):
            monitor = ResultsMonitor("deblur")
            for imgs, gt_depth in DataLoader(ds, batch_size=1, num_workers=2):
                pred, fix, aif = dfdp_infer(params, stats, imgs,
                                            train_mode="deblur")
                monitor.set_outputs({"gt_depth": gt_depth, "gt_aif": None,
                                     "pred_depth_est": np.asarray(pred),
                                     "pred_depth_fix": np.asarray(fix),
                                     "pred_aif": np.asarray(aif)})
                monitor.compute_metrics()
            n = len(ds)
            out[tag] = monitor.metric_dict(n)
            for k in (1, 2, 3):
                out[tag][f"acc{k}_fix"] = getattr(monitor,
                                                  f"Avg_accuracy_{k}_fix") / n
            out[tag] = {k: float(v) for k, v in out[tag].items()}
    finally:
        os.chdir(old)
    return {"what": "depth part of apps/dfdp_net.py --stage sample "
                    "--train-mode deblur (scored as its test_depth scores it)",
            "config": CONFIG, "dfdpnet_pretrained": NET,
            "command": "JAX_PLATFORMS=cpu python scripts/make_deblur_reference.py",
            "depth": out}


def aif_images() -> np.ndarray:
    """uint8 [STEPS, BS, 3, H, W]: the scenes of train_step_stacks.npz."""
    import cv2

    from sdirt_tpu.dfdp.datasets import SyntheticRGBD

    cv2.ipp.setUseIPP(False)
    ds = SyntheticRGBD(RES, style="v5", seed=0)
    aif = np.stack([ds[i][0] for i in range(BS * STEPS)])
    aif = (aif * 255.0 + 0.5).astype(np.uint8)
    return aif.reshape(STEPS, BS, *aif.shape[1:])


def train_losses(stacks, depths, aifs, dtype):
    import flax
    import jax
    import jax.numpy as jnp

    from sdirt_tpu.dfdp.train import create_dfdp_state, dfdp_train_step

    state, _ = create_dfdp_state(jax.random.PRNGKey(0), LR, TOTAL, (1, 6, *RES),
                                 "deblur")
    with np.load(os.path.join(ROOT, WEIGHTS)) as z:
        tree = flax.traverse_util.unflatten_dict({k: z[k] for k in z.files}, sep="/")
    tree = jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)
    state = state.replace(params=tree["params"], batch_stats=tree["batch_stats"],
                          opt_state=state.tx.init(tree["params"]))
    losses = []
    for stack, depth, aif in zip(stacks, depths, aifs):
        state, out = dfdp_train_step(
            state, jnp.asarray(stack.astype(np.float64) / 65535, dtype),
            jnp.asarray(depth.astype(np.float64), dtype),
            gt_aif=jnp.asarray(aif.astype(np.float64) / 255.0, dtype),
            train_mode="deblur")
        losses.append({k: float(v) for k, v in out.items()})
    return losses


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--only", choices=("sample", "train"))
    args = ap.parse_args(argv)
    import jax

    jax.config.update("jax_platforms", "cpu")
    if args.only in (None, "sample"):
        ref = stage_sample_deblur()
        with open(SAMPLE_JSON, "w") as f:
            json.dump(ref, f, indent=1)
            f.write("\n")
        print(SAMPLE_JSON, json.dumps(ref["depth"]))
    if args.only in (None, "train"):
        with np.load(STACKS) as z:
            stacks, depths = z["stacks"], z["depths"]
        aifs = aif_images()
        with jax.enable_x64(True):
            losses = train_losses(stacks, depths, aifs, np.float64)
        out = {"what": "3 x sdirt_tpu/dfdp/train.py:dfdp_train_step "
                       "(train_mode='deblur') from Sdirt_deblur_demo_cpu, bs 2, "
                       "on the stored stacks of train_step_stacks.npz with "
                       "their all-in-focus images (uint8 / 255)",
               "weights": WEIGHTS, "res": list(RES), "bs": BS, "steps": STEPS,
               "lr": LR, "total_steps": TOTAL, "dtype": "float64",
               "jax": jax.__version__, "losses": losses,
               "stored_stacks_rtol": STORED_RTOL,
               "stacks": os.path.relpath(STACKS, ROOT),
               "aif": os.path.relpath(AIF, ROOT),
               "command": "JAX_PLATFORMS=cpu python scripts/make_deblur_reference.py"}
        np.savez_compressed(AIF, aif=aifs)
        with open(STEP_JSON, "w") as f:
            json.dump(out, f, indent=1)
            f.write("\n")
        print(STEP_JSON, json.dumps(losses))


if __name__ == "__main__":
    main()
