#!/usr/bin/env python
"""Reference numbers of the DfDP train step, from the JAX package on the
CPU, for the PyTorch port's check on the card (chip_smoke.py).

Three ``dfdp_train_step``s of the shipped Sdirt_best_acc1 at 128x192, bs 2,
lr 1e-4 (cosine over the 3 steps), on noise-free renders of
``SyntheticRGBD(style="v5", seed=0)`` items 0-5, rendered as the JAX app's
``_render_batch`` renders them (uint8 image, f16 depth) with the ``scan``
variant through the shipped rf50mm surrogate of
``configs/dfdp_synthetic_smoke.yml``. OpenCV runs without IPP, so the
scenes equal the port's (tests/test_torch_synthetic.py). The rendered
stacks are stored as 16-bit fixed point and the steps are taken on the
stored values, in float64 (the JAX package's float32 CPU run is itself
3e-4 off the float64 loss; its losses are kept for information):

  sdirt_tpu_torch/reference/train_step_jax_cpu.json    losses, tolerances
  sdirt_tpu_torch/reference/train_step_stacks.npz      stacks, depths

The card is held to the losses twice: training on the stored stacks
(``stored_stacks_rtol``) and on its own ``fused`` render of the same scenes
(``own_render_rtol``). Both tolerances come from the CPU port's measured
gaps (tests/test_torch_train.py).

Usage:
  JAX_PLATFORMS=cpu python scripts/make_train_step_reference.py
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np

REF_DIR = os.path.join(ROOT, "sdirt_tpu_torch", "reference")
OUT = os.path.join(REF_DIR, "train_step_jax_cpu.json")
STACKS = os.path.join(REF_DIR, "train_step_stacks.npz")
CONFIG = "configs/dfdp_synthetic_smoke.yml"
WEIGHTS = "sdirt_tpu_torch/weights/rf50mm/Sdirt_best_acc1.npz"
RES, BS, STEPS, LR, TOTAL = (128, 192), 2, 3, 1e-4, 3
# the port's float32 CPU steps on the stored stacks: up to 2.2e-4 (losses);
# the card's cuDNN picks other convolution algorithms, so about 5x that
STORED_RTOL = 1e-3
# the port's float32 CPU steps on its own fused render: up to 2.3% (the
# bf16 PSF network rounds differently, and the depth net reads sub-pixel
# DP disparities); 3x that
OWN_RENDER_RTOL = 0.07


def _jax_app():
    spec = importlib.util.spec_from_file_location(
        "jax_dfdp_net", os.path.join(ROOT, "apps", "dfdp_net.py"))
    app = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(app)
    return app


def render_stacks():
    """(stacks uint16 [STEPS, BS, 6, H, W], depths f16 [STEPS, BS, 1, H, W])."""
    import cv2
    import jax

    from sdirt_tpu.dfdp import factory
    from sdirt_tpu.dfdp.datasets import SyntheticRGBD

    cv2.ipp.setUseIPP(False)
    app = _jax_app()
    args = app.config(os.path.join(ROOT, CONFIG))
    for side in ("train", "test"):
        for k in ("lens", "psfnet_path"):
            args[side][k] = os.path.normpath(os.path.join(ROOT, args[side][k]))
    lens, _ = factory.get_lens(args)
    ds = SyntheticRGBD(RES, style="v5", seed=0)
    items = [ds[i] for i in range(BS * STEPS)]
    stacks, depths = [], []
    for k in range(STEPS):
        aif = np.stack([items[BS * k + j][0] for j in range(BS)])
        depth = np.stack([items[BS * k + j][1] for j in range(BS)])
        stack = np.asarray(app._render_batch(lens, aif, depth,
                                             jax.random.PRNGKey(0))[0])
        stacks.append(np.round(np.clip(stack, 0, 1) * 65535).astype(np.uint16))
        depths.append(depth.astype(np.float16))
    return np.stack(stacks), np.stack(depths)


def train_losses(stacks, depths, dtype):
    import flax
    import jax
    import jax.numpy as jnp

    from sdirt_tpu.dfdp.train import create_dfdp_state, dfdp_train_step

    state, _ = create_dfdp_state(jax.random.PRNGKey(0), LR, TOTAL, (1, 6, *RES))
    with np.load(os.path.join(ROOT, WEIGHTS)) as z:
        tree = flax.traverse_util.unflatten_dict({k: z[k] for k in z.files}, sep="/")
    tree = jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)
    state = state.replace(params=tree["params"], batch_stats=tree["batch_stats"],
                          opt_state=state.tx.init(tree["params"]))
    losses = []
    for stack, depth in zip(stacks, depths):
        state, out = dfdp_train_step(
            state, jnp.asarray(stack.astype(np.float64) / 65535, dtype),
            jnp.asarray(depth.astype(np.float64), dtype))
        losses.append(float(out["total"]))
    return losses


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--stacks-out", default=STACKS)
    args = ap.parse_args(argv)

    os.environ["SDIRT_RENDER_VARIANT"] = "scan"
    import jax

    jax.config.update("jax_platforms", "cpu")
    stacks, depths = render_stacks()
    with jax.enable_x64(True):
        losses = train_losses(stacks, depths, np.float64)
    losses_f32 = train_losses(stacks, depths, np.float32)
    out = {
        "what": "3 x sdirt_tpu/dfdp/train.py:dfdp_train_step from the shipped "
                "Sdirt_best_acc1, bs 2, on noise-free scan renders of "
                "SyntheticRGBD(style='v5', seed=0) items 0-5 (OpenCV without "
                "IPP), stacks stored as uint16 / 65535",
        "config": CONFIG, "weights": WEIGHTS, "res": list(RES), "bs": BS,
        "steps": STEPS, "lr": LR, "total_steps": TOTAL, "dtype": "float64",
        "backend": jax.default_backend(), "jax": jax.__version__,
        "losses": losses, "losses_jax_float32": losses_f32,
        "stored_stacks_rtol": STORED_RTOL, "own_render_rtol": OWN_RENDER_RTOL,
        "stacks": os.path.relpath(args.stacks_out, ROOT),
        "command": "JAX_PLATFORMS=cpu python scripts/make_train_step_reference.py",
    }
    np.savez_compressed(args.stacks_out, stacks=stacks, depths=depths)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: out[k] for k in ("losses", "losses_jax_float32")}))


if __name__ == "__main__":
    main()
