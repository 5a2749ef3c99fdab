#!/usr/bin/env python
"""Reference numbers of the data-parallel DfDP step, from the JAX package on
an 8-device CPU mesh, for the PyTorch port's CPU test
(tests/test_torch_parallel.py).

Three ``make_sharded_dfdp_step`` steps (sdirt_tpu/parallel/steps.py) over a
('data', 'rays') mesh of 2 x 1 virtual CPU devices, from the shipped
Sdirt_best_acc1 at 128x192, bs 2 (one sample per device), lr 1e-4 (cosine
over the 3 steps), on the stored stacks of scripts/make_train_step_reference.py,
in float64 (the port is held to 1e-6 there). BatchNorm's batch moments
are reduced over the mesh by XLA, so the running statistics after the three
steps are kept beside the losses:

  sdirt_tpu_torch/reference/dp_step_jax_cpu.json     losses, tolerance
  sdirt_tpu_torch/reference/dp_step_batch_stats.npz  running statistics

Usage (about a minute on 8 CPU cores):
  JAX_PLATFORMS=cpu python scripts/make_dp_step_reference.py
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# the virtual devices must exist before JAX initialises its CPU backend
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")

import numpy as np

REF_DIR = os.path.join(ROOT, "sdirt_tpu_torch", "reference")
OUT = os.path.join(REF_DIR, "dp_step_jax_cpu.json")
STATS = os.path.join(REF_DIR, "dp_step_batch_stats.npz")
STACKS = os.path.join(REF_DIR, "train_step_stacks.npz")
WEIGHTS = "sdirt_tpu_torch/weights/rf50mm/Sdirt_best_acc1.npz"
RES, BS, STEPS, LR, TOTAL, N_DATA = (128, 192), 2, 3, 1e-4, 3, 2
RTOL = 1e-6


def sharded_steps(stacks, depths):
    import flax
    import jax
    import jax.numpy as jnp

    from sdirt_tpu.dfdp.train import create_dfdp_state
    from sdirt_tpu.parallel.mesh import make_mesh
    from sdirt_tpu.parallel.steps import make_sharded_dfdp_step

    state, _ = create_dfdp_state(jax.random.PRNGKey(0), LR, TOTAL, (1, 6, *RES))
    with np.load(os.path.join(ROOT, WEIGHTS)) as z:
        tree = flax.traverse_util.unflatten_dict({k: z[k] for k in z.files}, sep="/")
    tree = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)
    state = state.replace(params=tree["params"], batch_stats=tree["batch_stats"],
                          opt_state=state.tx.init(tree["params"]))
    mesh = make_mesh(n_data=N_DATA, devices=jax.devices()[:N_DATA])
    step = make_sharded_dfdp_step(mesh)
    losses = []
    for stack, depth in zip(stacks, depths):
        state, out = step(state, jnp.asarray(stack.astype(np.float64) / 65535),
                          jnp.asarray(depth.astype(np.float64)))
        losses.append(float(out["total"]))
    stats = flax.traverse_util.flatten_dict(jax.device_get(state.batch_stats), sep="/")
    return losses, {k: np.asarray(v, np.float64) for k, v in stats.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--stats-out", default=STATS)
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    with np.load(STACKS) as z:
        stacks, depths = z["stacks"], z["depths"]
    with jax.enable_x64(True):
        losses, stats = sharded_steps(stacks, depths)
    out = {
        "what": "3 x sdirt_tpu/parallel/steps.py:make_sharded_dfdp_step over a "
                f"({N_DATA}, 1) CPU mesh from the shipped Sdirt_best_acc1, bs {BS}, "
                "on the stored stacks of make_train_step_reference.py, float64",
        "weights": WEIGHTS, "stacks": os.path.relpath(STACKS, ROOT),
        "res": list(RES), "bs": BS, "n_data": N_DATA, "steps": STEPS, "lr": LR,
        "total_steps": TOTAL, "dtype": "float64", "backend": jax.default_backend(),
        "jax": jax.__version__, "losses": losses, "rtol": RTOL,
        "batch_stats": os.path.relpath(args.stats_out, ROOT),
        "command": "JAX_PLATFORMS=cpu python scripts/make_dp_step_reference.py",
    }
    np.savez_compressed(args.stats_out, **stats)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({"losses": losses}))


if __name__ == "__main__":
    main()
