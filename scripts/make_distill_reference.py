#!/usr/bin/env python
"""Reference numbers of the basis-student distillation, from the JAX package
on the CPU, for the PyTorch port's tests and its check on the card
(tests/test_torch_distill.py, chip_smoke.py).

1. Three steps of scripts/distill_basis_student.py's ``distill_step`` at the
   promoted shape on explicit queries, in float64: rf50mm, teacher ``mlp``
   (ckpt/rf50mm/F4_PSFNet_mlp), student ``mlpb@256x48`` with its trunk
   warm-started from ckpt/rf50mm/F4_PSFNet_mlp@256 (PSFNetLens.load_net's
   partial load), bs 8192, AdamW on cosine_annealing(5e-5, ITERS // 3). The
   queries are drawn here with numpy and stored, and so are the student's
   leaves the warm start does not fill (drawn by Flax's initialiser, which
   torch cannot repeat); the losses, the norm of every leaf's change over
   the three steps and the leaves the warm start loaded are kept.
2. The promoted rf50mm student's truth eval (scripts/probe_teacher_l1.py:
   make_eval_fn, 1024 points x 65536 rays) under three keys, with 5x their
   spread as the tolerance (the rule of fit_psfnet_jax_cpu.json).

  sdirt_tpu_torch/reference/distill_jax_cpu.json   losses, leaves, evals
  sdirt_tpu_torch/reference/distill_queries.npz    queries [3, 8192, 3],
                                                   the student's other leaves

Usage (about 3 minutes on 8 CPU cores):
  JAX_PLATFORMS=cpu python scripts/make_distill_reference.py
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

REF_DIR = os.path.join(ROOT, "sdirt_tpu_torch", "reference")
OUT = os.path.join(REF_DIR, "distill_jax_cpu.json")
QUERIES = os.path.join(REF_DIR, "distill_queries.npz")
LENS = "lenses/rf50mm/lens_web.json"
TEACHER, TEACHER_CKPT = "mlp", "ckpt/rf50mm/F4_PSFNet_mlp"
STUDENT, WARM = "mlpb@256x48", "ckpt/rf50mm/F4_PSFNet_mlp@256"
PROMOTED = "ckpt/rf50mm/F4_PSFNet_mlpb@256x48"
BS, STEPS, LR, ITERS, KS, SEED = 8192, 3, 5e-5, 200, 21, 20261017
KEYS = (0, 1, 2)
TOL_SPREADS = 5.0


def lens(model):
    from sdirt_tpu.psfnet.surrogate import PSFNetLens

    return PSFNetLens(os.path.join(ROOT, LENS), model_name=model,
                      kernel_size=KS, sensor_res=(512, 768))


def queries(foc_z_arr, d_min, d_max):
    """STEPS batches of sample_training_points's distribution, from numpy:
    a focus index, x, y uniform on [-1, 1), z piecewise-Gaussian around it
    (float32 throughout). Returns [STEPS, BS, 3]."""
    rng = np.random.default_rng(SEED)
    out = []
    for _ in range(STEPS):
        foc_z = np.float32(foc_z_arr[rng.integers(0, len(foc_z_arr))])
        x = ((rng.random(BS, np.float32) - np.float32(0.5)) * np.float32(2))
        y = ((rng.random(BS, np.float32) - np.float32(0.5)) * np.float32(2))
        g = np.clip(rng.standard_normal(BS, np.float32), -3, 3).astype(np.float32)
        z = np.where(g > 0, (1 - foc_z) * g / np.float32(3) + foc_z,
                     foc_z * g / np.float32(3) + foc_z).astype(np.float32)
        out.append(np.stack([x, y, z], -1))
    return np.stack(out)


def distill_steps(inp_all):
    import flax
    import jax
    import jax.numpy as jnp
    import optax

    from sdirt_tpu.psfnet.train import cosine_annealing

    teacher = lens(TEACHER)
    teacher.load_net(os.path.join(ROOT, TEACHER_CKPT))
    student = lens(STUDENT)
    before = flax.traverse_util.flatten_dict(student.params, sep="/")
    warm = lens("mlp@256")
    warm.load_net(os.path.join(ROOT, WARM))
    stored = flax.traverse_util.flatten_dict(warm.params, sep="/")
    student.load_net(os.path.join(ROOT, WARM))
    after = flax.traverse_util.flatten_dict(student.params, sep="/")
    loaded = sorted(k for k in after if k in stored
                    and stored[k].shape == after[k].shape
                    and np.array_equal(np.asarray(after[k]), np.asarray(stored[k]))
                    and not np.array_equal(np.asarray(before[k]), np.asarray(after[k])))

    f64 = lambda tree: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)
    t_params, params = f64(teacher.params), f64(student.params)
    t_apply, s_apply = teacher.net.apply, student.net.apply
    tx = optax.adamw(cosine_annealing(LR, max(ITERS // 3, 1)))
    opt_state = tx.init(params)
    start = params
    losses = []
    for inp in inp_all:
        inp = jnp.asarray(inp, jnp.float64)
        gt = t_apply(t_params, inp)
        loss, grads = jax.value_and_grad(
            lambda p: jnp.mean((s_apply(p, inp) - gt) ** 2))(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        losses.append(float(loss))
    flat0 = flax.traverse_util.flatten_dict(start, sep="/")
    flat3 = flax.traverse_util.flatten_dict(params, sep="/")
    delta = {k: float(np.linalg.norm(np.asarray(flat3[k]) - np.asarray(flat0[k])))
             for k in flat3}
    rest = {f"init/{k}": np.asarray(after[k], np.float32) for k in after if k not in loaded}
    return losses, delta, loaded, len(after), rest


def promoted_evals():
    import jax

    from sdirt_tpu.dp.psf import lens_scalars
    from sdirt_tpu.psfnet.train import _trace_impl, make_eval_fn

    runs = {}
    for key in KEYS:
        net = lens(STUDENT)
        net.load_net(os.path.join(ROOT, PROMOTED))
        eval_fn = make_eval_fn(net, ks=KS)
        eta, skip = net.eta_arrays(0.589, True)
        t0 = time.perf_counter()
        l1, l2 = eval_fn(net.params, jax.random.PRNGKey(key), net.stack, eta,
                         skip, lens_scalars(net))
        runs[f"key{key}"] = {"l1": float(l1), "l2": float(l2),
                             "trace": _trace_impl(net)[0],
                             "seconds": time.perf_counter() - t0}
        print(key, runs[f"key{key}"], flush=True)
    stats = {}
    for k in ("l1", "l2"):
        vals = np.array([r[k] for r in runs.values()])
        spread = float(vals.max() - vals.min())
        stats[k] = {"mean": float(vals.mean()), "spread": spread,
                    "tolerance": TOL_SPREADS * spread}
    return runs, stats


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--queries-out", default=QUERIES)
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    probe = lens(STUDENT)
    inp = queries(np.asarray(probe.foc_z_arr, np.float32), probe.d_min, probe.d_max)
    with jax.enable_x64(True):
        losses, delta, loaded, n_leaves, rest = distill_steps(inp)
    print("losses", losses, flush=True)
    runs, stats = promoted_evals()
    out = {
        "what": "scripts/distill_basis_student.py's distill_step x 3 in float64 on "
                "explicit queries (rf50mm, teacher mlp, student mlpb@256x48 warm "
                "from mlp@256); the promoted student's make_eval_fn L1/L2 under "
                "three keys",
        "lens": LENS, "teacher": [TEACHER, TEACHER_CKPT], "student": STUDENT,
        "warm": WARM, "promoted": PROMOTED, "bs": BS, "steps": STEPS, "lr": LR,
        "iters": ITERS, "ks": KS, "query_seed": SEED, "dtype": "float64",
        "backend": jax.default_backend(), "jax": jax.__version__,
        "losses": losses, "delta_norms": delta, "warm_loaded": loaded,
        "warm_leaves": n_leaves, "eval_keys": list(KEYS), "eval_runs": runs,
        "eval_stats": stats, "tolerance_rule": f"{TOL_SPREADS}x spread "
        "(max - min over the keys)",
        "queries": os.path.relpath(args.queries_out, ROOT),
        "command": "JAX_PLATFORMS=cpu python scripts/make_distill_reference.py",
    }
    np.savez(args.queries_out, inp=inp, **rest)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({"losses": losses, "eval_stats": stats}))


if __name__ == "__main__":
    main()
