"""The port's leave-one-scene-out fine-tuning
(sdirt_tpu_torch/finetune_real_loo.py) against the JAX script
(scripts/finetune_real_loo.py): two fine-tune steps of the shipped net in
float64 within 1e-3 relative of the JAX package's float64 losses (the
train-step rule: the JAX float32 CPU run is itself farther off), and the
entry point on the CPU.
"""

import argparse
import importlib.util
import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import torch

from sdirt_tpu_torch import finetune_real_loo
from sdirt_tpu_torch.dfdp.basenet import build_basenet
from sdirt_tpu_torch.utils.weights import load_npz

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "sdirt_tpu_torch", "weights", "rf50mm", "Sdirt_best_acc1.npz")
FINETUNE_RTOL = 1e-3


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_finetune_steps_match_jax_float64(monkeypatch):
    """Two fine-tune steps of the shipped net at 128x192, batch 2, on four
    real scenes, both packages in float64."""
    from sdirt_tpu.dfdp import train as JT

    jax_mod = _script("finetune_real_loo")
    monkeypatch.chdir(ROOT)
    scenes = finetune_real_loo.load_all_scenes((128, 192))[:4]
    args = argparse.Namespace(res=(128, 192), steps=2, lr=2e-5, batch=2)

    got_net, got = finetune_real_loo.finetune(
        build_basenet(WEIGHTS, device="cpu").double(), scenes, args, seed=3)
    assert next(got_net.parameters()).dtype == torch.float64

    ref = []
    create, step = JT.create_dfdp_state, JT.dfdp_train_step
    monkeypatch.setattr(JT, "create_dfdp_state",
                        lambda *a, **k: (jax.jit(lambda: create(*a, **k)[0])(), None))

    def recording_step(state, *a, **k):
        state, losses = step(state, *a, **k)
        ref.append(float(losses["total"]))
        return state, losses

    monkeypatch.setattr(JT, "dfdp_train_step", recording_step)
    tree = flax.traverse_util.unflatten_dict(load_npz(WEIGHTS), sep="/")
    with jax.enable_x64(True):
        t64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)
        jax_mod.finetune(t64["params"], t64["batch_stats"], scenes, args, seed=3)
    assert len(ref) == len(got) == 2
    np.testing.assert_allclose(got, ref, rtol=FINETUNE_RTOL, atol=0)


def test_finetune_main_runs(tmp_path, monkeypatch):
    """One held-out fold of one step, and --save-all-ckpt under --out. At
    128x192 the captures are resized, and a gamma draw on the bicubic
    overshoot below 0 may make a loss NaN, as in the JAX script
    (tests/test_torch_depth_tools.py::test_hflip_and_augment_equal): the
    fold's loss is held to the direct fine-tune's, NaN or not."""
    monkeypatch.chdir(ROOT)
    argv = ["--ckpt", "ckpt/rf50mm/Sdirt_best_acc1", "--res", "128", "192",
            "--steps", "1", "--sets", "f2d", "--holdout-set"]
    out = finetune_real_loo.main([*argv, "--save-all-ckpt", "all_scenes",
                                  "--out", str(tmp_path), "--device", "cpu"])
    assert set(out["summary"]) == {"f2d"} and len(out["fold_losses"]) == 1
    assert set(out["held_out"]) == {5, 6} and len(out["zero_shot"]) == 19
    scenes = finetune_real_loo.load_all_scenes((128, 192))
    train = [s for i, s in enumerate(scenes) if s[0] != "f2d"]
    _, losses = finetune_real_loo.finetune(
        build_basenet(WEIGHTS, device="cpu"), train,
        argparse.Namespace(steps=1, lr=2e-5, batch=2), seed=5)
    np.testing.assert_array_equal(out["fold_losses"][0], losses)
    assert out["saved"] == str(tmp_path / "all_scenes.npz")
    build_basenet(out["saved"], device="cpu")
