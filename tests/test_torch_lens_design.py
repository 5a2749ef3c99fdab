"""The port's lens design (optics/optimize.py, demo_lens_design.py) and the
lens methods it stands on (prune_surf) against the JAX package on the CPU,
on both lenses.

Tolerances: perturb_stack on the same draws bit-equal; the learning-rate
scales equal; three LensAdam steps in float64 within 1e-10 relative of
optax; prune_surf and correct_shape radii within 1e-5 mm; the demo's RMS
tables on the JAX draws within 0.02 um (measured 5.5e-3 on the nominal
table: the per-surface traces differ by up to 8e-5 mm, ROADMAP.md §3).
"""

import contextlib
import importlib.util
import io
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sdirt_tpu.optics import optimize as jax_optimize
from sdirt_tpu.optics.lens import Lens as JLens
from sdirt_tpu.optics.surfaces import SurfaceStack as JStack
from sdirt_tpu_torch import demo_lens_design
from sdirt_tpu_torch.optics import optimize
from sdirt_tpu_torch.optics.lens import Lens

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRAWS = os.path.join(ROOT, "sdirt_tpu_torch", "reference", "lens_design_jax_cpu.npz")


def lens_path(name):
    return os.path.join(ROOT, "lenses", name, "lens_web.json")


@pytest.fixture(scope="module", params=("rf50mm", "rf35mm"))
def lenses(request):
    return (Lens(lens_path(request.param), sensor_res=(512, 768), device="cpu"),
            JLens(lens_path(request.param), sensor_res=(512, 768)))


def _np(stack):
    return {k: np.asarray(getattr(stack, k)) for k in ("c", "k", "ai", "d", "r", "kind")}


def test_perturb_stack_bit_equal(lenses):
    lens, jlens = lenses
    key = jax.random.PRNGKey(7)
    ref = jax_optimize.perturb_stack(jlens.stack, key, ratio=0.002, thickness_precision=0.002)
    keys = jax.random.split(key, 5)
    shapes = optimize.perturbation_shapes(lens.stack)
    draws = [np.asarray(jax.random.normal(k, sh)) for k, sh in zip(keys, shapes)]
    got = optimize.perturb_stack(lens.stack, ratio=0.002, thickness_precision=0.002,
                                 draws=draws)
    for k, v in _np(ref).items():
        np.testing.assert_array_equal(getattr(got, k).numpy(), v, err_msg=k)
    gen = torch.Generator().manual_seed(0)
    assert optimize.perturb_stack(lens.stack, gen).c.shape == lens.stack.c.shape


def test_param_labels_equal(lenses):
    lens, jlens = lenses
    ref = jax_optimize.surface_param_labels(jlens.stack, aper_idx=jlens.aper_idx)
    got = optimize.surface_param_labels(lens.stack, aper_idx=lens.aper_idx)
    for k in ("c", "k", "d", "ai"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)


def test_three_adam_steps_float64_match_optax(lenses):
    """LensAdam against optax.chain(scale_by_adam, per-leaf scale,
    scale(-lr)) on a quadratic loss whose gradients both packages compute
    exactly alike, in float64, with the demo's scales."""
    lens, jlens = lenses
    rng = np.random.default_rng(0)
    p0 = {k: np.asarray(getattr(jlens.stack, k), np.float64) for k in ("c", "k", "d", "ai")}
    target = {k: v * (1 + 1e-3 * rng.standard_normal(v.shape)) for k, v in p0.items()}
    weight = {k: rng.uniform(0.5, 2.0, v.shape) for k, v in p0.items()}
    labels = jax_optimize.surface_param_labels(jlens.stack, aper_idx=jlens.aper_idx)
    with jax.enable_x64(True):
        params = {k: jnp.asarray(v) for k, v in p0.items()}
        scales = {k: (np.asarray(labels[k]) > 0) * 2e-4 * np.abs(p0[k]) for k in p0}
        tx = jax_optimize.make_lens_optimizer({k: jnp.asarray(v) for k, v in scales.items()},
                                              base_lr=1.0)
        state = tx.init(params)
        loss = lambda p: sum(jnp.sum(weight[k] * (p[k] - target[k]) ** 2) for k in p)
        ref = []
        for _ in range(3):
            grads = jax.grad(loss)(params)
            updates, state = tx.update(grads, state, params)
            params = optax.apply_updates(params, updates)
            ref.append({k: np.asarray(v) for k, v in params.items()})
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p0.items()}
    opt = optimize.make_lens_optimizer(tp, {k: torch.from_numpy(v) for k, v in scales.items()})
    for step in range(3):
        opt.zero_grad()
        sum(torch.sum(torch.from_numpy(weight[k]) * (tp[k] - torch.from_numpy(target[k])) ** 2)
            for k in tp).backward()
        opt.step()
        for k, v in ref[step].items():
            np.testing.assert_allclose(tp[k].detach().numpy(), v, rtol=1e-10, atol=0,
                                       err_msg=f"{k} step {step}")


def test_prune_surf_radii(lenses):
    lens, jlens = lenses
    lens.prune_surf()
    jlens.prune_surf()
    np.testing.assert_allclose(lens.stack.r.numpy(), np.asarray(jlens.stack.r), rtol=0,
                               atol=1e-5)


def test_correct_shape_radii(lenses):
    """correct_shape on each lens moved 1 mm back, with two surfaces
    swapped in z so that it must separate them (the last test to use the
    module's lenses: it changes them)."""
    lens, jlens = lenses
    d = np.asarray(jlens.stack.d).copy() + 1.0
    diff = jlens.find_diff_surf()
    a, b = diff[2], diff[3]
    d[b] = d[a] - 0.05
    jlens.stack = JStack(**{**_np(jlens.stack), "d": jnp.asarray(d, jnp.float32),
                            "kind": jlens.stack.kind})
    lens.stack = lens.stack.replace(d=torch.from_numpy(d.astype(np.float32)))
    jlens.d_sensor += 1.0
    lens.d_sensor += 1.0
    assert optimize.correct_shape(lens) == jax_optimize.correct_shape(jlens) is True
    np.testing.assert_allclose(lens.stack.d.numpy(), np.asarray(jlens.stack.d), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(lens.stack.r.numpy(), np.asarray(jlens.stack.r), rtol=0,
                               atol=1e-5)
    assert lens.d_sensor == pytest.approx(float(jlens.d_sensor), abs=1e-6)


def _jax_demo():
    spec = importlib.util.spec_from_file_location(
        "jax_demo_lens_design", os.path.join(ROOT, "scripts", "demo_lens_design.py"))
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    return demo


def test_demo_on_jax_draws(monkeypatch):
    """python -m sdirt_tpu_torch.demo_lens_design on the JAX package's own
    draws (the stored reference) against the JAX demo, 3 steps each: the
    nominal, detuned and recovered tables and the first loss."""
    monkeypatch.chdir(ROOT)
    demo = _jax_demo()
    tables, rms_table = [], demo.rms_table
    monkeypatch.setattr(demo, "rms_table", lambda *a: tables.append(rms_table(*a)) or tables[-1])
    monkeypatch.setattr(sys, "argv", ["demo_lens_design.py", "--lens",
                                      "./lenses/rf50mm/lens_web.json", "--steps", "3"])
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        demo.main()
    loss0 = float(printed.getvalue().split("step    0  loss ")[1].split()[0])
    got = demo_lens_design.main(["--device", "cpu", "--steps", "3", "--draws", DRAWS])
    for name, ref in zip(("nominal", "detuned", "recovered"), tables):
        np.testing.assert_allclose(got[name], np.asarray(ref), rtol=0, atol=0.02,
                                   err_msg=name)
    assert got["losses"][0] == pytest.approx(loss0, rel=1e-3)
    ref = np.load(DRAWS)
    np.testing.assert_allclose(got["nominal"], ref["nominal"], rtol=0, atol=0.02)
    np.testing.assert_allclose(got["detuned"], ref["detuned"], rtol=0, atol=0.02)
