"""The port's depth-side tools against the JAX package's scripts on the CPU:
``eval_depth_ckpt`` (constant floor equal; the evaluation itself is in
tests/test_torch_eval_depth_ckpt.py), ``dp_disparity_probe`` (the surrogate's disparity
and blur within 1e-3 px), ``finetune_real_loo`` (``hflip_dp`` and
``augment`` equal, also on the negative values a bicubic downscale leaves;
its fine-tune steps are in tests/test_torch_finetune_loo.py), and
``utils/debug.py`` (``checked_trace`` names the surface at which JAX's
checkify first fails on an injected NaN).
"""

import dataclasses
import importlib.util
import io
import os
import sys
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdirt_tpu_torch import dp_disparity_probe, eval_depth_ckpt, finetune_real_loo
from sdirt_tpu_torch.core.rays import Rays
from sdirt_tpu_torch.optics.lens import Lens
from sdirt_tpu_torch.utils.debug import assert_finite_loss, checked_trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE_TOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test files at once on the machine's cores;
    this file's torch work keeps to two threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_jax_main(mod, argv, monkeypatch) -> str:
    monkeypatch.setattr(sys, "argv", [mod.__name__, *argv])
    buf = io.StringIO()
    with redirect_stdout(buf):
        mod.main()
    return buf.getvalue()


def test_constant_floor_equal():
    jax_mod = _script("eval_depth_ckpt")
    rng = np.random.default_rng(0)
    for depths in (rng.uniform(0.3, 9.0, 500), np.full(50, 2.0), rng.uniform(5, 9, 80)):
        assert eval_depth_ckpt.constant_floor(depths) == jax_mod.constant_floor(depths)


def test_disparity_probe_matches_jax(monkeypatch):
    monkeypatch.chdir(ROOT)
    text = _run_jax_main(_script("dp_disparity_probe"), ["--cpu"], monkeypatch)
    ref = [tuple(float(v) for v in line.split())
           for line in text.splitlines()[1:] if line.strip()]
    got = dp_disparity_probe.main(["--device", "cpu"])
    assert [r["depth_m"] for r in got] == [r[0] for r in ref] == list(
        dp_disparity_probe.DEPTHS)
    for r, (_, disp, sig) in zip(got, ref):
        # the JAX script prints 3 and 2 decimals
        assert abs(r["disparity_px"] - disp) <= PROBE_TOL + 5e-4, (r, disp)
        assert abs(r["sigma_px"] - sig) <= PROBE_TOL + 5e-3, (r, sig)


def test_disparity_probe_surrogate_unrounded():
    """The probe's arithmetic on the port's surrogate PSFs against the JAX
    script's formulas, unrounded, within 1e-3 px."""
    from sdirt_tpu.psfnet.surrogate import PSFNetLens as JaxLens

    jl = JaxLens(os.path.join(ROOT, "lenses/rf50mm/lens_web.json"), kernel_size=21,
                 sensor_res=(512, 768))
    jl.load_net(os.path.join(ROOT, "ckpt/rf50mm/F4_PSFNet_mlp"))
    from sdirt_tpu_torch.psfnet.surrogate import PSFNetLens

    tl = PSFNetLens(os.path.join(ROOT, "lenses/rf50mm/lens_web.json"), kernel_size=21,
                    sensor_res=(512, 768), device="cpu")
    tl.load_net(os.path.join(ROOT, "sdirt_tpu_torch/weights/rf50mm/F4_PSFNet_mlp.npz"))
    got = dp_disparity_probe.probe(tl, dp_disparity_probe.DEPTHS, 21)
    for r in got:
        depth_mm = -r["depth_m"] * 1e3 + jl.d_sensor
        z = jl.depth2z(jnp.array([depth_mm]))
        o = jnp.stack([jnp.zeros(1), jnp.zeros(1), z], -1)
        psf = np.asarray(jl.pred(o[None])).reshape(-1, 2, 21, 21)[0]
        disp, sig = dp_disparity_probe.disparity(psf[0], psf[1], 21)
        assert abs(r["disparity_px"] - disp) <= PROBE_TOL
        assert abs(r["sigma_px"] - sig) <= PROBE_TOL


def test_disparity_probe_traced_runs():
    """--traced on the CPU (K1's plain version) at a reduced ray count:
    finite, and the disparity changes sign across the 1 m focus."""
    rows = dp_disparity_probe.main(["--device", "cpu", "--traced", "--spp", "20000",
                                    "--depths", "0.5", "1.0", "3.0"])
    disp = [r["disparity_px"] for r in rows]
    assert np.isfinite(disp).all() and disp[0] * disp[2] < 0
    assert all(np.isfinite(r["sigma_px"]) for r in rows)


def test_hflip_and_augment_equal():
    jax_mod = _script("finetune_real_loo")
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (6, 8, 10)).astype(np.float32)
    depth = rng.uniform(0.3, 9, (1, 8, 10)).astype(np.float32)
    for a, b in zip(finetune_real_loo.hflip_dp(img, depth), jax_mod.hflip_dp(img, depth)):
        np.testing.assert_array_equal(a, b)
    r1, r2 = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(30):
        for a, b in zip(finetune_real_loo.augment(img, depth, r1),
                        jax_mod.augment(img, depth, r2)):
            np.testing.assert_array_equal(a, b)
    # a capture resized below 512x768 overshoots below 0, and the gamma draw
    # then gives NaN in both packages (assert_array_equal takes NaN == NaN)
    img[0, 0, :3] = -0.01
    seen_nan = False
    for _ in range(30):
        for a, b in zip(finetune_real_loo.augment(img, depth, r1),
                        jax_mod.augment(img, depth, r2)):
            np.testing.assert_array_equal(a, b)
            seen_nan |= bool(np.isnan(a).any())
    assert seen_nan


def _jax_error_through(jc, rays, stack, eta, skip, k):
    """JAX's checked_trace report on the stack cut after surface k."""
    sub = dataclasses.replace(stack, **{f: getattr(stack, f)[:k + 1] for f in
                                        ("c", "k", "ai", "d", "r", "kind")})
    err, _ = jc(rays, sub, eta[:k + 1], skip[:k + 1])
    return err.get()


@pytest.mark.parametrize("field,surface,value", [("c", 3, np.inf), ("d", 5, np.nan),
                                                 ("r", 8, np.nan)])
def test_checked_trace_names_jax_surface(field, surface, value):
    from sdirt_tpu.optics.lens import Lens as JaxLens
    from sdirt_tpu.utils.debug import checked_trace as jax_checked_trace

    path = os.path.join(ROOT, "lenses/rf50mm/lens_web.json")
    jl = JaxLens(path, sensor_res=(512, 768))
    eta, skip = jl.eta_arrays(0.589, True)
    jr = jl.sample_from_points(jax.random.PRNGKey(0),
                               np.array([[0, 0, -1000.0]], np.float32), spp=64)
    tl = Lens(path, sensor_res=(512, 768), device="cpu")
    teta, tskip = tl.eta_arrays(0.589, True)
    rays = Rays(o=torch.from_numpy(np.array(jr.o)), d=torch.from_numpy(np.array(jr.d)),
                ra=torch.from_numpy(np.array(jr.ra)))

    report, out = checked_trace(rays, tl.stack, teta, tskip)
    assert report.get() is None and report.surface is None
    report.throw()
    assert float(out.ra.sum()) > 0

    bad = np.array(getattr(jl.stack, field))
    bad[surface] = value
    bad_stack = dataclasses.replace(jl.stack, **{field: bad})
    # checkify first fails with the stack cut after this surface, not before
    assert _jax_error_through(jax_checked_trace, jr, bad_stack, eta, skip, surface)
    assert _jax_error_through(jax_checked_trace, jr, bad_stack, eta, skip,
                              surface - 1) is None
    tbad = getattr(tl.stack, field).clone()
    tbad[surface] = float(value)
    report, _ = checked_trace(rays, dataclasses.replace(tl.stack, **{field: tbad}),
                              teta, tskip)
    assert report.surface == surface, report.get()
    with pytest.raises(FloatingPointError, match=f"surface {surface}"):
        report.throw()


def test_assert_finite_loss():
    assert assert_finite_loss(1.25) == 1.25
    assert assert_finite_loss(torch.tensor(0.5)) == 0.5
    with pytest.raises(FloatingPointError, match="train loss"):
        assert_finite_loss(float("nan"), "train loss")
