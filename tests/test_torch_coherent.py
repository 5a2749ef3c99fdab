"""The port's coherent PSFs (core/rays.py phase bookkeeping, the coherent
trace of optics/surfaces.py, dp/coherent.py, coherent_demo.py) against the
JAX package on the CPU.

Tolerances: propagate_to on the same arrays: positions and opl bit-equal,
phi within 1e-6 rad; the coherent trace on the same rays: positions within
2e-4 mm (the per-surface trace's bound, ROADMAP.md §3); coherent_psf_pair on
the same traced arrays within 1e-5 of each PSF's largest value;
coherent_psf_grid at M 64, ks 33 on the same lens against the JAX package
run op by op (``jax.disable_jit()``): incoherent ring contrast within 1e-3
and PSF within 1e-2 (measured 3.4e-5 and 2.1e-3), the coherent ring
contrast within 0.03 (measured 0.011 at -1000 mm). The coherent PSF is
limited by f32 in both packages: the phase n k (t - min t) of a ray's first
step (t ~ 1 m) carries ~0.6 rad of rounding (k = 1.07e4 rad/mm, one f32
ulp at 1100 mm is 1.2e-4 mm), so two f32 implementations agree only where
they round alike. The port does each operation as the JAX code writes it;
the jitted JAX program (XLA's own fusion of the trace) lands elsewhere: at
M 512, -1100 mm, ring contrast 0.027 jitted, 0.121 op by op, 0.116 in the
port, 0.012 in a float64 trace (PERF.md §6).
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdirt_tpu.core.rays import Rays as JRays
from sdirt_tpu.dp.coherent import coherent_psf_grid as jax_grid
from sdirt_tpu.dp.coherent import coherent_psf_pair as jax_pair
from sdirt_tpu.optics.lens import Lens as JLens
from sdirt_tpu.optics.surfaces import trace_rays as jax_trace_rays
from sdirt_tpu.render.perpixel import uniform_psf_conv as jax_uniform_conv
from sdirt_tpu_torch import coherent_demo
from sdirt_tpu_torch.core.rays import Rays
from sdirt_tpu_torch.dfdp.datasets import read_png
from sdirt_tpu_torch.dp.coherent import coherent_psf_grid, coherent_psf_pair
from sdirt_tpu_torch.optics.lens import Lens
from sdirt_tpu_torch.optics.surfaces import trace_rays
from sdirt_tpu_torch.render.perpixel import uniform_psf_conv

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RF50 = os.path.join(ROOT, "lenses", "rf50mm", "lens_web.json")


def _wrap(a):
    return (a + np.pi) % (2 * np.pi) - np.pi


@pytest.fixture(scope="module")
def lenses():
    """rf50mm refocused to 1 m in JAX, the port's lens at the same sensor
    distance (refocus draws Monte-Carlo samples)."""
    jlens = JLens(RF50, sensor_res=(512, 768))
    jlens.refocus(-1000 + jlens.d_sensor)
    lens = Lens(RF50, sensor_res=(512, 768), device="cpu")
    lens.d_sensor = float(jlens.d_sensor)
    lens.post_computation()
    return lens, jlens


def test_propagate_to_with_phase_matches_jax():
    rng = np.random.default_rng(0)
    o = np.concatenate([rng.uniform(-5, 5, (64, 3, 2)), rng.uniform(30, 40, (64, 3, 1))],
                       -1).astype(np.float32)
    d = np.concatenate([rng.uniform(-0.2, 0.2, (64, 3, 2)), np.ones((64, 3, 1))],
                       -1).astype(np.float32)
    opl = rng.uniform(0, 100, (64, 3)).astype(np.float32)
    phi = rng.uniform(0, 6, (64, 3)).astype(np.float32)
    jr = JRays.create(o, d).replace(opl=jnp.asarray(opl), phi=jnp.asarray(phi))
    tr = Rays(o=torch.tensor(np.asarray(jr.o)), d=torch.tensor(np.asarray(jr.d)),
              ra=torch.ones(64, 3), opl=torch.from_numpy(opl), phi=torch.from_numpy(phi))
    ref = jr.propagate_to(62.0, n=1.0, wvln=0.589)
    got = tr.propagate_to(62.0, n=1.0, wvln=0.589)
    np.testing.assert_array_equal(got.o.numpy(), np.asarray(ref.o))
    np.testing.assert_array_equal(got.opl.numpy(), np.asarray(ref.opl))
    assert np.abs(_wrap(got.phi.numpy() - np.asarray(ref.phi))).max() <= 1e-6
    np.testing.assert_array_equal(tr.project_to(50.0).numpy(), np.asarray(jr.project_to(50.0)))
    plain = Rays.create(o, d)
    assert plain.phi is None and plain.propagate_to(62.0).phi is None
    with pytest.raises(ValueError, match="coherent"):
        plain.propagate_to(62.0, wvln=0.589)


def test_coherent_trace_positions(lenses):
    lens, jlens = lenses
    pts = np.array([[0.0, 0.0, -1100.0], [150.0, -80.0, -1300.0]], np.float32)
    jr = jlens.sample_from_points_grid(pts, M=24)
    tr = lens.sample_from_points_grid(pts, M=24)
    np.testing.assert_array_equal(tr.d.numpy(), np.asarray(jr.d))
    np.testing.assert_array_equal(tr.ra.numpy(), np.asarray(jr.ra))
    eta, skip = jlens.eta_arrays(0.589, True)
    ref = jax_trace_rays(jr, jlens.stack, eta, skip, n_in=jlens.n_in_array(0.589, True),
                         coherent=True, wvln=0.589)
    e2, s2 = lens.eta_arrays(0.589, True)
    got = trace_rays(tr, lens.stack, e2, s2, n_in=lens.n_in_array(0.589, True),
                     coherent=True, wvln=0.589)
    np.testing.assert_array_equal(got.ra.numpy(), np.asarray(ref.ra))
    live = np.asarray(ref.ra) > 0
    assert np.abs(got.o.numpy() - np.asarray(ref.o))[live].max() <= 2e-4
    assert np.abs(got.opl.numpy() - np.asarray(ref.opl))[live].max() <= 2e-3
    np.testing.assert_array_equal(lens.n_in_array(0.589, True).numpy(),
                                  np.asarray(jlens.n_in_array(0.589, True)))
    with pytest.raises(ValueError, match="n_in"):
        trace_rays(tr, lens.stack, e2, s2, coherent=True)


@pytest.mark.parametrize("center", [True, False])
def test_coherent_psf_pair_same_arrays(center):
    rng = np.random.default_rng(1)
    o = np.concatenate([rng.normal(0, 0.01, (4096, 2, 2)), np.full((4096, 2, 1), 62.0)],
                       -1).astype(np.float32)
    ra = (rng.uniform(0, 1, (4096, 2)) > 0.1).astype(np.float32)
    phi = rng.uniform(0, 2 * np.pi, (4096, 2)).astype(np.float32)
    pc = np.array([[0.001, -0.002], [0.0, 0.003]], np.float32) if not center else None
    ref = jax_pair(jnp.asarray(o), jnp.asarray(ra), jnp.asarray(phi), 33, 0.0015,
                   pointc_ref=None if pc is None else jnp.asarray(pc))
    got = coherent_psf_pair(torch.from_numpy(o), torch.from_numpy(ra), torch.from_numpy(phi),
                            33, 0.0015, pointc_ref=pc)
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert np.abs(g.numpy() - r).max() <= 1e-5 * r.max()


def test_coherent_psf_grid_m64(lenses):
    """The whole coherent path at M 64, ks 33 on two depths (against the JAX
    package op by op) and a 2 x 2 field grid: ring contrasts and the
    incoherent PSFs."""
    lens, jlens = lenses
    for depth in (-1000.0, -1100.0):
        coh, inc = coherent_psf_grid(lens, depth, grid=1, ks=33, M=64, ps=0.0015)
        with jax.disable_jit():
            jcoh, jinc = jax_grid(jlens, depth, grid=1, ks=33, M=64, ps=0.0015)
        coh, inc = coh[0, 0].numpy(), inc[0, 0].numpy()
        jcoh, jinc = np.asarray(jcoh)[0, 0], np.asarray(jinc)[0, 0]
        rp = coherent_demo.radial_profile
        rc = coherent_demo.ring_contrast
        assert abs(rc(rp(inc)) - rc(rp(jinc))) <= 1e-3
        assert np.abs(inc - jinc).max() <= 1e-2
        assert abs(rc(rp(coh)) - rc(rp(jcoh))) <= 0.03
        assert coh.max() == pytest.approx(1.0, abs=1e-6)
    coh, inc = coherent_psf_grid(lens, -1300.0, grid=2, ks=21, M=16)
    assert coh.shape == inc.shape == (2, 2, 21, 21)
    assert bool(torch.isfinite(coh).all())


def test_uniform_psf_conv_matches_jax():
    rng = np.random.default_rng(2)
    img = rng.uniform(0, 1, (1, 40, 50, 1)).astype(np.float32)
    psf = rng.uniform(0, 1, (1, 9, 9)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax_uniform_conv(jnp.asarray(img), jnp.asarray(psf), 9))
    got = uniform_psf_conv(torch.from_numpy(img), torch.from_numpy(psf), 9).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_coherent_demo_end_to_end(tmp_path, monkeypatch, capsys):
    """python -m sdirt_tpu_torch.coherent_demo on the CPU at M 32, ks 33,
    with --image: every panel and profile written (PNGs read back by the
    port's reader), and the ring-contrast lines printed."""
    monkeypatch.chdir(ROOT)
    out = str(tmp_path / "coh")
    res = coherent_demo.main(["--device", "cpu", "--M", "32", "--ks", "33",
                              "--depths", "-1000", "-1300", "--out", out, "--image"])
    printed = capsys.readouterr().out
    assert printed.count("mm  ring contrast: coherent") == 2
    assert printed.count("mm  in-image ring contrast: coherent") == 2
    for tag in (1000, 1300):
        panel = read_png(f"{out}/psf_panel_{tag}.png")
        assert panel.shape == (33, 66) and panel.dtype == np.uint8
        prof = np.load(f"{out}/profile_{tag}.npz")
        assert prof["coherent"].shape == (24,)
        assert all(np.isfinite(res["depths"][-float(tag)]["contrast"]))
    assert read_png(f"{out}/interference_image.png").shape == (256, 960)
    assert len(res["image"]["probes"]) == 2
    spec = importlib.util.spec_from_file_location(
        "jax_coherent_demo", os.path.join(ROOT, "apps", "coherent_demo.py"))
    app = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(app)
    prof = res["depths"][-1000.0]["profiles"][0]
    np.testing.assert_array_equal(app.radial_profile(res["depths"][-1000.0]["coherent"]), prof)
    assert app.ring_contrast(prof) == coherent_demo.ring_contrast(prof)
