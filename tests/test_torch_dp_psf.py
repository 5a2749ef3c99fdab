"""The port's DP-PSF path (dp/splat.py, dp/psf.py) against the JAX package
on the CPU and the reference goldens (tests/golden/dp_weights.npz,
rf50mm.npz, psf_rf50mm.npz). The JAX dp_psf draws its pupil samples from a
key; the tests draw the same samples with the JAX sampler and hand them to
the port."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdirt_tpu.dp import splat as jax_splat
from sdirt_tpu.dp.psf import dp_psf as jax_dp_psf
from sdirt_tpu.dp.psf import lens_scalars as jax_lens_scalars
from sdirt_tpu.optics.lens import Lens as JLens
from sdirt_tpu.optics.sampling import sample_disk as jax_sample_disk
from sdirt_tpu_torch.dp.fused_trace import fused_trace_sensor_ref, make_fused_plan
from sdirt_tpu_torch.dp.psf import (compute_psf, compute_psf_rgb, dp_psf, dp_psf_fused,
                                    lens_scalars, object_points)
from sdirt_tpu_torch.dp.splat import (DPParams, dp_split_weights, forward_integral,
                                      splat_matmul, splat_scatter)
from sdirt_tpu_torch.optics.lens import Lens
from sdirt_tpu_torch.optics.sampling import sample_from_points

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden")
RF50 = os.path.join(ROOT, "lenses", "rf50mm", "lens_web.json")


@pytest.fixture(scope="module")
def dp_golden():
    return dict(np.load(os.path.join(GOLDEN, "dp_weights.npz")))


@pytest.fixture(scope="module")
def psf_golden():
    return dict(np.load(os.path.join(GOLDEN, "psf_rf50mm.npz")))


@pytest.fixture(scope="module")
def refocused(psf_golden):
    """rf50mm with the sensor pinned at the golden's refocused position, in
    both packages (isolates trace + splat from refocus sampling)."""
    lens = Lens(RF50, sensor_res=(512, 768), device="cpu")
    jlens = JLens(RF50, sensor_res=(512, 768))
    for lz in (lens, jlens):
        lz.d_sensor = float(psf_golden["d_sensor"])
        lz.post_computation()
    return lens, jlens


@pytest.mark.parametrize("regime,r", [("small_r", 0.5), ("big_r", 0.7)])
def test_split_weights(dp_golden, regime, r):
    p = DPParams(h=0.78, f=1.44, w=0.3, r=r)
    x_tan = dp_golden[f"dp_{regime}_x_tan"]
    w_l, w_r = dp_split_weights(torch.from_numpy(x_tan), p)
    np.testing.assert_allclose(w_l.numpy(), dp_golden[f"dp_{regime}_w_l"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(w_r.numpy(), dp_golden[f"dp_{regime}_w_r"], rtol=1e-5, atol=1e-6)
    xt = np.linspace(-2, 2, 1001).astype(np.float32)
    ref = jax_splat.dp_split_weights(xt, jax_splat.DPParams(h=0.78, f=1.44, w=0.3, r=r))
    got = dp_split_weights(torch.from_numpy(xt), p)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=2e-6)


def test_split_weights_direct_and_energy():
    xt = torch.linspace(-2, 2, 1001)
    w_l, w_r = dp_split_weights(xt)
    assert float(w_l.min()) >= -1e-6 and float(w_r.min()) >= -1e-6
    assert float((w_l + w_r).max()) <= 1.0 + 1e-4
    r_l, r_r = dp_split_weights(xt, DPParams(direct="r"))
    assert torch.equal(r_l, w_r) and torch.equal(r_r, w_l)


def test_splat_matmul_scatter_and_jax():
    rng = np.random.default_rng(0)
    ks, ps, spp, n = 7, 0.05, 300, 5
    half = (ks / 2 - 0.5) * ps
    pts = rng.uniform(-half * 0.95, half * 0.95, (spp, n, 2)).astype(np.float32)
    wts = rng.uniform(0, 1, (2, spp, n)).astype(np.float32)
    mm = splat_matmul(torch.from_numpy(pts), torch.from_numpy(wts), ks, ps, chunk=128)
    sc = splat_scatter(torch.from_numpy(pts), torch.from_numpy(wts), ks, ps)
    ref = np.asarray(jax_splat.splat_matmul(pts, wts, ks, ps, chunk=128))
    np.testing.assert_allclose(mm.numpy(), sc.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(mm.numpy(), ref, rtol=0, atol=1e-5)
    # every ray's weight lands on the grid exactly once
    np.testing.assert_allclose(mm.sum((-1, -2)).numpy(), wts.sum(1), rtol=1e-5)


@pytest.mark.parametrize("name", ["rf50mm", "rf35mm"])
def test_forward_integral_golden(name):
    """The reference-traced rays through the port's integral (isolates the
    splat from the trace)."""
    g = dict(np.load(os.path.join(GOLDEN, f"{name}.npz")))
    psf_l, psf_r = forward_integral(torch.from_numpy(g["sensor_o_g"]),
                                    torch.from_numpy(g["sensor_d_g"]),
                                    torch.from_numpy(g["sensor_ra_g"]), ks=21,
                                    ps=24.0 / 512, pointc_ref=g["psf_pointc"])
    np.testing.assert_allclose(psf_l.numpy(), g["psf_points_fixed_center"],
                               rtol=1e-4, atol=1e-5)
    ref_l, ref_r = jax_splat.forward_integral(g["sensor_o_g"], g["sensor_d_g"],
                                              g["sensor_ra_g"], ks=21, ps=24.0 / 512)
    got_l, got_r = forward_integral(torch.from_numpy(g["sensor_o_g"]),
                                    torch.from_numpy(g["sensor_d_g"]),
                                    torch.from_numpy(g["sensor_ra_g"]), ks=21,
                                    ps=24.0 / 512)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(ref_l), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got_r.numpy(), np.asarray(ref_r), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("fused", [False, True], ids=["scan", "fused_plain"])
def test_dp_psf_golden_samples(refocused, psf_golden, fused):
    """Fed the golden's own pupil samples, both traces reproduce its chief-ray
    centres and both PSF functions its max-normalised left PSFs (the
    north-star L1)."""
    lens, _ = refocused
    g = psf_golden
    sc = lens_scalars(lens)
    kw = dict(spp=g["pupil_main"].shape[0], spp_chief=g["pupil_chief"].shape[0],
              ks=21, pupil_main=g["pupil_main"], pupil_chief=g["pupil_chief"] * 0.25)
    chief = sample_from_points(object_points(torch.from_numpy(g["points"]), sc),
                               kw["spp_chief"], sc["pupilz"], sc["pupilr"] * 0.25,
                               xy=kw["pupil_chief"])
    if fused:
        plan = make_fused_plan(lens)
        psf_l, _ = dp_psf_fused(g["points"], None, sc, plan, **kw)
        px, py, _, ra = fused_trace_sensor_ref(chief, lens.d_sensor, plan)
        pointc = torch.stack([(px * ra).sum(0), (py * ra).sum(0)], -1) / (ra.sum(0)[:, None] + 1e-9)
    else:
        eta, skip = lens.eta_arrays(0.589, True)
        psf_l, _ = dp_psf(lens.stack, eta, skip, g["points"], None, sc, **kw)
        out = lens.trace2sensor(chief)
        pointc = -(out.o * out.ra[..., None]).sum(0)[:, :2] / (out.ra.sum(0)[:, None] + 1e-9)
    # centres in mm (pixel 0.047 mm): well under 1/10 pixel
    assert np.abs(pointc.numpy() - g["pointc"]).max() < 5e-3
    assert np.abs(psf_l.numpy() - g["psf_l"]).mean() < 1e-3


def test_dp_psf_matches_jax_same_samples(refocused):
    """JAX dp_psf (scan trace) and the port's dp_psf and dp_psf_fused on the
    JAX sampler's own pupil samples for that key."""
    lens, jlens = refocused
    pts = np.array([[0.0, 0.0, -1000.0], [0.5, -0.3, -3000.0], [-0.8, 0.6, -600.0]],
                   np.float32)
    key = jax.random.PRNGKey(7)
    spp, spp_chief = 2048, 512
    jsc = jax_lens_scalars(jlens)
    eta, skip = jlens.eta_arrays(0.589, True)
    ref_l, ref_r = jax_dp_psf(jlens.stack, eta, skip, jnp.asarray(pts), key, jsc,
                              spp=spp, spp_chief=spp_chief, ks=21)
    k_chief, k_main = jax.random.split(key)
    xy_chief = np.array(jax_sample_disk(k_chief, (spp_chief,), jsc["pupilr"] * 0.25))
    xy_main = np.array(jax_sample_disk(k_main, (spp,), jsc["pupilr"]))
    sc = lens_scalars(lens)
    kw = dict(spp=spp, spp_chief=spp_chief, ks=21, pupil_main=xy_main,
              pupil_chief=xy_chief)
    teta, tskip = lens.eta_arrays(0.589, True)
    scan = dp_psf(lens.stack, teta, tskip, pts, None, sc, **kw)
    fused = dp_psf_fused(pts, None, sc, make_fused_plan(lens), **kw)
    for got in (scan, fused):
        for a, b in zip(got, (ref_l, ref_r)):
            assert np.abs(a.numpy() - np.asarray(b)).mean() <= 1e-3


def test_compute_psf_generator(refocused):
    lens, _ = refocused
    pts = np.array([[0.0, 0.0, -1000.0], [0.4, 0.4, -1500.0]], np.float32)
    a = compute_psf(lens, pts, torch.Generator().manual_seed(1), spp=512, ks=11)
    b = compute_psf(lens, pts, torch.Generator().manual_seed(1), spp=512, ks=11)
    pl, pr = compute_psf(lens, pts, torch.Generator().manual_seed(2), spp=512, ks=11,
                         both=True)
    assert a.shape == (2, 11, 11) and torch.equal(a, b)
    assert float(a.amax((-1, -2)).min()) == pytest.approx(1.0, abs=1e-5)
    assert pr.shape == pl.shape and not torch.equal(pl, pr)
    rgb = compute_psf_rgb(lens, pts, torch.Generator().manual_seed(1), spp=512, ks=11)
    assert rgb.shape == (2, 3, 11, 11)
    # the red channel draws first from the generator, at 0.656 um
    red = compute_psf(lens, pts, torch.Generator().manual_seed(1), spp=512, ks=11,
                      wvln=0.656)
    assert torch.equal(rgb[:, 0], red) and not torch.equal(rgb[:, 0], rgb[:, 2])
