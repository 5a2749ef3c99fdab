"""The PyTorch port's optics foundation (materials, lens scalars, the
per-surface trace, refocus, lens JSON) against the JAX package on the CPU
and the reference goldens (tests/golden/rf{50,35}mm.npz), for both shipped
lenses."""

import copy
import json
import os

import jax
import numpy as np
import pytest

from sdirt_tpu.core.materials import Material as JMaterial
from sdirt_tpu.core.rays import Rays as JRays
from sdirt_tpu.io.lens_json import read_lens_json as jax_read_lens_json
from sdirt_tpu.optics import sampling as jax_sampling
from sdirt_tpu.optics.lens import Lens as JLens
from sdirt_tpu_torch.core.constants import GEO_SPP
from sdirt_tpu_torch.core.materials import Material
from sdirt_tpu_torch.core.rays import Rays
from sdirt_tpu_torch.io.lens_json import read_lens_json
from sdirt_tpu_torch.optics.lens import Lens

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden")
LENSES = ("rf50mm", "rf35mm")
WAVES = {"g": 0.589, "r": 0.656, "b": 0.486}


def lens_path(name):
    return os.path.join(ROOT, "lenses", name, "lens_web.json")


@pytest.fixture(scope="module", params=LENSES)
def lenses(request):
    """(name, port Lens on the CPU, JAX Lens, golden dict)."""
    name = request.param
    return (name, Lens(lens_path(name), sensor_res=(512, 768), device="cpu"),
            JLens(lens_path(name), sensor_res=(512, 768)),
            dict(np.load(os.path.join(GOLDEN, f"{name}.npz"))))


def _golden_rays(lens_pupilz, g):
    pts, xy = g["trace_points"], g["trace_pupil_xy"]
    spp = xy.shape[0]
    o = np.broadcast_to(pts[None], (spp, pts.shape[0], 3)).copy()
    o2 = np.concatenate([xy, np.full((spp, 1), lens_pupilz, np.float32)], -1)
    return o, o2[:, None, :] - o


def test_material_ior(lenses):
    _, lens, _, _ = lenses
    for m in lens.materials:
        ref = JMaterial.create(m.name)
        assert m.is_air == ref.is_air
        for w in (*WAVES.values(), 0.5, 589.0):
            assert m.ior(w) == ref.ior(w), (m.name, w)
    for name in ("n-bk7", "pmma", "hk51", "1.5/60"):
        assert Material.create(name).ior(0.55) == JMaterial.create(name).ior(0.55)


def test_lens_scalars(lenses):
    _, lens, jlens, g = lenses
    assert lens.aper_idx == jlens.aper_idx == int(g["aper_idx"])
    for k in ("hfov", "foclen", "fnum", "r_last", "pixel_size", "d_sensor"):
        assert getattr(lens, k) == pytest.approx(getattr(jlens, k), rel=1e-6), k
    np.testing.assert_allclose(lens.entrance_pupil(), jlens.entrance_pupil(), rtol=1e-9)
    np.testing.assert_allclose(lens.exit_pupil(), jlens.exit_pupil(), rtol=1e-9)
    np.testing.assert_allclose(lens.calc_principal(), jlens.calc_principal(),
                               rtol=0, atol=1e-4)
    # against the reference dumps, at the JAX package's own tolerances
    assert lens.hfov == pytest.approx(float(g["hfov"]), rel=1e-3)
    assert lens.foclen == pytest.approx(float(g["foclen"]), rel=1e-3)
    assert lens.fnum == pytest.approx(float(g["fnum"]), rel=5e-3)
    for mine, ref in ((lens.entrance_pupil(), g["entrance_pupil"]),
                      (lens.exit_pupil(), g["exit_pupil"])):
        assert mine[0] == pytest.approx(ref[0], rel=2e-3, abs=2e-3)
        assert mine[1] == pytest.approx(ref[1], rel=5e-3)
    np.testing.assert_allclose(lens.calc_principal(), g["principal"], atol=5e-3)


@pytest.mark.parametrize("wave", list(WAVES))
def test_forward_trace(lenses, wave):
    _, lens, jlens, g = lenses
    o, d = _golden_rays(lens.entrance_pupil()[0], g)
    out = lens.trace2sensor(Rays.create(o, d), wvln=WAVES[wave])
    ref = jlens.trace2sensor(JRays.create(o, d), wvln=WAVES[wave])
    ra = out.ra.numpy()
    np.testing.assert_array_equal(ra, np.asarray(ref.ra))
    m = ra > 0
    assert m.mean() > 0.5
    # rounding order differs (XLA contracts multiply-adds on the CPU), ~1e-4
    # mm over the 12-21 Newton-polished surfaces; the goldens allow 5e-4
    np.testing.assert_allclose(out.o.numpy()[m], np.asarray(ref.o)[m], rtol=0, atol=2e-4)
    np.testing.assert_allclose(out.d.numpy()[m], np.asarray(ref.d)[m], rtol=0, atol=2e-6)
    # the reference dumps: the Newton tolerance band (JAX test's bounds)
    np.testing.assert_array_equal(ra, g[f"sensor_ra_{wave}"])
    assert np.abs(out.o.numpy()[m] - g[f"sensor_o_{wave}"][m]).max() < 5e-4
    assert np.abs(out.d.numpy()[m] - g[f"sensor_d_{wave}"][m]).max() < 5e-6


def test_backward_trace(lenses):
    _, lens, jlens, g = lenses
    ez, er = g["exit_pupil"]
    er = er * 0.25
    o1 = np.tile(np.array([lens.r_last, 0.0, lens.d_sensor], np.float32), (32, 1))
    x2 = np.linspace(-er, er, 32).astype(np.float32)
    o2 = np.stack([x2, np.zeros(32, np.float32), np.full(32, ez, np.float32)], -1)
    out = lens.trace(Rays.create(o1, o2 - o1), forward=False)
    ref = jlens.trace(JRays.create(o1, o2 - o1), forward=False)
    np.testing.assert_array_equal(out.ra.numpy(), np.asarray(ref.ra))
    np.testing.assert_array_equal(out.ra.numpy(), g["back_ra"])
    m = g["back_ra"] > 0
    np.testing.assert_allclose(out.o.numpy()[m], np.asarray(ref.o)[m], rtol=0, atol=2e-4)
    assert np.abs(out.o.numpy()[m] - g["back_o"][m]).max() < 5e-4
    assert np.abs(out.d.numpy()[m] - g["back_d"][m]).max() < 1e-5


def test_refocus_same_samples(lenses):
    """The fit's refocus: both packages move the sensor to the same
    least-squares focus from the same 2048 samples on the first surface."""
    name, lens, jlens, g = lenses
    key = jax.random.PRNGKey(0)
    r0, d0 = float(lens.stack.r[0]), float(lens.stack.d[0])
    xy = np.array(jax_sampling.surface_sample(key, GEO_SPP, r0, d0))[:, :2]
    pinned = 62.25 if name == "rf50mm" else 80.447
    mine, ref = copy.copy(lens), copy.copy(jlens)
    mine._pupil_cache, ref._pupil_cache = {}, {}
    mine.d_sensor = ref.d_sensor = pinned
    mine.refocus(-1000.0 + pinned, xy=xy)
    ref.refocus(-1000.0 + pinned, key=key)
    assert mine.d_sensor == pytest.approx(ref.d_sensor, abs=1e-4)
    assert mine.hfov == pytest.approx(ref.hfov, rel=1e-5)
    assert mine.fnum == pytest.approx(ref.fnum, rel=1e-5)
    # the reference dump drew other samples: the JAX test's bounds
    assert mine.d_sensor == pytest.approx(float(g["d_sensor_refocused"]), abs=2e-2)
    assert mine.hfov == pytest.approx(float(g["hfov_refocused"]), rel=2e-3)


def test_calc_foc_dist_same_samples(lenses):
    _, lens, jlens, _ = lenses
    key = jax.random.PRNGKey(5)
    r0, d0 = float(lens.stack.r[0]), float(lens.stack.d[0])
    xy = np.array(jax_sampling.surface_sample(key, GEO_SPP, r0, d0))[:, :2]
    mine, ref = copy.copy(lens), copy.copy(jlens)
    mine._pupil_cache, ref._pupil_cache = {}, {}
    mine.refocus(-2000.0, xy=xy)
    ref.refocus(-2000.0, key=key)
    got, want = mine.calc_foc_dist(xy=xy), ref.calc_foc_dist(key=key)
    assert got == pytest.approx(want, rel=1e-4)
    assert got == pytest.approx(-2000.0, rel=0.05)


def test_lens_json_roundtrip(lenses, tmp_path):
    name, lens, jlens, _ = lenses
    path = str(tmp_path / f"{name}.json")
    lens.write_lens_json(path)
    jpath = str(tmp_path / f"{name}_jax.json")
    jlens.write_lens_json(jpath)
    with open(path) as f, open(jpath) as g:
        mine, ref = json.load(f), json.load(g)
    assert mine.keys() == ref.keys()
    for k in ("foclen", "fnum", "r_last", "d_sensor"):
        assert mine[k] == pytest.approx(ref[k], rel=1e-6)
    assert mine["surfaces"] == ref["surfaces"]
    stack, mats, r_last, d_sensor, _ = read_lens_json(path)
    jstack = jax_read_lens_json(path)[0]
    for k in ("c", "k", "ai", "d", "r", "kind"):
        np.testing.assert_array_equal(getattr(stack, k).numpy(),
                                      np.asarray(getattr(jstack, k)))
        np.testing.assert_array_equal(getattr(stack, k).numpy(),
                                      getattr(lens.stack, k).numpy())
    assert [m.name for m in mats] == [m.name for m in lens.materials]
    assert (r_last, d_sensor) == (lens.r_last, lens.d_sensor)


def test_set_aperture(lenses):
    _, lens, jlens, _ = lenses
    mine, ref = copy.copy(lens), copy.copy(jlens)
    mine._pupil_cache, ref._pupil_cache = {}, {}
    mine.set_aperture(fnum=8.0)
    ref.set_aperture(fnum=8.0)
    assert mine.fnum == pytest.approx(ref.fnum, rel=1e-6)
    assert mine.entrance_pupil()[1] == pytest.approx(ref.entrance_pupil()[1], rel=1e-6)
    assert float(mine.stack.r[mine.aper_idx]) == float(np.asarray(ref.stack.r)[ref.aper_idx])
