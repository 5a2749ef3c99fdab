"""The port's lens analysis and the optics it stands on (optics/analysis.py,
the rest of optics/sampling.py and optics/lens.py, the recording and the
specialised traces of optics/surfaces.py, dp_psf's specialised route,
utils/png.py, fit_psfnet.py without --skip-analysis) against the JAX
package on the CPU, on both lenses.

Tolerances: sampling on the same draws within 1e-6; the recording and the
specialised traces: positions within 2e-4 mm and directions within 2e-6,
validity equal (ROADMAP.md §3); psf2mtf within 1e-6; analysis_rms on the
same samples within 2e-6 mm (measured 4.5e-7); draw_psf_map on the same
samples within 1e-5 mean and 1e-3 max of the per-cell-normalised map
(measured 6.9e-7 and 9.6e-5); the magnification within 1e-5 relative.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdirt_tpu.core.constants import GEO_SPP
from sdirt_tpu.dp.psf import dp_psf as jax_dp_psf
from sdirt_tpu.dp.psf import lens_scalars as jax_lens_scalars
from sdirt_tpu.optics import analysis as jax_analysis
from sdirt_tpu.optics import sampling as jax_sampling
from sdirt_tpu.optics.lens import Lens as JLens
from sdirt_tpu.optics.surfaces import trace_rays_specialized as jax_trace_spec
from sdirt_tpu_torch import fit_psfnet
from sdirt_tpu_torch.core.rays import Rays
from sdirt_tpu_torch.dfdp.datasets import read_png
from sdirt_tpu_torch.dp.psf import dp_psf, lens_scalars
from sdirt_tpu_torch.optics import analysis, sampling
from sdirt_tpu_torch.optics.lens import Lens
from sdirt_tpu_torch.optics.surfaces import trace_rays_specialized
from sdirt_tpu_torch.utils.png import write_png

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def lens_path(name):
    return os.path.join(ROOT, "lenses", name, "lens_web.json")


@pytest.fixture(scope="module", params=("rf50mm", "rf35mm"))
def lenses(request):
    """(port Lens on the CPU, JAX Lens), refocused to 1 m at the JAX
    lens's sensor distance."""
    jlens = JLens(lens_path(request.param), sensor_res=(512, 768))
    jlens.refocus(-1000.0 + jlens.d_sensor)
    lens = Lens(lens_path(request.param), sensor_res=(512, 768), device="cpu")
    lens.d_sensor = float(jlens.d_sensor)
    lens.post_computation()
    return lens, jlens


def _draws(key, shape):
    """The two uniform arrays a JAX pupil sampler draws from key."""
    k1, k2 = jax.random.split(key)
    return np.asarray(jax.random.uniform(k1, shape)), np.asarray(jax.random.uniform(k2, shape))


def _close(got, ref, atol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=0, atol=atol, err_msg=what)


@pytest.mark.parametrize("spp", [64, 12, 16384])
def test_sample_pupil_stratified(spp):
    """Both branches (stratified; plain disk for spp % 8 or spp >= 10000)."""
    key = jax.random.PRNGKey(spp)
    ref = jax_sampling.sample_pupil_stratified(key, (3, 4), spp, 6.0, 22.5)
    shape = sampling.stratified_shape((3, 4), spp)
    got = sampling.sample_pupil_stratified((3, 4), spp, 6.0, 22.5, draws=_draws(key, shape))
    assert got.shape == (spp, 3, 4, 3)
    _close(got, ref, 1e-6)
    with pytest.raises(ValueError, match="draws"):
        sampling.sample_pupil_stratified((3, 4), spp, 6.0, 22.5,
                                         draws=_draws(key, (2, 3, 4)))


def test_samplers_match_jax(lenses):
    lens, jlens = lenses
    pupilz, pupilr = jlens.entrance_pupil()
    pts = np.array([[0.0, 0.0, -900.0], [40.0, -30.0, -2000.0]], np.float32)
    got, ref = sampling.sample_from_points_grid(pts, 17, pupilz, pupilr), \
        jax_sampling.sample_from_points_grid(pts, 17, pupilz, pupilr)
    for a in ("o", "d", "ra"):
        _close(getattr(got, a), getattr(ref, a), 1e-6, a)
    for fov, mode in ((0.0, "grid"), (12.0, "grid"), (7.0, "radial")):
        key = jax.random.PRNGKey(5)
        ref = jlens.sample_parallel(key, fov_deg=fov, M=9, sampling=mode)
        xy = np.asarray(jax_sampling.sample_disk(key, (9, 9), pupilr))
        got = lens.sample_parallel(fov_deg=fov, M=9, sampling=mode, xy=xy)
        for a in ("o", "d"):
            _close(getattr(got, a), getattr(ref, a), 2e-5 if a == "o" else 1e-6, (fov, mode, a))
    ref = jax_sampling.sample_point_source_2d(-800.0, view=10.0, M=9, pupil=(pupilz, pupilr))
    got = sampling.sample_point_source_2d(-800.0, view=10.0, M=9, pupil=(pupilz, pupilr))
    _close(got.o, ref.o, 1e-4)
    _close(got.d, ref.d, 1e-6)
    key = jax.random.PRNGKey(9)
    ref = jlens.sample_point_source(key, depth=-1500.0, R=100.0, M=5, spp=64)
    got = lens.sample_point_source(depth=-1500.0, R=100.0, M=5, spp=64,
                                   draws=_draws(key, (8, 8, 5, 5)))
    _close(got.o, ref.o, 1e-4)
    _close(got.d, ref.d, 1e-6)
    small = Lens(lens_path("rf50mm"), sensor_res=(8, 12), device="cpu")
    jsmall = JLens(lens_path("rf50mm"), sensor_res=(8, 12))
    ref = jsmall.sample_sensor(key, spp=16)
    got = small.sample_sensor(spp=16, draws=_draws(key, (8, 2, 8, 12)))
    _close(got.o, ref.o, 1e-5)
    _close(got.d, ref.d, 1e-6)
    assert lens.sample_sensor(spp=16, generator=torch.Generator()).o.shape[0] == 16


def test_recording_and_specialised_traces(lenses):
    lens, jlens = lenses
    key = jax.random.PRNGKey(0)
    pts = jnp.asarray([[0.0, 0.0, -1200.0], [300.0, 200.0, -1500.0], [-600.0, 350.0, -1000.0]])
    jr = jlens.sample_from_points(key, pts, spp=512)
    tr = Rays.create(np.asarray(jr.o), np.asarray(jr.d))
    for fwd in (True, False):
        ref, ref_o, ref_ra = jlens.trace(jr, forward=fwd, record=True)
        got, got_o, got_ra = lens.trace(tr, forward=fwd, record=True)
        np.testing.assert_array_equal(got_ra.numpy(), np.asarray(ref_ra))
        live = np.asarray(ref_ra) > 0
        assert np.abs(got_o.numpy() - np.asarray(ref_o))[live].max() <= 2e-4
    rng = list(range(3, 9))
    ref, ref_o, _ = jlens.trace(jr, lens_range=rng, record=True)
    got, got_o, _ = lens.trace(tr, lens_range=rng, record=True)
    assert got_o.shape[0] == 6
    assert lens.trace(tr, lens_range=[], record=True)[1] is None
    eta, _ = jlens.eta_arrays(0.589, True)
    ref = jax_trace_spec(jr, jlens.static_desc(), eta)
    got = trace_rays_specialized(tr, lens.static_desc(), lens.eta_arrays(0.589, True)[0])
    np.testing.assert_array_equal(got.ra.numpy(), np.asarray(ref.ra))
    live = np.asarray(ref.ra) > 0
    assert np.abs(got.o.numpy() - np.asarray(ref.o))[live].max() <= 2e-4
    assert np.abs(got.d.numpy() - np.asarray(ref.d))[live].max() <= 2e-6
    plain = lens.trace(tr)
    np.testing.assert_array_equal(got.ra.numpy(), plain.ra.numpy())
    assert (got.o - plain.o)[plain.ra > 0].abs().max() <= 2e-4


def test_dp_psf_specialised_route(lenses):
    """dp_psf through the specialised trace against the JAX dp_psf with its
    static description, on the same pupil samples."""
    lens, jlens = lenses
    key = jax.random.PRNGKey(2)
    pts = np.array([[0.0, 0.0, -900.0], [0.5, -0.4, -3000.0]], np.float32)
    eta, skip = jlens.eta_arrays(0.589, True)
    ref = jax_dp_psf(jlens.stack, eta, skip, jnp.asarray(pts), key, jax_lens_scalars(jlens),
                     spp=512, ks=11, spp_chief=256, static_desc=jlens.static_desc())
    kc, km = jax.random.split(key)
    _, pupilr = jlens.entrance_pupil()
    chief = np.asarray(jax_sampling.sample_disk(kc, (256,), pupilr * 0.25))
    main = np.asarray(jax_sampling.sample_disk(km, (512,), pupilr))
    e2, s2 = lens.eta_arrays(0.589, True)
    got = dp_psf(lens.stack, e2, s2, pts, None, lens_scalars(lens), spp=512, ks=11,
                 spp_chief=256, pupil_main=main, pupil_chief=chief,
                 static_desc=lens.static_desc())
    for g, r in zip(got, ref):
        assert np.abs(g.numpy() - np.asarray(r)).max() <= 2e-2


def test_lens_scalars_and_focus(lenses):
    lens, jlens = lenses
    assert lens.calc_eqfl() == pytest.approx(jlens.calc_eqfl(), rel=1e-6)
    assert lens.calc_bfl() == pytest.approx(jlens.calc_bfl(), abs=2e-4)
    assert lens.calc_scale_pinhole(-1234.0) == pytest.approx(
        jlens.calc_scale_pinhole(-1234.0), rel=1e-6)
    assert lens.surface_count == jlens.surface_count
    assert lens.find_diff_surf() == jlens.find_diff_surf()
    draws = _draws(jax.random.PRNGKey(42), (8, 64, 21, 21))
    assert lens.calc_magnification3(-1000.0, draws=draws) == pytest.approx(
        jlens.calc_magnification3(-1000.0), rel=1e-5)
    tr = Rays.create(np.array([[0.0, 1.0, -500.0]], np.float32),
                     np.array([[0.0, 0.0, 1.0]], np.float32))
    jr = jax_sampling.Rays.create(np.array([[0.0, 1.0, -500.0]], np.float32),
                                  np.array([[0.0, 0.0, 1.0]], np.float32))
    _close(lens.trace2obj(tr, 80.0).o, jlens.trace2obj(jr, 80.0).o, 2e-4)
    # on copies: the module's lenses stay at the shared sensor distance
    inf, jinf = copy.copy(lens), copy.copy(jlens)
    inf.refocus_inf()
    jinf.refocus_inf()
    assert inf.d_sensor == pytest.approx(float(jinf.d_sensor), abs=2e-4)
    assert lens.d_sensor == float(jlens.d_sensor)
    other = Lens(device="cpu")
    other.load_external(lens.stack, lens.materials, lens.r_last, 70.0)
    assert other.d_sensor == 70.0 and other.surface_count == lens.surface_count


def test_psf2mtf(lenses):
    lens, jlens = lenses
    psf = np.random.default_rng(0).uniform(0, 1, (33, 33)).astype(np.float32)
    for g, r in zip(analysis.psf2mtf(lens, psf), jax_analysis.psf2mtf(jlens, psf)):
        _close(g, r, 1e-6)


def test_analysis_rms_same_samples(lenses):
    lens, jlens = lenses
    depth = -1500.0
    key = jax.random.PRNGKey(3)
    ref = jax_analysis.analysis_rms(jlens, depth, key=key)
    shape = sampling.stratified_shape((31, 31), GEO_SPP)
    draws = [_draws(k, shape) for k in jax.random.split(key, 4)]
    mag = _draws(jax.random.PRNGKey(42), (8, 64, 21, 21))
    got = analysis.analysis_rms(lens, depth, draws=draws, mag_draws=mag)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6)


def test_draw_psf_map_same_samples(lenses, tmp_path):
    lens, jlens = lenses
    depth, grid, ks, spp = -800.0, 3, 15, 512
    key = jax.random.PRNGKey(4)
    ref = jax_analysis.draw_psf_map(jlens, grid=grid, depth=depth, ks=ks, spp=spp,
                                    save_name=str(tmp_path / "jax"), key=key)
    _, pupilr = jlens.entrance_pupil()
    pupils = []
    for k in jax.random.split(key, 3):
        kc, km = jax.random.split(k)
        pupils.append((np.asarray(jax_sampling.sample_disk(km, (spp,), pupilr)),
                       np.asarray(jax_sampling.sample_disk(kc, (GEO_SPP,), pupilr * 0.25))))
    got = analysis.draw_psf_map(lens, grid=grid, depth=depth, ks=ks, spp=spp,
                                save_name=str(tmp_path / "port"), pupils=pupils)
    assert got.shape == (grid * ks, grid * ks, 3)
    diff = np.abs(got - ref)
    assert diff.mean() <= 1e-5 and diff.max() <= 1e-3
    png = read_png(str(tmp_path / "port_psf800mm_left.png"))
    assert png.shape == got.shape and png.dtype == np.uint8
    np.testing.assert_array_equal(np.load(str(tmp_path / "port_psf800mm_left.npz"))["psf_map"],
                                  got)


def test_setup_and_diagrams(lenses, tmp_path):
    """The set-up drawing's ray paths against the JAX recording trace, and
    the spot, distortion, MTF and radial figures as data."""
    lens, jlens = lenses
    out = analysis.plot_setup2d_with_trace(lens, str(tmp_path / "setup"))
    n = lens.stack.num_surfaces
    assert len(out["paths"]) == 3 and out["paths"][0].shape == (n + 2, 9, 3)
    pupil = jlens.entrance_pupil()
    for i, view in enumerate(out["views"]):
        rays = jax_sampling.sample_parallel_2d(view=view, M=9, pupil=pupil)
        _, os_, ras = jlens.trace(rays, wvln=(0.486, 0.589, 0.656)[i], record=True)
        live = np.asarray(ras)[-1] > 0
        assert np.abs(out["paths"][i][1:-1][:, live] - np.asarray(os_)[:, live]).max() <= 2e-4
    assert out["title"].startswith("FoV") and len(out["lines"]) > n
    z = np.load(str(tmp_path / "setup.npz"))
    assert "path_2" in z.files and "line_000" in z.files
    key = jax.random.PRNGKey(6)
    dist = analysis.draw_distortion(lens, -2000.0, M=4, save_name=str(tmp_path / "d"),
                                    draws=_draws(key, (8, 256, 4, 4)))
    ref_rays = jlens.sample_point_source(key, depth=-2000.0,
                                         R=lens.sensor_size[0] / 2 * lens.calc_scale_pinhole(-2000.0),
                                         M=4, spp=GEO_SPP)
    ref_out = jlens.trace(ref_rays)
    o2 = np.asarray(ref_out.project_to(jlens.d_sensor))
    ra = np.asarray(ref_out.ra)
    _close(dist["traced"][0], (o2[..., 0] * ra).sum(0) / ra.sum(0), 1e-4)
    spots = analysis.draw_spot_diagram(lens, M=3, depth=-2000.0, save_name=str(tmp_path / "s"),
                                       generator=torch.Generator().manual_seed(0))
    assert spots["xy"].shape == (1024, 3, 3, 2) and np.isfinite(spots["centroid"]).all()
    radial = analysis.draw_spot_radial(lens, M=2, depth=-2000.0, save_name=str(tmp_path / "s"),
                                       generator=torch.Generator().manual_seed(0))
    assert radial["xy"].shape == (1024, 2, 2)
    mtf = analysis.draw_mtf(lens, relative_fov=(0.0, 0.7), depth=-2000.0,
                            save_name=str(tmp_path / "mtf.png"))
    assert mtf["tangential"].shape == (1, 2, len(mtf["freq"]))
    strip = analysis.draw_psf_radial(lens, M=2, depth=-2000.0, ks=11,
                                     save_name=str(tmp_path / "radial.png"))
    assert read_png(str(tmp_path / "radial.png")).shape == (11, 22, 3)
    assert strip.shape == (2, 11, 11, 3)
    for name in ("s_spot2000mm.npz", "s_spot2000mm_radial.npz", "d_distortion2000mm.npz",
                 "mtf.npz", "radial.npz"):
        assert os.path.exists(str(tmp_path / name)), name


def test_png_writer_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    for img in (rng.integers(0, 256, (7, 9), dtype=np.uint8),
                rng.integers(0, 256, (5, 6, 3), dtype=np.uint8)):
        path = write_png(str(tmp_path / "a.png"), img)
        np.testing.assert_array_equal(read_png(path), img)
    path = write_png(str(tmp_path / "f.png"), np.array([[0.0, 0.5, 1.0, 2.0]]))
    np.testing.assert_array_equal(read_png(path), [[0, 128, 255, 255]])
    with pytest.raises(ValueError):
        write_png(str(tmp_path / "b.png"), np.zeros((2, 2, 4), np.uint8))


FIT_CPU = ["--device", "cpu", "--bs", "4", "--spp", "256", "--iters", "1",
           "--evaluate-every", "2", "--eval-bs", "16", "--eval-spp", "512"]


def test_fit_psfnet_with_analysis(tmp_path, monkeypatch, capsys):
    """python -m sdirt_tpu_torch.fit_psfnet on the CPU without
    --skip-analysis: the analysis at -500 and -20000 mm writes its set-up
    data and PSF maps, prints the JAX package's RMS line, and its radii
    fall within the JAX CPU reference's tolerance
    (sdirt_tpu_torch/reference/analysis_jax_cpu.json)."""
    import json

    monkeypatch.chdir(ROOT)
    out = str(tmp_path / "fit")
    res = fit_psfnet.main(FIT_CPU + ["--result-dir", out])
    printed = capsys.readouterr().out
    assert printed.count("On-axis RMS radius: ") == 2
    assert "Avg RMS spot size (radius): " in printed
    with open(os.path.join(ROOT, "sdirt_tpu_torch", "reference", "analysis_jax_cpu.json")) as f:
        ref = json.load(f)["stats"]
    for depth, (avg, on, off) in res["analysis"].items():
        tag = int(depth)
        assert os.path.exists(f"{out}/{tag}.npz")
        png = read_png(f"{out}/{tag}_psf{-tag}mm_left.png")
        assert png.shape == (9 * 21, 9 * 21, 3)
        st = ref[str(depth)]
        for k, v in (("rms_avg", avg), ("rms_on", on), ("rms_off", off)):
            assert abs(v - st[k]["mean"]) <= st[k]["tolerance"], (depth, k)
    for name in ("compare_-500_v00.png", "compare_-20000_v08.png", "compare_psf.npz"):
        assert os.path.exists(os.path.join(out, name)), name
    assert read_png(os.path.join(out, "compare_-500_v04.png")).shape == (42, 42)
    assert set(res["seconds"]["analysis"]) == set(res["analysis"])
