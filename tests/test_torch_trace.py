"""K1's plain version (sdirt_tpu_torch/dp/fused_trace.py:
fused_trace_sensor_ref, which the CUDA kernel is held against on the card)
against the JAX package on the CPU: its specialized trace + propagate_to
(the reference of tests/test_fused_trace.py) and the Pallas kernel itself
in interpret mode."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdirt_tpu.dp.fused_trace import fused_trace_sensor as jax_fused_trace
from sdirt_tpu.dp.fused_trace import make_fused_plan as jax_make_plan
from sdirt_tpu.dp.psf import lens_scalars as jax_lens_scalars
from sdirt_tpu.optics.lens import Lens as JLens
from sdirt_tpu.optics.sampling import sample_from_points as jax_sample
from sdirt_tpu.optics.surfaces import trace_rays_specialized
from sdirt_tpu_torch.core.rays import Rays
from sdirt_tpu_torch.dp import fused_trace
from sdirt_tpu_torch.optics.lens import Lens

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", params=("rf50mm", "rf35mm"))
def lenses(request):
    path = os.path.join(ROOT, "lenses", request.param, "lens_web.json")
    return Lens(path, sensor_res=(512, 768), device="cpu"), JLens(path, sensor_res=(512, 768))


def _jax_rays(jlens, key, spp, depths):
    """tests/test_fused_trace.py's bundle: four field points, pupil samples
    from the JAX sampler."""
    points = jnp.asarray(
        [[0.0, 0.0, depths[0]], [0.7, 0.3, depths[1 % len(depths)]],
         [-0.5, -0.9, depths[0]], [0.2, -0.4, depths[-1]]], jnp.float32)
    sc = jax_lens_scalars(jlens)
    scale = -points[:, 2] * jnp.tan(sc["hfov"]) / sc["r_last"]
    obj = jnp.stack([points[:, 0] * scale * sc["sensor_w"] / 2,
                     points[:, 1] * scale * sc["sensor_h"] / 2, points[:, 2]], -1)
    return jax_sample(key, obj, spp, sc["pupilz"], sc["pupilr"])


def _to_torch(rays):
    return Rays(o=torch.tensor(np.asarray(rays.o)), d=torch.tensor(np.asarray(rays.d)),
                ra=torch.tensor(np.asarray(rays.ra)))


def test_plan_matches_jax(lenses):
    lens, jlens = lenses
    plan = fused_trace.make_fused_plan(lens)
    ref = jax_make_plan(jlens, interpret=True)
    assert plan.surfaces == ref.surfaces
    assert plan.eta == ref.eta
    # the table folds each constant in double and rounds it once to f32
    for s, surf in zip(fused_trace._surface_table(plan), plan.surfaces):
        kind, c, k, ai, d, r, skip = surf
        assert s["rap2"] == float(np.float32(r * r))
        assert s["d"] == d and s["skip"] == int(skip)
        if c != 0.0:
            assert s["cz"] == float(np.float32(d + 1.0 / c))


def test_plain_matches_specialized(lenses):
    lens, jlens = lenses
    rays = _jax_rays(jlens, jax.random.PRNGKey(3), 192, (-1000.0, -2500.0))
    eta, _ = jlens.eta_arrays(0.589, True)
    out = trace_rays_specialized(rays, jlens.static_desc(), eta).propagate_to(jlens.d_sensor)
    ref = (-np.asarray(out.o[..., 0]), -np.asarray(out.o[..., 1]),
           -np.asarray(out.d[..., 0]) / np.asarray(out.d[..., 2]), np.asarray(out.ra))
    plan = fused_trace.make_fused_plan(lens)
    got = [a.numpy() for a in fused_trace.fused_trace_sensor_ref(
        _to_torch(rays), lens.d_sensor, plan)]
    np.testing.assert_array_equal(got[3], ref[3])
    m = ref[3] > 0
    assert m.mean() > 0.5
    # the JAX package's fused-vs-specialized gate (tests/test_fused_trace.py)
    for i in (0, 1):
        np.testing.assert_allclose(got[i][m], ref[i][m], rtol=0, atol=5e-4)
    np.testing.assert_allclose(got[2][m], ref[2][m], rtol=0, atol=5e-5)


def test_plain_matches_pallas_interpret(lenses):
    """A ragged 37 x 4 bundle through the Pallas kernel in interpret mode
    (block_rows 8, so it is padded) and through the plain version."""
    lens, jlens = lenses
    rays = _jax_rays(jlens, jax.random.PRNGKey(11), 37, (-1200.0,))
    ref = [np.asarray(a) for a in jax_fused_trace(
        rays, jlens.d_sensor, jax_make_plan(jlens, block_rows=8, interpret=True))]
    before = fused_trace.launches
    got = [a.numpy() for a in fused_trace.fused_trace_sensor(
        _to_torch(rays), lens.d_sensor, fused_trace.make_fused_plan(lens))]
    assert fused_trace.launches == before          # the CPU takes the plain version
    assert got[0].shape == (37, 4)
    np.testing.assert_array_equal(got[3], ref[3])
    m = ref[3] > 0
    for i in (0, 1):
        np.testing.assert_allclose(got[i][m], ref[i][m], rtol=0, atol=5e-4)
    np.testing.assert_allclose(got[2][m], ref[2][m], rtol=0, atol=5e-5)


def test_ops_per_ray_counts_every_surface(lenses):
    lens, _ = lenses
    plan = fused_trace.make_fused_plan(lens)
    table = fused_trace._surface_table(plan)
    ops = fused_trace.ops_per_ray(plan)
    # each refracting pure sphere costs 4 + 59 + 6 + 28 operations
    n_sphere = sum(s["path"] == fused_trace.PATH_SPHERE for s in table)
    assert ops > 97 * n_sphere
    assert fused_trace.ops_per_ray(plan, maxiter=3) > ops


def test_wrapper_rejects_bad_rays(lenses):
    lens, _ = lenses
    plan = fused_trace.make_fused_plan(lens)
    o = torch.zeros((4, 2, 3))
    d = torch.zeros((4, 2, 3))
    d[..., 2] = 1.0
    ra = torch.ones((4, 2))
    with pytest.raises(TypeError):
        fused_trace.fused_trace_sensor(Rays(o=o.double(), d=d, ra=ra), 60.0, plan)
    with pytest.raises(ValueError):
        fused_trace.fused_trace_sensor(Rays(o=o, d=d, ra=ra[:, :1]), 60.0, plan)
    with pytest.raises(ValueError, match="no kernel"):
        meta = Rays(o=o.to("meta"), d=d.to("meta"), ra=ra.to("meta"))
        fused_trace.fused_trace_sensor(meta, 60.0, plan)
