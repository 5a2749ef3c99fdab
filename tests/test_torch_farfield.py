"""The PyTorch port's F/1.8 ks-35 path against the JAX package on the CPU:
the re-stopped and refocused lens, the exported F18_PSFNet_mlp_ks35
surrogate, K2's plain version at ks 35 (against the Pallas kernel in
interpret mode), the ``fused`` render at ks 35, and the far-field A/B
(``python -m sdirt_tpu_torch.eval_farfield_ab``) on 2 scenes.

Tolerances: geometry within 1e-6 relative; the surrogate's PSFs within
1e-5 (f32, measured 9.9e-8); K2's plain version within 5e-3 of the Pallas
kernel (tests/test_torch_render.py's band: the same f32 products of bf16
inputs summed in another order; measured 1.1e-6); the ks-35 render within
1e-2 of the JAX fused render (measured 3.3e-3), and within the JAX
package's own fused-vs-scan band of its scan render; the A/B's acc1
columns within 0.005 and its MAE columns within 0.5% of the JAX script's
(measured 8e-4 and 0.05%).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdirt_tpu.core.constants import GEO_SPP
from sdirt_tpu.optics.sampling import surface_sample as jax_surface_sample
from sdirt_tpu.psfnet.surrogate import PSFNetLens as JaxPSFNetLens
from sdirt_tpu.render.fused_conv_pallas import \
    fused_dp_conv_tapmajor as jax_fused_conv
from sdirt_tpu_torch import eval_farfield_ab
from sdirt_tpu_torch.dfdp.factory import ported_weights
from sdirt_tpu_torch.psfnet.surrogate import PSFNetLens
from sdirt_tpu_torch.render import fused_conv

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LENS = os.path.join(ROOT, "lenses", "rf50mm", "lens_web.json")
F18 = os.path.join(ROOT, "ckpt", "rf50mm", "F18_PSFNet_mlp_ks35")
REF = os.path.join(ROOT, "sdirt_tpu_torch", "reference",
                   "eval_farfield_ab_jax_cpu.json")
KS = 35


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test files at once on the machine's cores;
    this file's torch work keeps to two threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def f18_lenses():
    """(port, JAX) rf50mm surrogate lenses at F/1.8, ks 35, 64x96, with the
    exported / orbax F18_PSFNet_mlp_ks35."""
    tl = PSFNetLens(LENS, kernel_size=KS, sensor_res=(64, 96), device="cpu")
    jl = JaxPSFNetLens(LENS, kernel_size=KS, sensor_res=(64, 96))
    for lens in (tl, jl):
        lens.set_aperture(fnum=1.8)
    tl.load_net(ported_weights(F18))
    jl.load_net(F18)
    return tl, jl


def test_set_aperture_then_refocus_matches_jax(f18_lenses):
    """set_aperture(1.8), then refocus to 5 m on the JAX refocus's own
    surface samples: the f-number, the pupils, the aperture radius and the
    sensor distance within 1e-6 relative."""
    tl = PSFNetLens(LENS, kernel_size=KS, sensor_res=(64, 96), device="cpu")
    jl = JaxPSFNetLens(LENS, kernel_size=KS, sensor_res=(64, 96))
    for lens in (tl, jl):
        lens.set_aperture(fnum=1.8)
    np.testing.assert_allclose(tl.fnum, jl.fnum, rtol=1e-6)
    np.testing.assert_allclose(tl.entrance_pupil(), jl.entrance_pupil(), rtol=1e-6)
    np.testing.assert_allclose(tl.exit_pupil(), jl.exit_pupil(), rtol=1e-6)
    np.testing.assert_allclose(tl.stack.r.numpy(), np.asarray(jl.stack.r), rtol=1e-6)
    r0, d0 = float(jl.stack.r[0]), float(jl.stack.d[0])
    xy = np.asarray(jax_surface_sample(jax.random.PRNGKey(0), GEO_SPP, r0, d0))[:, :2]
    jl.refocus(-5000.0 + jl.d_sensor)
    tl.refocus(-5000.0 + tl.d_sensor, xy=xy)
    np.testing.assert_allclose(tl.d_sensor, jl.d_sensor, rtol=1e-6)
    np.testing.assert_allclose(tl.fnum, jl.fnum, rtol=1e-6)
    np.testing.assert_allclose(tl.entrance_pupil(), jl.entrance_pupil(), rtol=1e-6)


def test_f18_surrogate_psfs_match_jax(f18_lenses):
    """The exported ks-35 net's DP PSFs (sum-normalised, right view
    mirrored) at seeded query points."""
    tl, jl = f18_lenses
    rng = np.random.default_rng(0)
    inp = rng.uniform(-1, 1, (64, 3)).astype(np.float32)
    inp[:, 2] = rng.uniform(0, 1, 64)
    ref = np.asarray(jl.pred(inp))
    with torch.no_grad():
        got = tl.pred(inp).numpy()
    assert got.shape == ref.shape == (64, 2, KS, KS)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("n,h,w", [(1, 16, 24), (2, 24, 40)],
                         ids=["1x16x24", "2x24x40"])
def test_fused_conv_plain_ks35_matches_pallas_interpret(n, h, w):
    """K2's plain version at ks 35 (tap rows of 35: 4 full groups of 8 and a
    partial group of 3) against the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 1, (n, h, w, 3)).astype(np.float32)
    psf = torch.from_numpy(rng.uniform(0, 1, (KS * KS, n, 2, h * w))
                           .astype(np.float32)).to(torch.bfloat16)
    rl_j, rr_j = jax_fused_conv(jnp.asarray(img),
                                jnp.asarray(psf.float().numpy()).astype(jnp.bfloat16),
                                KS, th=8, interpret=True)
    rl, rr = fused_conv.fused_dp_conv_tapmajor_ref(torch.from_numpy(img), psf, KS)
    np.testing.assert_allclose(rl.numpy(), np.asarray(rl_j), rtol=0, atol=5e-3)
    np.testing.assert_allclose(rr.numpy(), np.asarray(rr_j), rtol=0, atol=5e-3)


def test_kernel_tile_shared_memory_ks35():
    """At C = 3, ks 35 a block holds 3 x 42 x 168 bf16 of image tile,
    41.3 KB; three blocks per SM take 124 KB of the 228 KB."""
    assert fused_conv.smem_bytes(3, KS) == 3 * 42 * 168 * 2 == 42336
    assert 3 * fused_conv.smem_bytes(3, KS) <= 228 * 1024
    assert KS <= fused_conv.max_ks(3)


def _gap(got, ref):
    """(max |got - ref|, share of values more than 1e-2 apart, PSNR dB)."""
    d = np.abs(got - ref)
    return float(d.max()), float((d > 1e-2).mean()), float(
        10 * np.log10(1.0 / np.mean(d.astype(np.float64) ** 2)))


@pytest.mark.parametrize("scene", ["noise", "synthetic"])
def test_fused_render_ks35_matches_jax(f18_lenses, monkeypatch, scene):
    """The port's ``fused`` render (tap-major MLP into K2's plain version)
    through the F/1.8 surrogate at 64x96, ks 35: within 1e-2 of the JAX
    ``fused`` render (measured 3.3e-3), and as close to the JAX ``scan``
    render as the JAX package's own fused render is. At ks 35 that band is
    wider than at ks 21: the JAX fused render is itself up to 8.2e-2 from
    its scan, with 0.64% of the values more than 1e-2 apart, at 53.4 dB on
    uniform noise (0.20% and 58.7 dB on a v2 synthetic scene); the bf16
    network's roundings differ between the two paths."""
    from sdirt_tpu_torch.dfdp.datasets import SyntheticRGBD

    tl, jl = f18_lenses
    rng = np.random.default_rng(2)
    if scene == "noise":
        img = rng.uniform(0, 1, (1, 3, 64, 96)).astype(np.float32)
        depth = -rng.uniform(300, 9000, (1, 1, 64, 96)).astype(np.float32)
    else:
        aif, gt = SyntheticRGBD((64, 96), length=1, seed=999, train=False,
                                style="v2")[0]
        img, depth = aif[None], -gt[None] * 1e3
    ref = {}
    for variant in ("scan", "fused"):
        monkeypatch.setenv("SDIRT_RENDER_VARIANT", variant)
        ref[variant] = np.asarray(jl.render(img, depth, [-1000.0]))
    got = tl.render(img, depth, [-1000.0], "fused").numpy()
    assert got.shape == ref["scan"].shape == (1, 6, 64, 96)
    np.testing.assert_allclose(got, ref["fused"], rtol=0, atol=1e-2)
    _, share, psnr = _gap(got, ref["scan"])
    _, jax_share, jax_psnr = _gap(ref["fused"], ref["scan"])
    assert share <= 1.1 * jax_share + 1e-3, (share, jax_share)
    assert psnr >= jax_psnr - 0.5, (psnr, jax_psnr)


def test_eval_farfield_ab_matches_jax_script(monkeypatch):
    """Both arms (f4: Sdirt_f4_farfield + F4_PSFNet_mlp, ks 21; f18:
    Sdirt_f18_farfield + F18_PSFNet_mlp_ks35, ks 35, F/1.8) on 2 v2 scenes
    at 128x192, on the CPU, against the JAX script's table on the same
    scenes (scripts/make_farfield_reference.py, "small")."""
    monkeypatch.chdir(ROOT)
    with open(REF) as f:
        ref = json.load(f)["small"]
    argv = ["--device", "cpu", *ref["argv"]]
    rows = eval_farfield_ab.main(argv)
    assert [r["name"] for r in rows] == list(ref["arms"])
    for r in rows:
        want = ref["arms"][r["name"]]
        for k in ("acc1", "far_acc1", "near_acc1"):
            assert abs(r[k] - want[k]) <= 0.005, (r["name"], k, r[k], want[k])
        for k in ("mae", "far_mae"):
            # the JAX script prints 3 decimals
            assert abs(r[k] - want[k]) <= 0.005 * want[k] + 5e-4, (r["name"], k)
        assert len(r["render_ms"]) == ref["val_len"]
