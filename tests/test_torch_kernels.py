"""The PyTorch port's CUDA kernels (K1 fused trace, K2 fused DP conv)
against their plain PyTorch versions, on the card. Every test here is marked ``gpu`` and skips without a card.

This file imports neither JAX nor the JAX package, so it also runs on a
machine with only PyTorch and the CUDA toolkit (tests/conftest.py imports
JAX, hence ``--noconftest``):

  python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels.py
"""

import os

import numpy as np
import pytest
import torch

from sdirt_tpu_torch.dp import fused_trace
from sdirt_tpu_torch.dp.psf import dp_psf_fused, lens_scalars, object_points
from sdirt_tpu_torch.optics.lens import Lens
from sdirt_tpu_torch.optics.sampling import sample_disk, sample_from_points
from sdirt_tpu_torch.render import fused_conv

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _conv_inputs(seed, n, h, w, c, ks, device):
    rng = np.random.default_rng(seed)
    img = torch.from_numpy(rng.uniform(0, 1, (n, h, w, c)).astype(np.float32))
    psf = torch.from_numpy(rng.uniform(0, 1, (ks * ks, n, 2, h * w))
                           .astype(np.float32)).to(torch.bfloat16)
    return img.to(device), psf.to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("n,h,w,c,ks", [(1, 512, 768, 3, 21), (1, 500, 750, 3, 21),
                                        (2, 40, 56, 3, 21), (1, 37, 29, 1, 7)],
                         ids=["serve", "ragged", "batch2", "c1_ks7"])
def test_fused_dp_conv_kernel_matches_plain(n, h, w, c, ks):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    img, psf = _conv_inputs(7, n, h, w, c, ks, "cuda")
    before = fused_conv.launches
    rl, rr = fused_conv.fused_dp_conv_tapmajor(img, psf, ks)
    ref_l, ref_r = fused_conv.fused_dp_conv_tapmajor_ref(img, psf, ks)
    torch.cuda.synchronize()
    assert fused_conv.launches == before + 1
    # the same exact f32 products, summed in the same order; the tap sums'
    # reduction and the divide differ, a few f32 ulps of the output
    assert float((rl - ref_l).abs().max()) <= 1e-3
    assert float((rr - ref_r).abs().max()) <= 1e-3


@pytest.mark.gpu
def test_fused_dp_conv_kernel_rejects_bad_input():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    img, psf = _conv_inputs(8, 1, 16, 24, 3, 7, "cuda")
    with pytest.raises(TypeError):
        fused_conv.fused_dp_conv_tapmajor(img, psf.float(), 7)
    with pytest.raises(ValueError):
        fused_conv.fused_dp_conv_tapmajor(img, psf.cpu(), 7)
    with pytest.raises(ValueError):
        fused_conv.fused_dp_conv_tapmajor(img[..., :1].repeat(1, 1, 1, 5),
                                          psf, 7)


def _lens(name):
    return Lens(os.path.join(ROOT, "lenses", name, "lens_web.json"),
                sensor_res=(512, 768), device="cuda")


def _field_points(seed, n):
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n),
                    -(rng.uniform(0, 1, n) * 19800 + 200)], -1).astype(np.float32)
    return torch.from_numpy(pts).cuda()


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["rf50mm", "rf35mm"])
@pytest.mark.parametrize("spp,n,shrink", [(20000, 64, 1.0), (2048, 64, 0.25),
                                          (37, 5, 1.0)],
                         ids=["main", "chief", "ragged"])
def test_fused_trace_kernel_matches_plain(name, spp, n, shrink):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    lens = _lens(name)
    plan = fused_trace.make_fused_plan(lens)
    sc = lens_scalars(lens)
    gen = torch.Generator(device="cuda").manual_seed(3)
    rays = sample_from_points(object_points(_field_points(1, n), sc), spp,
                              sc["pupilz"], sc["pupilr"] * shrink, gen)
    before = fused_trace.launches
    got = fused_trace.fused_trace_sensor(rays, lens.d_sensor, plan)
    ref = fused_trace.fused_trace_sensor_ref(rays, lens.d_sensor, plan)
    torch.cuda.synchronize()
    assert fused_trace.launches == before + 1
    assert all(g.shape == (spp, n) for g in got)
    # the same f32 operations in the same order (no FMA in the kernel): at
    # most 1 in 10^5 rays may flip validity; on rays live in both, the JAX
    # package's fused-vs-specialized gate
    assert int((got[3] != ref[3]).sum()) <= 1e-5 * spp * n
    live = (got[3] > 0) & (ref[3] > 0)
    assert float(live.float().mean()) > 0.5
    for i, tol in ((0, 5e-4), (1, 5e-4), (2, 1e-4)):
        assert float((got[i] - ref[i]).abs()[live].max()) <= tol


@pytest.mark.gpu
def test_fused_trace_kernel_psf_matches_plain():
    """Through dp_psf_fused with the same pupil samples: the
    ckpt/FUSED_TRACE.json gate (per-point PSF L1 mean <= 1e-4, max <= 1e-3)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    lens = _lens("rf50mm")
    sc = lens_scalars(lens)
    gen = torch.Generator(device="cuda").manual_seed(4)
    kw = dict(spp=20000, spp_chief=2048, ks=21,
              pupil_main=sample_disk(gen, (20000,), sc["pupilr"], "cuda"),
              pupil_chief=sample_disk(gen, (2048,), sc["pupilr"] * 0.25, "cuda"))
    pts = _field_points(2, 64)
    plan = fused_trace.make_fused_plan(lens)
    got = dp_psf_fused(pts, None, sc, plan, **kw)
    ref = dp_psf_fused(pts, None, sc, plan, trace=fused_trace.fused_trace_sensor_ref, **kw)
    l1 = torch.stack([(a - b).abs().mean((-1, -2)) for a, b in zip(got, ref)])
    assert float(l1.mean()) <= 1e-4 and float(l1.max()) <= 1e-3


@pytest.mark.gpu
def test_fused_trace_kernel_rejects_bad_input():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    lens = _lens("rf50mm")
    plan = fused_trace.make_fused_plan(lens)
    sc = lens_scalars(lens)
    rays = sample_from_points(object_points(_field_points(3, 4), sc), 16,
                              sc["pupilz"], sc["pupilr"],
                              torch.Generator(device="cuda").manual_seed(0))
    with pytest.raises(TypeError):
        fused_trace.fused_trace_sensor(rays.replace(d=rays.d.double()), 60.0, plan)
    with pytest.raises(ValueError):
        fused_trace.fused_trace_sensor(rays.replace(ra=rays.ra.cpu()), 60.0, plan)
