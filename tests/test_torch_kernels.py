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
                                        (2, 40, 56, 3, 21), (1, 37, 29, 1, 7),
                                        (1, 256, 384, 3, 35), (2, 250, 379, 3, 35)],
                         ids=["serve", "ragged", "batch2", "c1_ks7", "f18_ks35",
                              "ragged_ks35"])
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
@pytest.mark.parametrize("n,h,w,c,ks", [(2, 21, 45, 1, 1), (2, 13, 30, 3, 3),
                                        (1, 9, 21, 3, None), (2, 6, 13, 1, None)],
                         ids=["c1_ks1", "n2_ks3", "c3_max_ks", "c1_max_ks"])
def test_fused_dp_conv_kernel_tile_edges(n, h, w, c, ks):
    """The shapes the tiles make special: widths that are not a multiple of
    the 8 pixels a thread covers (the scalar tail), N = 2, C = 1, the
    smallest ks and the largest the shared memory takes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    ks = fused_conv.max_ks(c) if ks is None else ks
    img, psf = _conv_inputs(9, n, h, w, c, ks, "cuda")
    got = fused_conv.fused_dp_conv_tapmajor(img, psf, ks)
    ref = fused_conv.fused_dp_conv_tapmajor_ref(img, psf, ks)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert float((g - r).abs().max()) <= 1e-3


@pytest.mark.gpu
def test_fused_dp_conv_kernel_misaligned_psf():
    """A PSF whose rows start off the 16-byte grid takes the scalar loads."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    n, h, w, c, ks = 1, 16, 40, 3, 5
    img, psf = _conv_inputs(10, n, h, w, c, ks, "cuda")
    flat = torch.empty(psf.numel() + 1, dtype=psf.dtype, device="cuda")
    shifted = flat[1:].view(psf.shape)
    shifted.copy_(psf)
    got = fused_conv.fused_dp_conv_tapmajor(img, shifted, ks)
    ref = fused_conv.fused_dp_conv_tapmajor_ref(img, psf, ks)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert float((g - r).abs().max()) <= 1e-3


@pytest.mark.gpu
def test_fused_dp_conv_kernel_smem_matches_host():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from sdirt_tpu_torch.utils import kernels

    lib = kernels.library("fused_dp_conv")
    assert lib.fused_dp_conv_smem_limit() == fused_conv.SMEM_LIMIT
    for c in fused_conv.CHANNELS:
        for ks in (1, 21, fused_conv.max_ks(c), fused_conv.max_ks(c) + 2):
            assert lib.fused_dp_conv_smem_bytes(c, ks) == fused_conv.smem_bytes(c, ks)
    img, psf = _conv_inputs(11, 1, 4, 8, 3, 1, "cuda")
    big = fused_conv.max_ks(3) + 2
    with pytest.raises(ValueError, match="shared memory"):
        fused_conv.fused_dp_conv_tapmajor(img, torch.zeros((big * big, 1, 2, 32),
                                                           dtype=torch.bfloat16,
                                                           device="cuda"), big)


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
    # the plain version's roundings through the aperture stop, contracted
    # and approximate arithmetic after it: at most 1 in 10^5 rays may flip
    # validity; on rays live in both, the JAX package's fused-vs-specialized
    # gate
    assert int((got[3] != ref[3]).sum()) <= 1e-5 * spp * n
    live = (got[3] > 0) & (ref[3] > 0)
    assert float(live.float().mean()) > 0.5
    for i, tol in ((0, 5e-4), (1, 5e-4), (2, 1e-4)):
        assert float((got[i] - ref[i]).abs()[live].max()) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["rf50mm", "rf35mm"])
def test_fused_trace_kernel_reads_views(name):
    """Broadcast origins (stride 0, as the fit samples them), a copied
    contiguous bundle and a 1-D bundle give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    lens = _lens(name)
    plan = fused_trace.make_fused_plan(lens)
    sc = lens_scalars(lens)
    rays = sample_from_points(object_points(_field_points(5, 7), sc), 301,
                              sc["pupilz"], sc["pupilr"],
                              torch.Generator(device="cuda").manual_seed(5))
    assert rays.o.stride(0) == 0
    got = fused_trace.fused_trace_sensor(rays, lens.d_sensor, plan)
    dense = rays.replace(o=rays.o.contiguous())
    flat = rays.replace(o=dense.o.reshape(-1, 3), d=rays.d.reshape(-1, 3),
                        ra=rays.ra.reshape(-1))
    for other in (fused_trace.fused_trace_sensor(dense, lens.d_sensor, plan),
                  fused_trace.fused_trace_sensor(flat, lens.d_sensor, plan)):
        for g, o in zip(got, other):
            assert torch.equal(g, o.reshape(g.shape))


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
