"""The PyTorch port's CUDA kernels against their plain PyTorch versions, on
the card. Every test here is marked ``gpu`` and skips without a card.

This file imports neither JAX nor the JAX package, so it also runs on a
machine with only PyTorch and the CUDA toolkit (tests/conftest.py imports
JAX, hence ``--noconftest``):

  python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from sdirt_tpu_torch.render import fused_conv


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
