"""The PyTorch port's render path against the JAX package on the CPU:
PSFMLP, the tap-major bf16 MLP, the plain version of the fused DP conv
(held against the Pallas kernel in interpret mode), local_dp_conv and
render_dp. Inputs come from numpy with a seed and go to both sides.

The CUDA kernel itself runs only on the card: tests/test_torch_kernels.py.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdirt_tpu.psfnet.arch import build_psfnet as jax_build_psfnet
from sdirt_tpu.render.fused_conv_pallas import \
    fused_dp_conv_tapmajor as jax_fused_conv
from sdirt_tpu.render.mlp_fast import mlp_psf_tapmajor as jax_mlp_tapmajor
from sdirt_tpu.render.perpixel import local_dp_conv as jax_local_dp_conv
from sdirt_tpu.render.pipeline import render_dp as jax_render_dp
from sdirt_tpu_torch.psfnet.arch import build_psfnet
from sdirt_tpu_torch.render import fused_conv
from sdirt_tpu_torch.render.mlp_fast import mlp_psf_tapmajor
from sdirt_tpu_torch.render.perpixel import local_dp_conv
from sdirt_tpu_torch.render.pipeline import render_dp
from sdirt_tpu_torch.utils.weights import flax_to_torch

KS = 7
N, H, W, C = 2, 16, 24, 3


@pytest.fixture(scope="module")
def nets():
    """A Flax PSFMLP (seeded init) and its carried-across torch copy."""
    jnet = jax_build_psfnet("mlp", KS)
    params = jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, 3)))
    flat = flax.traverse_util.flatten_dict(params, sep="/")
    tnet = build_psfnet("mlp", KS)
    tnet.load_state_dict(flax_to_torch({k: np.asarray(v) for k, v in flat.items()}))
    return jnet, params, tnet.eval()


def _queries(rng, shape):
    o = rng.uniform(-1, 1, (*shape, 3)).astype(np.float32)
    o[..., 2] = rng.uniform(0, 1, shape)
    return o


def test_psfmlp_f32_matches_flax(nets):
    jnet, params, tnet = nets
    x = _queries(np.random.default_rng(0), (257,))
    ref = np.asarray(jnet.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tnet(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_mlp_psf_tapmajor_bf16_matches_jax(nets):
    jnet, params, tnet = nets
    o = _queries(np.random.default_rng(1), (N, H, W))
    ref = np.asarray(jax_mlp_tapmajor(params, jnp.asarray(o), KS), np.float32)
    with torch.no_grad():
        got = mlp_psf_tapmajor(tnet, torch.from_numpy(o), KS)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == ref.shape
    # sum-normalised per pixel and view, in the bf16 rounding band of the JAX
    # package's own test of this function (tests/test_fused_render.py)
    got = got.float().numpy()
    norm = lambda p: p / (p.sum(0, keepdims=True) + 1e-9)
    np.testing.assert_allclose(norm(got), norm(ref), rtol=0, atol=5e-3)


def _conv_inputs(seed, n, h, w, c, ks):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, (n, h, w, c)).astype(np.float32)
    psf = rng.uniform(0, 1, (ks * ks, n, 2, h * w)).astype(np.float32)
    psf_bf = torch.from_numpy(psf).to(torch.bfloat16)
    return img, psf_bf


@pytest.mark.parametrize("n,h,w,c,th", [(2, 16, 24, 3, 8), (1, 13, 24, 3, 1),
                                        (1, 16, 19, 1, 8)],
                         ids=["16x24", "ragged_h13", "w19_c1"])
def test_fused_conv_plain_matches_pallas_interpret(n, h, w, c, th):
    img, psf_bf = _conv_inputs(3, n, h, w, c, KS)
    psf_j = jnp.asarray(psf_bf.float().numpy()).astype(jnp.bfloat16)
    rl_j, rr_j = jax_fused_conv(jnp.asarray(img), psf_j, KS, th=th,
                                interpret=True)
    rl, rr = fused_conv.fused_dp_conv_tapmajor_ref(torch.from_numpy(img),
                                                   psf_bf, KS)
    # the same f32 products of bf16 inputs, summed in another order
    np.testing.assert_allclose(rl.numpy(), np.asarray(rl_j), rtol=0, atol=5e-3)
    np.testing.assert_allclose(rr.numpy(), np.asarray(rr_j), rtol=0, atol=5e-3)


def test_fused_conv_batch_order(nets):
    """Sample n of a batched render equals rendering sample n alone."""
    _, _, tnet = nets
    rng = np.random.default_rng(4)
    o = torch.from_numpy(_queries(rng, (N, H, W)))
    img = torch.from_numpy(rng.uniform(0, 1, (N, H, W, C)).astype(np.float32))
    with torch.no_grad():
        rl, rr = fused_conv.fused_dp_conv_tapmajor(
            img, mlp_psf_tapmajor(tnet, o, KS), KS)
        rl1, rr1 = fused_conv.fused_dp_conv_tapmajor(
            img[1:2], mlp_psf_tapmajor(tnet, o[1:2], KS), KS)
    np.testing.assert_allclose(rl[1:2].numpy(), rl1.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(rr[1:2].numpy(), rr1.numpy(), rtol=0, atol=1e-6)


def test_wrapper_on_cpu_takes_plain_version():
    img, psf_bf = _conv_inputs(5, 1, 8, 8, 3, 3)
    before = fused_conv.launches
    got = fused_conv.fused_dp_conv_tapmajor(torch.from_numpy(img), psf_bf, 3)
    ref = fused_conv.fused_dp_conv_tapmajor_ref(torch.from_numpy(img), psf_bf, 3)
    assert fused_conv.launches == before
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        fused_conv.fused_dp_conv_tapmajor(torch.from_numpy(img), psf_bf[:, :, :1], 3)


def test_kernel_tile_shared_memory():
    """K2's tile in shared memory: (8 + ks - 1) rows x (128 + 8 ceil(ks/8))
    columns x C of bf16, and the largest ks that fits 227 KB."""
    assert fused_conv.smem_bytes(3, 21) == 3 * 28 * 152 * 2 == 25536
    assert fused_conv.smem_bytes(1, 1) == 8 * 136 * 2
    for c in fused_conv.CHANNELS:
        ks = fused_conv.max_ks(c)
        assert ks % 2 == 1
        assert fused_conv.smem_bytes(c, ks) <= fused_conv.SMEM_LIMIT
        assert fused_conv.smem_bytes(c, ks + 2) > fused_conv.SMEM_LIMIT
    assert (fused_conv.max_ks(3), fused_conv.max_ks(1)) == (135, 277)


@pytest.mark.parametrize("mirror_right", [False, True])
def test_local_dp_conv_matches_jax(mirror_right):
    rng = np.random.default_rng(6)
    img = rng.uniform(0, 1, (N, H, W, C)).astype(np.float32)
    psf = rng.uniform(0, 1, (N, H, W, 2, KS, KS)).astype(np.float32)
    rl_j, rr_j = jax_local_dp_conv(jnp.asarray(img), jnp.asarray(psf), KS,
                                   mirror_right=mirror_right)
    rl, rr = local_dp_conv(torch.from_numpy(img), torch.from_numpy(psf), KS,
                           mirror_right=mirror_right)
    # the same f32 products of bf16 inputs, summed in the same order
    np.testing.assert_allclose(rl.numpy(), np.asarray(rl_j), rtol=1e-6, atol=0)
    np.testing.assert_allclose(rr.numpy(), np.asarray(rr_j), rtol=1e-6, atol=0)


@pytest.mark.parametrize("variant", ["fused", "scan"])
def test_render_dp_matches_jax(nets, variant):
    jnet, params, tnet = nets
    rng = np.random.default_rng(2)
    img = rng.uniform(0, 1, (N, C, H, W)).astype(np.float32)
    depth = -rng.uniform(100, 1000, (N, 1, H, W)).astype(np.float32)
    kw = dict(d_sensor=62.25, d_min=-200.0, d_max=-20000.0, ks=KS)
    ref = np.asarray(jax_render_dp(jnet.apply, params, img, depth, [-1000.0],
                                   variant=variant, scan_right="flip", **kw))
    got = render_dp(tnet, torch.from_numpy(img), torch.from_numpy(depth),
                    [-1000.0], variant=variant, **kw)
    assert tuple(got.shape) == (N, 2 * C, H, W)
    # the JAX package's own fused-vs-scan band (tests/test_fused_render.py)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-2)
