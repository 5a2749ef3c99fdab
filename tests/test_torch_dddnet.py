"""The PyTorch port's DDDNet against the JAX package on the CPU: the signed
DP cost volume, the resizes, and full Basenet forwards with carried-across
parameters (JAX-initialised, and the shipped Sdirt_best_acc1).

Sizes: 128x192 is the smallest input the feature tower's 32x32 pooling
branch accepts (at 64x96 the JAX net itself fails on an empty axis).
"""

import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdirt_tpu.dfdp.basenet import Basenet as JaxBasenet
from sdirt_tpu.dfdp.models import dddnet as J
from sdirt_tpu.dfdp.models import layers as JL
from sdirt_tpu_torch.dfdp.basenet import build_basenet
from sdirt_tpu_torch.dfdp.models import dddnet as T
from sdirt_tpu_torch.dfdp.models import layers as TL
from sdirt_tpu_torch.utils.weights import flax_to_torch, load_npz

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "sdirt_tpu_torch", "weights", "rf50mm",
                       "Sdirt_best_acc1.npz")


def test_dp_cost_volume_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 7, 23)).astype(np.float32)    # [B, C, H, W]
    y = rng.normal(size=(2, 5, 7, 23)).astype(np.float32)
    ref = np.asarray(J.dp_cost_volume(jnp.asarray(x.transpose(0, 2, 3, 1)),
                                      jnp.asarray(y.transpose(0, 2, 3, 1))))
    got = T.dp_cost_volume(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    np.testing.assert_array_equal(got.transpose(0, 2, 3, 4, 1), ref)


@pytest.mark.parametrize("src,dst", [((4, 6), (32, 48)), ((1, 1), (32, 48)),
                                     ((5, 8, 12), (10, 16, 24))])
def test_resize_align_corners_matches_jax(src, dst):
    x = np.random.default_rng(1).normal(size=(1, 3, *src)).astype(np.float32)
    axes = tuple(range(2, 2 + len(src)))
    ref = np.asarray(JL.resize_linear_align_corners(
        jnp.asarray(np.moveaxis(x, 1, -1)), dst, tuple(a - 1 for a in axes)))
    got = TL.resize_linear_align_corners(torch.from_numpy(x), dst, axes).numpy()
    np.testing.assert_allclose(np.moveaxis(got, 1, -1), ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("dst", [(16, 24), (5, 7)], ids=["up", "down"])
def test_resize_bilinear_half_pixel_matches_jax(dst):
    x = np.random.default_rng(2).normal(size=(1, 3, 8, 12)).astype(np.float32)
    ref = np.asarray(JL.resize_bilinear(jnp.asarray(x.transpose(0, 2, 3, 1)),
                                        dst, align_corners=False))
    got = TL.resize_bilinear(torch.from_numpy(x), dst, align_corners=False)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), ref,
                               rtol=0, atol=1e-5)


def _torch_net(flat):
    net = build_basenet(device="cpu")
    state = flax_to_torch(flat)
    for k, v in net.state_dict().items():
        if k.endswith("num_batches_tracked"):
            state[k] = v
    net.load_state_dict(state, strict=True)
    return net


def _forward_pair(variables, x):
    ref = np.asarray(JaxBasenet().apply(variables, jnp.asarray(x),
                                        train=False)["pred_depth_est"])
    flat = {k: np.asarray(v) for k, v in
            flax.traverse_util.flatten_dict(variables, sep="/").items()}
    with torch.no_grad():
        got = _torch_net(flat)(torch.from_numpy(x))["pred_depth_est"].numpy()
    return got, ref


def test_basenet_forward_jax_init_matches():
    """JAX-initialised parameters with perturbed BatchNorm statistics, so that
    every carried-across leaf (HWIO/DHWIO kernels, the flipped transposed
    kernel, BN scale/bias/mean/var) shapes the output."""
    x = np.random.default_rng(3).uniform(0, 1, (1, 6, 128, 192)).astype(np.float32)
    variables = JaxBasenet().init(jax.random.PRNGKey(0), jnp.asarray(x),
                                  train=False)
    rng = np.random.default_rng(4)
    perturb = lambda t, lo, hi: jnp.asarray(rng.uniform(lo, hi, t.shape),
                                            jnp.float32)
    variables = flax.core.unfreeze(variables)
    flat = flax.traverse_util.flatten_dict(variables, sep="/")
    for k in flat:
        leaf = k.rsplit("/", 1)[-1]
        if leaf == "mean" or (leaf == "bias" and "BatchNorm" in k):
            flat[k] = perturb(flat[k], -0.1, 0.1)
        elif leaf in ("var", "scale"):
            flat[k] = perturb(flat[k], 0.5, 1.5)
    variables = flax.traverse_util.unflatten_dict(flat, sep="/")
    got, ref = _forward_pair(variables, x)
    assert got.shape == ref.shape == (1, 1, 128, 192)
    # f32 convolutions summed in another order
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_basenet_shipped_weights_on_real_crop():
    """The exported Sdirt_best_acc1 on a 128x192 crop of a real F/4 pair."""
    from sdirt_tpu_torch.dfdp.datasets import CanonFlat2DepthSet

    imgs, _ = CanonFlat2DepthSet(os.path.join(ROOT, "real_sample_set", "flat"),
                                 resize=(512, 768))[0]
    x = np.ascontiguousarray(imgs[None, :, 192:320, 288:480])
    variables = flax.traverse_util.unflatten_dict(load_npz(WEIGHTS), sep="/")
    got, ref = _forward_pair(variables, x)
    # f32 convolutions summed in another order (measured gap ~2e-6 here)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
