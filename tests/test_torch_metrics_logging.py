"""The port's remaining metrics (dfdp/metrics.py), logging helpers
(utils/logging.py) and reference-checkpoint loader (psfnet/arch.py:
load_torch_psfnet) against the JAX package on the CPU: every metric
bit-equal on seeded float64 arrays, the counters' arithmetic, the profiler
scope's trace file, and the .pkl load equal to the JAX loader's.
"""

import json
import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdirt_tpu.dfdp import metrics as JM
from sdirt_tpu.psfnet.arch import build_psfnet as jax_build_psfnet
from sdirt_tpu.psfnet.arch import load_torch_psfnet as jax_load_torch_psfnet
from sdirt_tpu.utils import logging as JL
from sdirt_tpu_torch.dfdp import metrics as TM
from sdirt_tpu_torch.dfdp.perceptual import batch_perceptual
from sdirt_tpu_torch.psfnet.arch import build_psfnet, load_torch_psfnet
from sdirt_tpu_torch.utils import logging as TL
from sdirt_tpu_torch.utils.weights import flax_to_torch


def _depths(seed, shape=(48, 64)):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(0.3, 8.0, shape)
    gt[rng.uniform(size=shape) < 0.1] = 0.0           # empty pixels
    est = gt * rng.uniform(0.7, 1.4, shape) + rng.normal(0, 0.05, shape)
    est = np.abs(est)
    return est, gt, gt > 1e-9


UNMASKED = ("abs_rel", "sq_rel", "mae", "mse", "rmse", "rmse_log")


@pytest.mark.parametrize("name", UNMASKED)
def test_depth_metrics_equal_jax(name):
    """The unmasked metrics, on maps whose zeros give the inf terms the
    formulas drop."""
    for seed in range(3):
        est, gt, _ = _depths(seed)
        a = getattr(TM, name)(est.copy(), gt.copy())
        b = getattr(JM, name)(est.copy(), gt.copy())
        assert a == b or (np.isnan(a) and np.isnan(b)), (name, a, b)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_accuracy_k_equals_jax(k):
    est, gt, _ = _depths(k)
    gt[gt == 0] = 1.0           # a zero ratio would be a nan in both
    assert TM.accuracy_k(est, gt, k) == JM.accuracy_k(est, gt, k)


def test_masked_extras_equal_jax():
    est, gt, mask = _depths(7)
    conf = np.random.default_rng(8).uniform(0, 1, gt.shape)
    for v in (1.05, 1.25, 1.5625):
        assert TM.mask_accuracy_v(est, gt, v, mask) == JM.mask_accuracy_v(est, gt, v, mask)
    assert TM.mask_mse_w_conf(est, gt, conf, mask) == JM.mask_mse_w_conf(est, gt, conf, mask)
    assert TM.mask_mae_w_conf(est, gt, conf, mask) == JM.mask_mae_w_conf(est, gt, conf, mask)


@pytest.mark.parametrize("clip", [0.05, 1e9])
def test_bumpiness_equals_jax(clip):
    """The Scharr Hessian norm, at the default clip (most pixels clipped)
    and with no clip, masked and not; the filters themselves."""
    rng = np.random.default_rng(11)
    gt = rng.uniform(1, 5, (40, 56))
    res = gt + rng.normal(0, 0.02, gt.shape).cumsum(1)
    mask = rng.uniform(size=gt.shape) > 0.3
    np.testing.assert_array_equal(TM.scharr_v(res), JM.scharr_v(res))
    np.testing.assert_array_equal(TM.scharr_h(res), JM.scharr_h(res))
    a = TM.get_bumpiness(gt, res, mask, clip=clip)
    b = JM.get_bumpiness(gt, res, mask, clip=clip)
    assert a == b
    assert TM.get_bumpiness_non_mask(gt, res, clip=clip) == \
        JM.get_bumpiness_non_mask(gt, res, clip=clip)
    if clip == 0.05:
        # the clip binds: the clipped mean lies below the unclipped one
        assert a < TM.get_bumpiness(gt, res, mask, clip=1e9)


def test_rays_per_second():
    ctr = TL.RaysPerSecond()
    assert ctr.rays_per_sec == 0.0
    with ctr.measure(1000):
        pass
    with ctr.measure(3000):
        pass
    assert ctr.rays == 4000 and ctr.seconds > 0
    assert ctr.rays_per_sec == 4000 / ctr.seconds
    ctr.seconds = 2.0
    assert ctr.rays_per_sec == 2000.0


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with TL.profile_trace(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
    assert os.path.dirname(prof.trace_path) == str(tmp_path / "trace")
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    assert any("matmul" in e.get("name", "") for e in events)
    with TL.profile_trace(None) as nothing:
        pass
    assert nothing is None


def test_print_memory_prints_nothing_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: print_memory prints its lines")
    TL.print_memory("tag")
    JL.print_memory("tag")     # the JAX CPU device has no memory statistics
    assert capsys.readouterr().out == ""


def test_batch_lpips_is_the_perceptual_proxy():
    rng = np.random.default_rng(2)
    a = rng.uniform(0, 1, (2, 3, 64, 96)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    got = TL.batch_LPIPS(a, b)
    assert got == batch_perceptual(a, b)
    # the JAX function takes the same proxy (no lpips package): the
    # perceptual tests' limit
    assert abs(got - JL.batch_LPIPS(a, b)) <= 1e-5


@pytest.mark.parametrize("model", ["mlp@16", "mlpb@16x8"])
def test_load_torch_psfnet_equals_jax(tmp_path, model):
    """A reference state dict (layers net.<i>, one of another shape) into
    a net initialised alike in both packages: every leaf equal to the JAX
    loader's."""
    ks = 5
    jnet = jax_build_psfnet(model, ks)
    params = jnet.init(jax.random.PRNGKey(3), jnp.zeros((1, 3)))
    flat = {k: np.asarray(v) for k, v in
            flax.traverse_util.flatten_dict(params, sep="/").items()}
    net = build_psfnet(model, ks)
    net.load_state_dict(flax_to_torch(flat))
    gen = torch.Generator().manual_seed(4)
    dims = [3, 4, 16, 16, 16, 16, 16, 16, 16, 16, 16, 99]
    sd = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        sd[f"net.{i}.weight"] = torch.randn(b, a, generator=gen)
        sd[f"net.{i}.bias"] = torch.randn(b, generator=gen)
    path = str(tmp_path / "ref.pkl")
    torch.save(sd, path)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    assert load_torch_psfnet(net, path) is net
    ref = flax.traverse_util.flatten_dict(jax_load_torch_psfnet(params, path), sep="/")
    want = flax_to_torch({k: np.asarray(v) for k, v in ref.items()})
    got = net.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)
    # the same-shaped layers were replaced, the last (99 wide) was not
    replaced = [k for k in got if not torch.equal(got[k], before[k])]
    assert 0 < len(replaced) < len(got)
