"""The PyTorch port's DfDP training step against the JAX package on the CPU:
the DP noise, the training render, the log-depth losses, BatchNorm in train
mode, and whole train steps of the shipped Sdirt_best_acc1 at 128x192,
bs 2 (the smallest input DDDNet takes), with the learning-rate schedule.
The renders are the JAX package's ``scan`` variant, named explicitly (its
default, ``fused_int8``, is not ported).

The JAX side (the first step's gradient in float64, three dfdp_train_steps
in float32) is computed once, in a module fixture that every train-step
check shares. Both sides train on the JAX package's renders stored with the
card reference (scripts/make_train_step_reference.py), whose float64
losses, made by dfdp_train_step, the losses are held to. Both sides train on the same rendered stacks: the JAX app's
``_render_batch`` with the ``scan`` variant, named explicitly (the JAX
package's default, ``fused_int8``, is not ported).
"""

import json
import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdirt_tpu.dfdp import basenet as JB
from sdirt_tpu.dfdp import factory as jax_factory
from sdirt_tpu.dfdp.train import create_dfdp_state as jax_create_state
from sdirt_tpu.dfdp.train import dfdp_train_step as jax_train_step
from sdirt_tpu.psfnet.train import cosine_annealing as jax_cosine
from sdirt_tpu.render import camera as JC
from sdirt_tpu_torch import dfdp_net
from sdirt_tpu_torch.dfdp import basenet as TB
from sdirt_tpu_torch.dfdp import factory
from sdirt_tpu_torch.dfdp.datasets import SyntheticRGBD
from sdirt_tpu_torch.dfdp.models.layers import BatchNorm
from sdirt_tpu_torch.dfdp.train import (create_dfdp_state, dfdp_grads,
                                        dfdp_train_step)
from sdirt_tpu_torch.render import camera as TC
from sdirt_tpu_torch.utils.config import load_config
from sdirt_tpu_torch.utils.weights import load_npz, torch_to_flax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "dfdp_synthetic_smoke.yml")
WEIGHTS = os.path.join(ROOT, "sdirt_tpu_torch", "weights", "rf50mm",
                       "Sdirt_best_acc1.npz")
REF_DIR = os.path.join(ROOT, "sdirt_tpu_torch", "reference")
RES, BS, STEPS, LR, TOTAL = (128, 192), 2, 3, 1e-4, 3


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test files at once on the machine's cores;
    this file's torch work keeps to two threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _config():
    """The smoke config with absolute paths, so neither side depends on the
    working directory."""
    args = load_config(CONFIG)
    for side in ("train", "test"):
        for k in ("lens", "psfnet_path"):
            args[side][k] = os.path.normpath(os.path.join(ROOT, args[side][k]))
    return args


def _batches():
    ds = SyntheticRGBD(RES, style="v5", seed=0)
    items = [ds[i] for i in range(BS * STEPS)]
    return [tuple(np.stack([items[BS * k + j][c] for j in range(BS)])
                  for c in (0, 1)) for k in range(STEPS)]


def _flat(tree, prefix):
    return {f"{prefix}/{k}": np.asarray(v) for k, v in
            flax.traverse_util.flatten_dict(tree, sep="/").items()}


def _reference():
    """The committed card reference (scripts/make_train_step_reference.py):
    (its JSON, the JAX package's stored scan renders of the _batches() as
    float32 [STEPS, BS, 6, H, W], their f16-rounded depths)."""
    with open(os.path.join(REF_DIR, "train_step_jax_cpu.json")) as f:
        ref = json.load(f)
    with np.load(os.path.join(ROOT, ref["stacks"])) as z:
        return (ref, (z["stacks"].astype(np.float64) / 65535).astype(np.float32),
                z["depths"].astype(np.float32))


@pytest.fixture(scope="module")
def jax_run():
    """From the JAX package (train_mode 'dfdp'), on the stored renders: the
    loss, gradients and BN statistics of the first step in float64, and
    three dfdp_train_steps in float32 (losses, learning rates, parameters
    and BN statistics after the third). The float64 losses of the three
    steps are the committed reference's, made by dfdp_train_step."""
    ref, stacks, depths = _reference()
    # create_dfdp_state under jit: its eager Flax init is slow on the CPU
    state = jax.jit(lambda: jax_create_state(jax.random.PRNGKey(0), LR, TOTAL,
                                             (1, 6, *RES))[0])()
    tree = flax.traverse_util.unflatten_dict(load_npz(WEIGHTS), sep="/")
    out = {"ref": ref, "batches": _batches(), "stacks": stacks, "depths": depths,
           "lrs": [float(jax_cosine(LR, TOTAL)(jnp.int32(t))) for t in range(STEPS)]}

    # the gradient in float64: the JAX package's float32 CPU run is itself
    # 4e-2 (of the largest entry) off it in some leaves, too far to hold
    # the port to
    with jax.enable_x64(True):
        t64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)
        s64 = state.replace(params=t64["params"], batch_stats=t64["batch_stats"],
                            opt_state=state.tx.init(t64["params"]))
        stack0 = jnp.asarray(stacks[0], jnp.float64)
        gt_log, mask = JB.linear_depth(jnp.asarray(depths[0], jnp.float64))

        @jax.jit
        def value_and_grad(params):
            # dfdp_train_step's loss_fn, and its gradient before the optimiser
            def loss_fn(params):
                results, updates = s64.apply_fn(
                    {"params": params, "batch_stats": s64.batch_stats},
                    stack0, train=True, mutable=["batch_stats"])
                return JB.compute_loss(results, gt_log, mask)["total"], updates

            return jax.value_and_grad(loss_fn, has_aux=True)(params)

        (loss0, updates), grads = value_and_grad(s64.params)
        out.update(loss0=float(loss0), grads=_flat(grads, "params"),
                   bn1=_flat(updates["batch_stats"], "batch_stats"))

    state = state.replace(params=tree["params"], batch_stats=tree["batch_stats"],
                          opt_state=state.tx.init(tree["params"]))
    out["losses32"] = []
    for k in range(STEPS):
        state, losses = jax_train_step(state, jnp.asarray(stacks[k]),
                                       jnp.asarray(depths[k]))
        out["losses32"].append(float(losses["total"]))
    out["params3"] = _flat(state.params, "params")
    out["bn3"] = _flat(state.batch_stats, "batch_stats")
    return out


def _port_net(dtype=torch.float32):
    return TB.build_basenet(WEIGHTS, device="cpu", train=True).to(dtype)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(a).to(dtype)


def _rel_to_max(got, ref):
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def test_dp_noise_matches_jax():
    """The draws of sdirt_tpu/render/camera.py:dp_noise, replayed from the
    same key in the order of its split, go through the port's pure noise
    function."""
    rng = np.random.default_rng(0)
    render = rng.uniform(0, 1, (2, 6, 16, 24)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    k1, k2, k3, k4 = jax.random.split(key, 4)
    noise_range = float(0.05 * jax.random.uniform(k1, ()))
    noise = np.array(jax.random.normal(k2, render.shape))
    r1 = float(jax.random.uniform(k3, ()) / 2.0)
    r2 = float(jax.random.uniform(k4, ()) / 2.0 + 0.5)
    ref = np.asarray(JC.dp_noise(key, jnp.asarray(render), render.shape))
    got = TC.apply_dp_noise(torch.from_numpy(render), noise_range,
                            torch.from_numpy(noise), r1, r2).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_dp_noise_draws():
    gen = torch.Generator().manual_seed(0)
    for _ in range(20):
        noise_range, noise, r1, r2 = TC.draw_dp_noise(gen, (1, 6, 4, 5))
        assert 0 <= float(noise_range) < 0.05 and tuple(noise.shape) == (1, 6, 4, 5)
        assert 0 <= float(r1) < 0.5 <= float(r2) < 1.0
    render = torch.full((1, 2, 3, 4), 0.5)
    a = TC.dp_noise(torch.Generator().manual_seed(1), render)
    b = TC.dp_noise(torch.Generator().manual_seed(1), render)
    assert torch.equal(a, b) and not torch.equal(a, render)


@pytest.fixture(scope="module")
def jax_train_render():
    """The JAX scan render of the first batch at 128x192 with the shipped
    surrogate, noise-free and with the noise of a key, and that key's
    draws, replayed in the order of camera.py:dp_noise's split."""
    from sdirt_tpu.render.pipeline import render_dp as jax_render_dp

    jax_lens, _ = jax_factory.get_lens(_config())
    aif, depth = _batches()[0]
    # the inputs as the training path uploads them (uint8 image, f16 depth)
    aif = (aif * 255.0 + 0.5).astype(np.uint8).astype(np.float32) / 255.0
    depth = -depth.astype(np.float16).astype(np.float32) * 1e3
    key = jax.random.PRNGKey(5)
    kw = dict(d_sensor=jax_lens.d_sensor, d_min=jax_lens.d_min,
              d_max=jax_lens.d_max, ks=jax_lens.kernel_size, variant="scan",
              scan_right="flip")
    free, noisy = (np.asarray(jax_render_dp(jax_lens.net.apply, jax_lens.params,
                                            aif, depth, [-1000.0], train=t,
                                            key=key, **kw))
                   for t in (False, True))
    k1, k2, k3, k4 = jax.random.split(key, 4)
    draws = (0.05 * torch.tensor(float(jax.random.uniform(k1, ()))),
             torch.from_numpy(np.array(jax.random.normal(k2, noisy.shape))),
             torch.tensor(float(jax.random.uniform(k3, ()))) / 2.0,
             torch.tensor(float(jax.random.uniform(k4, ()))) / 2.0 + 0.5)
    return aif, depth, free, noisy, draws


@pytest.mark.parametrize("variant", ["fused"])
def test_train_render_matches_jax(monkeypatch, jax_train_render, variant):
    """render(train=True) at 128x192 with the shipped surrogate: the JAX
    scan render with a key against the port's, fed the same draws.

    On both sides the training render is the noise-free render plus the
    noise, clipped (noise after gamma, before the clip). The renders
    themselves are compared image-wide: the bf16 PSF network rounds
    differently in XLA and in torch, which moves a few hundred pixels of a
    128x192 pair by up to 0.06 (measured: up to 0.17% of them beyond 1e-2,
    PSNR 59 dB)."""
    aif, depth, ref_free, ref, draws = jax_train_render
    lens, _ = factory.get_lens(_config(), device="cpu")
    monkeypatch.setattr(TC, "draw_dp_noise", lambda *a, **k: draws)
    got = lens.render(aif, depth, [-1000.0], variant, train=True,
                      generator=torch.Generator()).numpy()
    got_free = lens.render(aif, depth, [-1000.0], variant).numpy()
    noise = TC.apply_dp_noise(torch.zeros(ref.shape), *draws).numpy()
    np.testing.assert_allclose(ref, np.clip(ref_free + noise, 0, 1), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, np.clip(got_free + noise, 0, 1), rtol=0, atol=1e-6)
    share, psnr = _image_gap(got, ref)
    assert share <= 5e-3 and psnr >= 55.0, (share, psnr)
    with pytest.raises(ValueError, match="generator"):
        lens.render(aif, depth, [-1000.0], variant, train=True)


def test_losses_match_jax():
    rng = np.random.default_rng(1)
    depth = rng.uniform(0.2, 9, (2, 1, 8, 12)).astype(np.float32)
    depth[:, :, ::3] = 0
    pred = rng.normal(0.5, 1.5, depth.shape).astype(np.float32)
    ref_log, ref_mask = JB.linear_depth(jnp.asarray(depth))
    got_log, got_mask = TB.linear_depth(torch.from_numpy(depth))
    np.testing.assert_allclose(got_log.numpy(), np.asarray(ref_log), rtol=1e-6, atol=0)
    assert np.array_equal(got_mask.numpy(), np.asarray(ref_mask))
    for mask in (None, ref_mask):
        ref = np.asarray(JB.inverse_linear_depth(jnp.asarray(pred), mask))
        got = TB.inverse_linear_depth(
            torch.from_numpy(pred), None if mask is None else got_mask).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
    np.testing.assert_allclose(
        TB.smooth_l1(torch.from_numpy(pred), got_log).numpy(),
        np.asarray(JB.smooth_l1(jnp.asarray(pred), ref_log)), rtol=1e-6, atol=0)
    ref = JB.compute_loss({"pred_depth_est": jnp.asarray(pred)}, ref_log, ref_mask)
    got = TB.compute_loss({"pred_depth_est": torch.from_numpy(pred)}, got_log, got_mask)
    assert set(got) == {"depth_est", "total"}
    for k in got:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-6)
    # deblur mode: 2 depth_est + depth_fix + aif, the aif term a plain mean
    fix = rng.normal(0, 1, pred.shape).astype(np.float32)
    aif = rng.uniform(0, 1, (2, 3, 8, 12)).astype(np.float32)
    gt_aif = rng.uniform(0, 1, aif.shape).astype(np.float32)
    ref = JB.compute_loss({"pred_depth_est": jnp.asarray(pred),
                           "pred_depth_fix": jnp.asarray(fix),
                           "pred_aif": jnp.asarray(aif)}, ref_log, ref_mask,
                          jnp.asarray(gt_aif), "deblur")
    got = TB.compute_loss({"pred_depth_est": torch.from_numpy(pred),
                           "pred_depth_fix": torch.from_numpy(fix),
                           "pred_aif": torch.from_numpy(aif)}, got_log,
                          got_mask, torch.from_numpy(gt_aif), "deblur")
    assert set(got) == {"depth_est", "depth_fix", "aif", "total"}
    for k in got:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-6)
    with pytest.raises(ValueError, match="gt_aif"):
        TB.compute_loss({"pred_depth_est": torch.from_numpy(pred)}, got_log,
                        got_mask, train_mode="deblur")


@pytest.mark.parametrize("shape", [(3, 5, 6, 7), (2, 4, 3, 5, 6)],
                         ids=["2d", "3d"])
def test_batchnorm_train_mode_matches_flax(shape):
    """Flax nn.BatchNorm(momentum=0.9, epsilon=1e-5) in train mode: output,
    and running statistics updated with the biased (E[x^2] - E[x]^2)
    variance."""
    rng = np.random.default_rng(2)
    x = rng.normal(1.5, 2.0, shape).astype(np.float32)
    c = shape[1]
    scale = rng.uniform(0.5, 2, c).astype(np.float32)
    bias = rng.normal(0, 1, c).astype(np.float32)
    mean0 = rng.normal(0, 1, c).astype(np.float32)
    var0 = rng.uniform(0.5, 2, c).astype(np.float32)
    bn = flax.linen.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}
    ref, upd = bn.apply(variables, jnp.asarray(np.moveaxis(x, 1, -1)),
                        mutable=["batch_stats"])
    m = BatchNorm(c).train()
    with torch.no_grad():
        for name, v in (("weight", scale), ("bias", bias),
                        ("running_mean", mean0), ("running_var", var0)):
            getattr(m, name).copy_(torch.from_numpy(v))
    got = m(torch.from_numpy(x))
    np.testing.assert_allclose(np.moveaxis(got.detach().numpy(), 1, -1),
                               np.asarray(ref), rtol=0, atol=1e-5)
    np.testing.assert_allclose(m.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(m.running_var.numpy(),
                               np.asarray(upd["batch_stats"]["var"]), rtol=1e-5, atol=0)
    m.eval()
    ev = m(torch.from_numpy(x))
    exp = ((x - m.running_mean.numpy().reshape(1, -1, *[1] * (x.ndim - 2)))
           / np.sqrt(m.running_var.numpy() + 1e-5).reshape(1, -1, *[1] * (x.ndim - 2))
           * scale.reshape(1, -1, *[1] * (x.ndim - 2))
           + bias.reshape(1, -1, *[1] * (x.ndim - 2)))
    np.testing.assert_allclose(ev.detach().numpy(), exp, rtol=0, atol=1e-5)


# (dtype, gradient tolerance relative to each leaf's largest entry): in
# float64 the port computes the JAX package's function (measured 4e-6); in
# float32 its gradient rounds, most in the BatchNorm biases of the last 3-D
# blocks, whose gradient sums ~10^6 terms that cancel to a small total
# (measured 2.7e-2 there, 2.4e-3 on the unrounded renders)
GRAD_TOL = {torch.float64: 1e-3, torch.float32: 1e-1}
DTYPES = [torch.float64, torch.float32]
DTYPE_IDS = ["f64", "f32"]


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_train_step_gradients_match_jax(jax_run, dtype):
    """Every gradient leaf of the first step, before the optimiser, against
    the JAX package's (AdamW's first update is close to lr * sign(g) and
    would hide a gradient error)."""
    net = _port_net(dtype)
    losses = dfdp_grads(net, _t(jax_run["stacks"][0], dtype),
                        _t(jax_run["depths"][0], dtype))
    np.testing.assert_allclose(float(losses["total"]), jax_run["loss0"], rtol=1e-4)
    grads = torch_to_flax({n: p.grad for n, p in net.named_parameters()})
    assert set(grads) == set(jax_run["grads"])
    worst = max((_rel_to_max(grads[k], ref), k) for k, ref in jax_run["grads"].items())
    assert worst[0] <= GRAD_TOL[dtype], worst


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_train_step_batchnorm_statistics_match_jax(jax_run, dtype):
    """The BN running statistics after one step's forward, within 1e-5 of
    each leaf's largest entry (measured 7e-8 in float64, 1.6e-6 in
    float32)."""
    net = _port_net(dtype)
    dfdp_grads(net, _t(jax_run["stacks"][0], dtype), _t(jax_run["depths"][0], dtype))
    stats = {k: v for k, v in torch_to_flax(net.state_dict()).items()
             if k.startswith("batch_stats/")}
    assert set(stats) == set(jax_run["bn1"])
    worst = max((_rel_to_max(stats[k], ref), k) for k, ref in jax_run["bn1"].items())
    assert worst[0] <= 1e-5, worst


# Losses of three steps against the reference's float64 dfdp_train_steps:
# float64 within 1e-4 (measured 4e-7), float32 within the tolerance the card
# is held to (measured 2.2e-4).
LOSS_RTOL = {torch.float64: 1e-4, torch.float32: None}


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_three_train_steps_match_jax(jax_run, dtype):
    """Losses of three steps and each step's learning rate against the
    optax schedule's."""
    ref = jax_run["ref"]
    state = create_dfdp_state(_port_net(dtype), LR, TOTAL)
    losses, lrs = [], []
    for k in range(STEPS):
        lrs.append(state.opt.param_groups[0]["lr"])
        out = dfdp_train_step(state, _t(jax_run["stacks"][k], dtype),
                              _t(jax_run["depths"][k], dtype))
        losses.append(float(out["total"]))
    assert state.step == STEPS
    np.testing.assert_allclose(losses, ref["losses"],
                               rtol=LOSS_RTOL[dtype] or ref["stored_stacks_rtol"])
    np.testing.assert_allclose(lrs, jax_run["lrs"], rtol=1e-6)


def test_three_train_steps_parameters_match_jax(jax_run):
    """The parameters and BN statistics after three float32 steps against
    three float32 dfdp_train_steps of the JAX package. AdamW's first updates
    are about lr * sign(g), so an entry whose gradient is near zero may move
    by up to 2 lr per step differently (measured max 4.3e-5 in
    the parameters, 3.4e-4 of a leaf's largest entry in the statistics)."""
    state = create_dfdp_state(_port_net(), LR, TOTAL)
    losses = [float(dfdp_train_step(state, _t(s), _t(d))["total"])
              for s, d in zip(jax_run["stacks"], jax_run["depths"])]
    # the JAX package's float32 steps: 3e-4 off their float64 losses
    np.testing.assert_allclose(losses, jax_run["losses32"], rtol=1e-3)
    flat = torch_to_flax(state.net.state_dict())
    worst = max((float(np.abs(flat[k] - v).max()), k) for k, v in jax_run["params3"].items())
    assert worst[0] <= 2 * STEPS * LR, worst
    worst = max((_rel_to_max(flat[k], v), k) for k, v in jax_run["bn3"].items())
    assert worst[0] <= 1e-3, worst


def test_train_step_reference_matches_jax(jax_run, jax_train_render):
    """The committed card reference is the JAX package's: its first stored
    stack is the JAX scan render of the first batch (to the 16-bit
    rounding), and its first loss, from dfdp_train_step in float64, is the
    fixture's float64 loss of the same step (within 1e-6: the fixture's
    stacks pass through float32)."""
    ref = jax_run["ref"]
    assert (ref["res"], ref["bs"], ref["steps"]) == (list(RES), BS, STEPS)
    np.testing.assert_allclose(jax_run["stacks"][0], jax_train_render[2], rtol=0,
                               atol=0.5 / 65535 + 1e-7)
    np.testing.assert_array_equal(
        jax_run["depths"][0], jax_run["batches"][0][1].astype(np.float16).astype(np.float32))
    np.testing.assert_allclose(ref["losses"][0], jax_run["loss0"], rtol=1e-6)


def _image_gap(got, ref):
    """(share of values more than 1e-2 apart, PSNR in dB) of two [0, 1]
    images."""
    diff = np.abs(got.astype(np.float64) - ref)
    return (diff > 1e-2).mean(), 10 * np.log10(1.0 / np.mean(diff ** 2))


def test_train_step_on_own_render_close_to_jax(jax_run):
    """The port renders its own stacks (``fused``, the plain version on the
    CPU) and takes float32 steps on them. The stacks differ from the JAX
    scan render as in test_train_render_matches_jax (measured up to 0.17%
    of values beyond 1e-2, PSNR 59 dB), and the loss, which reads sub-pixel
    DP disparities, by up to 2.3%: the card reference allows its own render
    3x that."""
    ref = jax_run["ref"]
    lens, _ = factory.get_lens(_config(), device="cpu")
    state = create_dfdp_state(_port_net(), LR, TOTAL)
    for k, (aif, depth) in enumerate(jax_run["batches"]):
        stack, depth_dev, _ = dfdp_net._render_batch(lens, aif, depth)
        share, psnr = _image_gap(stack.numpy(), jax_run["stacks"][k])
        assert share <= 5e-3 and psnr >= 55.0, (k, share, psnr)
        np.testing.assert_array_equal(depth_dev.numpy(), jax_run["depths"][k])
        loss = float(dfdp_train_step(state, stack, depth_dev)["total"])
        gap = abs(loss - ref["losses"][k]) / ref["losses"][k]
        assert gap <= ref["own_render_rtol"] / 3, (k, loss, gap)


@pytest.mark.parametrize("anneal", [True, False])
def test_learning_rate_schedule_matches_optax(anneal):
    """T_max as the JAX app sets it (apps/dfdp_net.py: epochs x steps per
    epoch with anneal_over_steps, else epochs x samples), and every update's
    learning rate against the optax schedule over a whole run."""
    args = {"epochs": 3, "bs": 4, "anneal_over_steps": anneal}
    n = 16
    total = 3 * (n // 4) if anneal else 3 * n
    assert dfdp_net._total_steps(args, n) == total
    net = torch.nn.Linear(2, 1)
    state = create_dfdp_state(net, 3e-5, total)
    sched = jax_cosine(3e-5, total)
    for t in range(3 * (n // 4)):
        np.testing.assert_allclose(state.opt.param_groups[0]["lr"],
                                   float(sched(jnp.int32(t))), rtol=1e-6, atol=1e-12)
        state.opt.step()
        state.sched.step()


def test_global_norm_clip_matches_optax():
    import optax

    from sdirt_tpu_torch.dfdp.train import clip_by_global_norm_

    rng = np.random.default_rng(3)
    for scale in (0.01, 0.3, 5.0):
        gs = [rng.normal(0, scale, s).astype(np.float32) for s in ((3, 4), (7,), (2, 2, 2))]
        ref, _ = optax.clip_by_global_norm(1.0).update(
            [jnp.asarray(g) for g in gs], optax.EmptyState())
        got = [torch.from_numpy(g.copy()) for g in gs]
        norm = clip_by_global_norm_(got)
        np.testing.assert_allclose(float(norm), np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                                                            for g in gs)), rtol=1e-6)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=0)
