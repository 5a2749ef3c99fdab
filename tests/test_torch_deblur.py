"""The PyTorch port's deblur head (``--train-mode deblur``) against the JAX
package on the CPU: the blocks (ResBlock, CAMModule, ConvBlock, Encoder,
Decoder), Mydeblur with a random Flax init carried across and with the
shipped Sdirt_deblur_demo_cpu, the deblur Basenet's three-term loss and
train steps in float64, ``dfdp_infer``'s three outputs and the monitor's
deblur metrics.

Tolerances: block and head outputs within 1e-4 of each output's largest
magnitude (measured 1.2e-5 for CAMModule, whose softmax reads Gram sums
over ~1600 pixels, and at most 9.2e-7 for the others: f32 convolutions
summed in another order); float64 losses within 1e-6 relative (measured
1e-12 on the first step); float64 gradient leaves within 1e-4 of each
leaf's largest entry (measured 5.8e-8).
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
from sdirt_tpu.dfdp import monitor as JM
from sdirt_tpu.dfdp.models import dddnet as JD
from sdirt_tpu.dfdp.models import layers as JL
from sdirt_tpu.dfdp.train import create_dfdp_state as jax_create_state
from sdirt_tpu.dfdp.train import dfdp_infer as jax_infer
from sdirt_tpu_torch.dfdp import basenet as TB
from sdirt_tpu_torch.dfdp import monitor as TM
from sdirt_tpu_torch.dfdp.models import dddnet as TD
from sdirt_tpu_torch.dfdp.models import layers as TL
from sdirt_tpu_torch.dfdp.train import (create_dfdp_state, dfdp_grads,
                                        dfdp_infer, dfdp_train_step)
from sdirt_tpu_torch.utils.weights import load_npz, load_state, torch_to_flax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_DIR = os.path.join(ROOT, "sdirt_tpu_torch", "reference")
WEIGHTS = os.path.join(ROOT, "sdirt_tpu_torch", "weights", "rf50mm",
                       "Sdirt_deblur_demo_cpu.npz")
RES, BS, STEPS, LR, TOTAL = (128, 192), 2, 3, 1e-4, 3
OUT_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test files at once on the machine's cores;
    this file's torch work keeps to two threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _flat(variables):
    return {k: np.asarray(v) for k, v in
            flax.traverse_util.flatten_dict(variables, sep="/").items()}


def _gap(got, ref):
    """max |got - ref| over the largest |ref|."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _nonzero_gamma(variables):
    """A Flax tree with every attention gamma set to 0.7, so the attention
    branch reaches the output (it is 0 at init)."""
    flat = _flat(variables)
    flat = {k: (np.full_like(v, 0.7) if k.endswith("gamma") else v)
            for k, v in flat.items()}
    return flax.traverse_util.unflatten_dict(flat, sep="/")


def _nchw(x):
    return jnp.asarray(x).transpose(0, 2, 3, 1)


def _block_cases():
    """(id, Flax module, port module, NCHW input shape): the odd sizes put
    the stride-2 convolutions and the transposed ones on sizes that do not
    halve evenly."""
    return [
        ("resblock", JL.ResBlock(32, dilation=2), TL.ResBlock(32, dilation=2),
         (2, 32, 17, 25)),
        ("cam", JL.CAMModule(), TL.CAMModule(), (2, 128, 33, 49)),
        ("convblock", JL.ConvBlock(128, 8, 4, 2), TL.ConvBlock(4, 128, 8, 4, 2),
         (1, 4, 130, 194)),
        ("encoder_even", JD.Encoder(128), TD.Encoder(7, 128), (1, 7, 128, 192)),
        ("encoder_odd", JD.Encoder(128), TD.Encoder(7, 128), (1, 7, 130, 194)),
        ("decoder_even", JD.Decoder(7), TD.Decoder(7), (1, 128, 32, 48)),
        ("decoder_odd", JD.Decoder(3), TD.Decoder(3), (1, 128, 33, 49)),
    ]


@pytest.mark.parametrize("case", _block_cases(), ids=lambda c: c[0])
def test_blocks_match_flax(case):
    """Each block with a random Flax init carried across (ResBlock's
    BatchNorm on running statistics)."""
    _, jmod, tmod, shape = case
    x = np.random.default_rng(0).uniform(-1, 1, shape).astype(np.float32)
    variables = _nonzero_gamma(jmod.init(jax.random.PRNGKey(1), _nchw(x)))
    ref = np.asarray(jmod.apply(variables, _nchw(x))).transpose(0, 3, 1, 2)
    load_state(tmod, _flat(variables))
    with torch.no_grad():
        got = tmod.eval()(torch.from_numpy(x)).numpy()
    assert _gap(got, ref) <= OUT_TOL


def _head_inputs(h, w, seed=0):
    rng = np.random.default_rng(seed)
    left = rng.uniform(0, 1, (1, 3, h, w)).astype(np.float32)
    right = np.clip(left + rng.normal(0, 0.05, left.shape), 0, 1).astype(np.float32)
    disp = rng.normal(0.5, 0.5, (1, 1, h, w)).astype(np.float32)
    return left, right, disp


@pytest.mark.parametrize("weights", ["random", "exported"])
def test_mydeblur_matches_jax(weights):
    """Mydeblur at 128x192: a random Flax init (attention gamma 0.7), and
    the exported Sdirt_deblur_demo_cpu head."""
    left, right, disp = _head_inputs(*RES)
    jm = JD.Mydeblur()
    if weights == "random":
        variables = _nonzero_gamma(jm.init(jax.random.PRNGKey(3), left, right, disp))
        flat = _flat(variables)
    else:
        tree = load_npz(WEIGHTS)
        flat = {k[len("params/deblur_net/"):]: v for k, v in tree.items()
                if k.startswith("params/deblur_net/")}
        variables = {"params": flax.traverse_util.unflatten_dict(flat, sep="/")}
        flat = {f"params/{k}": v for k, v in flat.items()}
    ref = jm.apply(variables, left, right, disp)
    tm = load_state(TD.Mydeblur(), flat)
    with torch.no_grad():
        got = tm(*map(torch.from_numpy, (left, right, disp)))
    for g, r in zip(got, ref):
        assert _gap(g.numpy(), r) <= OUT_TOL


def test_mydeblur_needs_multiples_of_8():
    """At 130x194 the quarter patches leave their encoders' H/4 grid: the
    JAX head itself fails there, and so does the port's."""
    left, right, disp = _head_inputs(130, 194)
    jm = JD.Mydeblur()
    with pytest.raises(Exception):
        jm.init(jax.random.PRNGKey(0), left, right, disp)
    with torch.no_grad(), pytest.raises(RuntimeError):
        TD.Mydeblur()(*map(torch.from_numpy, (left, right, disp)))


def test_deblur_basenet_forward_and_infer_match_jax():
    """The deblur Basenet of the exported net: its three LOG outputs, and
    dfdp_infer's depth, refined depth (metres) and all-in-focus image."""
    rng = np.random.default_rng(4)
    stack = rng.uniform(0, 1, (1, 6, *RES)).astype(np.float32)
    stack[:, 3:] = np.clip(stack[:, :3] + rng.normal(0, 0.02, (1, 3, *RES)), 0, 1)
    tree = flax.traverse_util.unflatten_dict(load_npz(WEIGHTS), sep="/")
    ref = JB.Basenet(train_mode="deblur").apply(tree, jnp.asarray(stack))
    net = TB.build_basenet(WEIGHTS, device="cpu", train_mode="deblur")
    with torch.no_grad():
        got = net(torch.from_numpy(stack))
    assert set(got) == set(ref) == {"pred_depth_est", "pred_depth_fix", "pred_aif"}
    for k in ref:
        assert _gap(got[k].numpy(), ref[k]) <= OUT_TOL, k
    ref_inf = jax_infer(tree["params"], tree["batch_stats"], jnp.asarray(stack),
                        train_mode="deblur")
    got_inf = dfdp_infer(net, torch.from_numpy(stack))
    assert len(got_inf) == len(ref_inf) == 3
    for g, r in zip(got_inf, ref_inf):
        assert _gap(g.numpy(), r) <= OUT_TOL
    with pytest.raises(ValueError, match="single-view"):
        TB.Basenet(train_mode="deblur", n_views=2)


def _stored():
    """The deblur train-step reference (scripts/make_deblur_reference.py):
    its JSON, the stored stacks, depths and all-in-focus images, f64."""
    with open(os.path.join(REF_DIR, "train_step_deblur_jax_cpu.json")) as f:
        ref = json.load(f)
    with np.load(os.path.join(ROOT, ref["stacks"])) as z:
        stacks = z["stacks"].astype(np.float64) / 65535
        depths = z["depths"].astype(np.float64)
    with np.load(os.path.join(ROOT, ref["aif"])) as z:
        aifs = z["aif"].astype(np.float64) / 255.0
    return ref, stacks, depths, aifs


@pytest.fixture(scope="module")
def jax_grad64():
    """The JAX package's first deblur step in float64 before the optimiser:
    its loss terms and every gradient leaf."""
    ref, stacks, depths, aifs = _stored()
    with jax.enable_x64(True):
        state = jax.jit(lambda: jax_create_state(
            jax.random.PRNGKey(0), LR, TOTAL, (1, 6, *RES), "deblur")[0])()
        tree = flax.traverse_util.unflatten_dict(load_npz(WEIGHTS), sep="/")
        tree = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)
        gt_log, mask = JB.linear_depth(jnp.asarray(depths[0]))

        @jax.jit
        def value_and_grad(params):
            def loss_fn(params):
                results, _ = state.apply_fn(
                    {"params": params, "batch_stats": tree["batch_stats"]},
                    jnp.asarray(stacks[0]), train=True, mutable=["batch_stats"])
                losses = JB.compute_loss(results, gt_log, mask,
                                         jnp.asarray(aifs[0]), "deblur")
                return losses["total"], losses

            return jax.value_and_grad(loss_fn, has_aux=True)(params)

        (_, losses), grads = value_and_grad(tree["params"])
        return {"losses": {k: float(v) for k, v in losses.items()},
                "grads": {f"params/{k}": v for k, v in _flat(grads).items()}}


def _port_net64():
    return TB.build_basenet(WEIGHTS, device="cpu", train=True,
                            train_mode="deblur").double()


def test_deblur_gradients_match_jax_float64(jax_grad64):
    """The first step's loss terms within 1e-6 relative, and every gradient
    leaf within 1e-4 of its largest entry, against JAX in float64."""
    _, stacks, depths, aifs = _stored()
    net = _port_net64()
    losses = dfdp_grads(net, torch.from_numpy(stacks[0]),
                        torch.from_numpy(depths[0]), torch.from_numpy(aifs[0]))
    assert set(losses) == set(jax_grad64["losses"])
    for k, v in jax_grad64["losses"].items():
        np.testing.assert_allclose(float(losses[k]), v, rtol=1e-6, err_msg=k)
    grads = torch_to_flax({n: p.grad for n, p in net.named_parameters()})
    assert set(grads) == set(jax_grad64["grads"])
    worst = max((_gap(grads[k], ref), k) for k, ref in jax_grad64["grads"].items()
                if np.abs(ref).max() > 0)
    assert worst[0] <= 1e-4, worst


def test_three_deblur_train_steps_match_jax_float64():
    """Three deblur steps (AdamW, cosine over 3 steps) on the stored renders
    against the reference's three JAX dfdp_train_steps in float64: every
    loss term within 1e-6 relative."""
    ref, stacks, depths, aifs = _stored()
    assert (ref["res"], ref["bs"], ref["steps"]) == (list(RES), BS, STEPS)
    state = create_dfdp_state(_port_net64(), LR, TOTAL)
    for k in range(STEPS):
        out = dfdp_train_step(state, torch.from_numpy(stacks[k]),
                              torch.from_numpy(depths[k]),
                              torch.from_numpy(aifs[k]))
        for name, v in ref["losses"][k].items():
            np.testing.assert_allclose(float(out[name]), v, rtol=1e-6,
                                       err_msg=f"step {k} {name}")


def test_monitor_deblur_metrics_match_jax():
    """ResultsMonitor in deblur mode on fixed arrays: acc1..3 of the
    refined depth, and PSNR / SSIM of the all-in-focus image where a truth
    exists (two frames with one, one without)."""
    rng = np.random.default_rng(5)
    jm, tm = JM.ResultsMonitor("deblur"), TM.ResultsMonitor("deblur")
    for i in range(3):
        gt = rng.uniform(0.3, 9, (1, 1, 24, 32)).astype(np.float32)
        gt[..., :3, :] = 0
        gt_aif = rng.uniform(0, 1, (1, 3, 24, 32)).astype(np.float32)
        outputs = {"gt_depth": gt,
                   "pred_depth_est": gt * rng.uniform(0.6, 1.5, gt.shape),
                   "pred_depth_fix": gt * rng.uniform(0.8, 1.2, gt.shape),
                   "pred_aif": np.clip(gt_aif + rng.normal(0, 0.05, gt_aif.shape), 0, 1),
                   "gt_aif": gt_aif if i < 2 else None}
        for m in (jm, tm):
            m.set_outputs(dict(outputs))
            m.compute_metrics()
    got = tm.metric_dict(3)
    ref = jm.metric_dict(3)
    for k in (1, 2, 3):
        ref[f"acc{k}_fix"] = getattr(jm, f"Avg_accuracy_{k}_fix") / 3
    ref["psnr_deblur"] = jm.Avg_psnr_deblur / 3
    ref["ssim_deblur"] = jm.Avg_ssim_deblur / 3
    assert set(got) == set(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-12, err_msg=k)
    assert got["psnr_deblur"] > 0


def test_deblur_checkpoint_saves_and_restores_the_head(tmp_path):
    """The port's own inference checkpoint (the trainer's ``ckpt_out`` and
    best nets) carries the deblur head: written, then read into a fresh
    deblur net, every parameter and statistic comes back."""
    from sdirt_tpu_torch.utils.checkpoint import (restore_inference_ckpt,
                                                  save_inference_ckpt)

    net = TB.build_basenet(WEIGHTS, device="cpu", train_mode="deblur")
    path = save_inference_ckpt(str(tmp_path / "best"), net)
    other = restore_inference_ckpt(path, TB.build_basenet(
        seed=3, device="cpu", train_mode="deblur"))
    want, got = net.state_dict(), other.state_dict()
    assert any(k.startswith("deblur_net.") for k in got)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
