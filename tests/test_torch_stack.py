"""The PyTorch port's multi-focus stack, thin lens and config-built lenses
against the JAX package on the CPU: FocalStackLens of two shipped
surrogates, the 2-view (12-channel) Basenet with three float64 train steps,
ThinLens, and ``get_lens`` on written configs of each kind (thinlens,
stack, fnum, focus_mm).

Tolerances: each view of the stack within the render band of
tests/test_torch_render.py (1e-2, the JAX package's own fused-vs-scan band;
measured 7.1e-4 against the JAX fused stack) and bit-equal to its lens's
own render; the 2-view net within 1e-4 of each output's largest magnitude
(measured 2.7e-6); float64 train-step losses within 1e-6 relative
(measured 5e-13) and gradient leaves within 1e-4 of each leaf's largest
entry (measured 5.7e-8); ThinLens within 1e-5 (f32; measured bit-equal);
geometry within 1e-6 relative.
"""

import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from sdirt_tpu.core.constants import GEO_SPP
from sdirt_tpu.dfdp import basenet as JB
from sdirt_tpu.dfdp import factory as jax_factory
from sdirt_tpu.dfdp.train import create_dfdp_state as jax_create_state
from sdirt_tpu.dfdp.train import dfdp_train_step as jax_train_step
from sdirt_tpu.optics.sampling import surface_sample as jax_surface_sample
from sdirt_tpu.psfnet.stack import FocalStackLens as JaxStack
from sdirt_tpu.psfnet.surrogate import PSFNetLens as JaxPSFNetLens
from sdirt_tpu.psfnet.thinlens import ThinLens as JaxThinLens
from sdirt_tpu_torch.dfdp import basenet as TB
from sdirt_tpu_torch.dfdp import factory
from sdirt_tpu_torch.dfdp.train import (create_dfdp_state, dfdp_grads,
                                        dfdp_train_step)
from sdirt_tpu_torch.optics.lens import Lens
from sdirt_tpu_torch.psfnet.stack import FocalStackLens
from sdirt_tpu_torch.psfnet.surrogate import PSFNetLens
from sdirt_tpu_torch.psfnet.thinlens import ThinLens
from sdirt_tpu_torch.utils.config import load_config
from sdirt_tpu_torch.utils.weights import load_npz, load_state, torch_to_flax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LENS = os.path.join(ROOT, "lenses", "rf50mm", "lens_web.json")
CKPT = os.path.join(ROOT, "ckpt", "rf50mm")
REF_DIR = os.path.join(ROOT, "sdirt_tpu_torch", "reference")
SURROGATES = (("F4_PSFNet_mlp", "mlp"), ("F4_PSFNet_mlp@256", "mlp@256"))
RES, BS, STEPS, LR, TOTAL = (128, 192), 2, 3, 1e-4, 3


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test files at once on the machine's cores;
    this file's torch work keeps to two threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _flat(tree, prefix=None):
    flat = {k: np.asarray(v) for k, v in
            flax.traverse_util.flatten_dict(tree, sep="/").items()}
    return flat if prefix is None else {f"{prefix}/{k}": v for k, v in flat.items()}


def _gap(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _scene(seed, n, h, w):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, (n, 3, h, w)).astype(np.float32)
    depth = -rng.uniform(300, 9000, (n, 1, h, w)).astype(np.float32)
    return img, depth


def test_focal_stack_matches_jax(monkeypatch):
    """Two shipped surrogates (F4_PSFNet_mlp, F4_PSFNet_mlp@256) at 32x48,
    ks 21, the ``fused`` variant on both sides: the stack is
    [N, 12, H, W], each view is its own lens's render (bit for bit), and
    within the render band of the JAX package's stack."""
    monkeypatch.setenv("SDIRT_RENDER_VARIANT", "fused")
    img, depth = _scene(0, 2, 32, 48)
    foc = np.array([-1000.0, -1000.0], np.float32)
    subs, jsubs = [], []
    for name, model in SURROGATES:
        lens = PSFNetLens(LENS, model_name=model, kernel_size=21,
                          sensor_res=(32, 48), device="cpu")
        subs.append(lens.load_net(factory.ported_weights(os.path.join(CKPT, name))))
        jlens = JaxPSFNetLens(LENS, model_name=model, kernel_size=21,
                              sensor_res=(32, 48))
        jlens.load_net(os.path.join(CKPT, name))
        jsubs.append(jlens)
    stack = FocalStackLens(subs)
    assert stack.n_views == 2 and stack.kernel_size == 21
    got = stack.render(img, depth, foc).numpy()
    ref = np.asarray(JaxStack(jsubs).render(img, depth, foc))
    assert got.shape == ref.shape == (2, 12, 32, 48)
    for v, lens in enumerate(subs):
        own = lens.render(img, depth, foc).numpy()
        np.testing.assert_array_equal(got[:, 6 * v:6 * v + 6], own)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-2)


def test_focal_stack_training_noise_draws_per_view():
    """With train=True each view takes its own noise draw from the one
    generator, in lens order: replaying the draws view by view on a fresh
    generator of the same seed gives the same stack."""
    img, depth = _scene(1, 1, 32, 48)
    foc = np.array([-1000.0], np.float32)
    subs = [PSFNetLens(LENS, model_name=m, kernel_size=21, sensor_res=(32, 48),
                       device="cpu").load_net(factory.ported_weights(
                           os.path.join(CKPT, n))) for n, m in SURROGATES]
    got = FocalStackLens(subs).render(img, depth, foc, train=True,
                                      generator=torch.Generator().manual_seed(7))
    gen = torch.Generator().manual_seed(7)
    views = [lens.render(img, depth, foc, train=True, generator=gen) for lens in subs]
    assert torch.equal(got, torch.cat(views, 1))
    assert not torch.equal(got[:, :6], FocalStackLens(subs[:1]).render(img, depth, foc))


def _two_view_stacks():
    """[STEPS, BS, 12, H, W] f64: the stored renders of the train-step
    reference (scripts/make_train_step_reference.py) as view 0, and the
    same pairs with left and right swapped as view 1; depths f64."""
    with np.load(os.path.join(REF_DIR, "train_step_stacks.npz")) as z:
        stacks = z["stacks"].astype(np.float64) / 65535
        depths = z["depths"].astype(np.float64)
    swapped = np.concatenate([stacks[:, :, 3:], stacks[:, :, :3]], axis=2)
    return np.concatenate([stacks, swapped], axis=2), depths


@pytest.fixture(scope="module")
def jax_two_view():
    """The JAX package's 2-view Basenet (random init): its inference output
    on the first stack in float32, and in float64 the first step's gradient
    and three dfdp_train_steps' losses."""
    stacks, depths = _two_view_stacks()
    state = jax.jit(lambda: jax_create_state(jax.random.PRNGKey(0), LR, TOTAL,
                                             (1, 12, *RES))[0])()
    tree = {"params": state.params, "batch_stats": state.batch_stats}
    out = {"tree": _flat(tree)}
    out["forward"] = np.asarray(JB.Basenet().apply(
        tree, jnp.asarray(stacks[0], jnp.float32))["pred_depth_est"])
    with jax.enable_x64(True):
        t64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)
        s64 = state.replace(params=t64["params"], batch_stats=t64["batch_stats"],
                            opt_state=state.tx.init(t64["params"]))
        gt_log, mask = JB.linear_depth(jnp.asarray(depths[0]))

        def loss_fn(params):
            results, _ = s64.apply_fn(
                {"params": params, "batch_stats": s64.batch_stats},
                jnp.asarray(stacks[0]), train=True, mutable=["batch_stats"])
            return JB.compute_loss(results, gt_log, mask)["total"]

        loss0, grads = jax.jit(jax.value_and_grad(loss_fn))(s64.params)
        out.update(loss0=float(loss0), grads=_flat(grads, "params"))
        losses = []
        for k in range(STEPS):
            s64, step = jax_train_step(s64, jnp.asarray(stacks[k]),
                                       jnp.asarray(depths[k]))
            losses.append(float(step["total"]))
        out["losses"] = losses
    return out


def _port_two_view(jax_two_view, dtype=torch.float32, train=False):
    net = TB.build_basenet(device="cpu", n_views=2, train=train)
    load_state(net, jax_two_view["tree"])
    return net.to(dtype)


def test_two_view_basenet_forward_matches_jax(jax_two_view):
    """The 12-channel net: the left channels of both views into one
    6-channel feature tower (and likewise the right)."""
    stacks, _ = _two_view_stacks()
    net = _port_two_view(jax_two_view)
    assert net.dfdp_net.Feature_0.BasicConv_0.Conv_0.weight.shape[1] == 6
    with torch.no_grad():
        got = net(torch.from_numpy(stacks[0]).float())["pred_depth_est"]
    assert _gap(got.numpy(), jax_two_view["forward"]) <= 1e-4
    with pytest.raises(ValueError, match="12"):
        net(torch.zeros(1, 6, *RES))


def test_two_view_train_steps_match_jax_float64(jax_two_view):
    """The first step's gradient leaves (before the optimiser), and the
    losses of three steps, against JAX in float64."""
    stacks, depths = _two_view_stacks()
    net = _port_two_view(jax_two_view, torch.float64, train=True)
    losses = dfdp_grads(net, torch.from_numpy(stacks[0]), torch.from_numpy(depths[0]))
    np.testing.assert_allclose(float(losses["total"]), jax_two_view["loss0"], rtol=1e-6)
    grads = torch_to_flax({n: p.grad for n, p in net.named_parameters()})
    assert set(grads) == set(jax_two_view["grads"])
    worst = max((_gap(grads[k], v), k) for k, v in jax_two_view["grads"].items())
    assert worst[0] <= 1e-4, worst
    state = create_dfdp_state(_port_two_view(jax_two_view, torch.float64, True),
                              LR, TOTAL)
    got = [float(dfdp_train_step(state, torch.from_numpy(s),
                                 torch.from_numpy(d))["total"])
           for s, d in zip(stacks, depths)]
    np.testing.assert_allclose(got, jax_two_view["losses"], rtol=1e-6)


THIN = dict(foc_len=50.0, fnum=1.8, kernel_size=11, sensor_size=[24.0, 36.0],
            sensor_res=(32, 48))


def test_thinlens_coc_and_render_match_jax():
    """ThinLens's CoC (pixels, clipped at 0.1) and its render (the same
    Gaussian disk on both views), f32, within 1e-5."""
    rng = np.random.default_rng(3)
    jl, tl = JaxThinLens(**THIN), ThinLens(**THIN, device="cpu")
    depth = -rng.uniform(100, 30000, (2, 32, 48)).astype(np.float32)
    foc = np.array([-1000.0, -2500.0], np.float32).reshape(2, 1, 1)
    ref = np.asarray(jl.coc(jnp.asarray(depth), jnp.asarray(foc)))
    got = tl.coc(torch.from_numpy(depth), torch.from_numpy(foc)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-5)
    assert got.min() >= 0.1
    img = rng.uniform(0, 1, (2, 3, 32, 48)).astype(np.float32)
    ref = np.asarray(jl.render(img, depth[:, None], foc.reshape(2)))
    got = tl.render(img, depth[:, None], foc.reshape(2)).numpy()
    assert got.shape == ref.shape == (2, 6, 32, 48)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[:, :3], got[:, 3:])


def _write_config(tmp_path, kind):
    """A 64x96 ks-21 config of one lens kind, with absolute paths."""
    sides = {
        "thinlens": {"lens": "thinlens", "foc_len": 50.0, "fnum": 2.8,
                     "sensor_size": [24, 36]},
        "fnum": {"lens": LENS, "psfnet_path": os.path.join(CKPT, "F18_PSFNet_mlp_ks35"),
                 "fnum": 1.8},
        "focus_mm": {"lens": LENS, "psfnet_path": os.path.join(CKPT, "F4_PSFNet_mlp@256"),
                     "psfnet_model": "mlp@256", "focus_mm": -5000.0},
        "stack": {"lens": LENS, "stack": [
            {"psfnet_path": os.path.join(CKPT, "F4_PSFNet_mlp")},
            {"psfnet_path": os.path.join(CKPT, "F4_PSFNet_mlp@256"),
             "psfnet_model": "mlp@256", "focus_mm": -5000.0}]},
    }[kind]
    cfg = {"train": dict(sides, dataset="Synthetic"),
           "test": dict(sides, dataset="Synthetic"),
           "res": [64, 96], "ks": 35 if kind == "fnum" else 21, "lr": 1e-4}
    path = tmp_path / f"{kind}.yml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _jax_focus_samples(self, generator=None, xy=None):
    """The JAX refocus's surface samples (PRNGKey(0)), so that both
    packages refocus on the same rays."""
    r0, d0 = float(self.stack.r[0]), float(self.stack.d[0])
    pts = np.asarray(jax_surface_sample(jax.random.PRNGKey(0), GEO_SPP, r0, d0))
    return torch.from_numpy(pts)


def _same_geometry(got, ref):
    for attr in ("d_sensor", "fnum", "foclen"):
        np.testing.assert_allclose(getattr(got, attr), getattr(ref, attr),
                                   rtol=1e-6, err_msg=attr)
    np.testing.assert_allclose(got.foc_d_arr, ref.foc_d_arr, rtol=1e-6)
    np.testing.assert_allclose(got.foc_d, ref.foc_d, rtol=1e-6)
    np.testing.assert_allclose(got.entrance_pupil(), ref.entrance_pupil(), rtol=1e-6)
    np.testing.assert_allclose(got.stack.r.numpy(), np.asarray(ref.stack.r), rtol=1e-6)
    assert got.kernel_size == ref.kernel_size


@pytest.mark.parametrize("kind", ["thinlens", "fnum", "focus_mm", "stack"])
def test_get_lens_matches_jax_factory(tmp_path, monkeypatch, kind):
    """Each lens kind a config can name, built by both factories: the thin
    lens's constants; the re-stopped (F/1.8) and refocused (5 m, on the
    JAX refocus's own samples) surrogates' sensor distance, f-number, focal
    length, focus prior, pupil and aperture; a stack's views in order."""
    monkeypatch.setattr(Lens, "_focus_samples", _jax_focus_samples)
    args = load_config(_write_config(tmp_path, kind))
    train, test = factory.get_lens(args, device="cpu")
    jtrain, _ = jax_factory.get_lens(args)
    assert type(train) is type(test)
    if kind == "thinlens":
        assert isinstance(train, ThinLens)
        for attr in ("foc_len", "fnum", "kernel_size", "sensor_size",
                     "sensor_res", "ps", "d_min", "d_max"):
            assert getattr(train, attr) == getattr(jtrain, attr), attr
        return
    if kind == "stack":
        assert isinstance(train, FocalStackLens) and train.n_views == 2
        pairs = list(zip(train.lenses, jtrain.lenses))
    else:
        pairs = [(train, jtrain)]
    for got, ref in pairs:
        _same_geometry(got, ref)
        ref_params = _flat(ref.params)
        got_params = torch_to_flax(got.net.state_dict())
        assert set(got_params) == set(ref_params)
    if kind == "fnum":
        assert abs(train.fnum - 1.8) < 0.05 and train.kernel_size == 35


def test_get_lens_missing_surrogate_raises(tmp_path):
    """The port raises on a config's missing surrogate checkpoint (the JAX
    factory builds an untrained net instead)."""
    args = load_config(_write_config(tmp_path, "fnum"))
    args["test"]["psfnet_path"] = os.path.join(CKPT, "F18_PSFNet_missing")
    with pytest.raises(FileNotFoundError, match="F18_PSFNet_missing"):
        factory.get_lens(args, device="cpu")
