"""The port's other PSF-surrogate heads (psfnet/arch.py: MLPConv, Siren,
PSFMLPLum), their fit steps, the PSF-map batches of psfnet/train.py, the
.pkl loader and the trace switch, against the JAX package on the CPU.

Tolerances: forwards on carried-across seeded Flax weights within 1e-5 of
the largest output (f32); three fit steps in float64 against optax: losses
within 1e-8 relative (measured 4e-14), parameters within 1e-7 of each
leaf's largest entry (measured 5.8e-8: where a gradient is of the order of
Adam's eps, 1e-8, its last-bit differences move the update by ~1/eps
times as much); get_training_psf_map on the same PSFs within 1e-6.
"""

import importlib.util
import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import sdirt_tpu.psfnet.train as jax_train
from sdirt_tpu.psfnet.arch import build_psfnet as jax_build_psfnet
from sdirt_tpu.psfnet.surrogate import PSFNetLens as JPSFNetLens
from sdirt_tpu_torch.psfnet import train
from sdirt_tpu_torch.psfnet.arch import MLPConv, PSFMLPLum, Siren, build_psfnet
from sdirt_tpu_torch.psfnet.surrogate import PSFNetLens
from sdirt_tpu_torch.utils.weights import load_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RF50 = os.path.join(ROOT, "lenses", "rf50mm", "lens_web.json")
HEADS = [("mlpconv", 21), ("mlpconv", 24), ("siren", 11), ("mlp+lum", 7)]


def _export_script():
    spec = importlib.util.spec_from_file_location(
        "export_torch_weights", os.path.join(ROOT, "scripts", "export_torch_weights.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _flax(model, ks, seed=0):
    net = jax_build_psfnet(model, ks)
    return net, net.init(jax.random.PRNGKey(seed), jnp.zeros((1, 3), jnp.float32))


def _flat(params):
    return {k: np.array(v) for k, v in flax.traverse_util.flatten_dict(params, sep="/").items()}


@pytest.mark.parametrize("model,ks", HEADS, ids=lambda v: str(v))
def test_forward_on_carried_weights(model, ks):
    """The exported seeded Flax initialisation (scripts/export_torch_weights.py
    psfnet_init_tree) loads strictly and the forwards agree within 1e-5 of
    the largest output; MLPConv at an odd and an even ks_mlp (5, 6)."""
    net, params = _flax(model, ks)
    tree = _export_script().psfnet_init_tree(model, ks, 0)
    tnet = load_state(build_psfnet(model, ks), tree)
    x = np.random.default_rng(0).uniform(-1, 1, (6, 3)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = net.apply(params, jnp.asarray(x))
    with torch.no_grad():
        got = tnet(torch.from_numpy(x))
    ref = ref if isinstance(ref, tuple) else (ref,)
    got = got if isinstance(got, tuple) else (got,)
    for r, g in zip(ref, got):
        r = np.asarray(r)
        assert g.shape == r.shape
        assert np.abs(g.numpy() - r).max() <= 1e-5 * np.abs(r).max()


@pytest.mark.parametrize("model,cls", [("mlpconv", MLPConv), ("siren", Siren),
                                       ("mlp+lum", PSFMLPLum)])
def test_init_draws_flax_distributions(model, cls):
    """init_ draws from the Flax initialisers' distributions: zero biases
    and each layer's weights within the Flax bound and of its scale."""
    ks = 9
    tnet = build_psfnet(model, ks).init_(torch.Generator().manual_seed(0))
    assert isinstance(tnet, cls)
    _, params = _flax(model, ks)
    ref = _flat(params["params"])
    state = tnet.state_dict()
    for key, arr in ref.items():
        module, leaf = key.split("/")
        t = state[f"{module}.{'weight' if leaf == 'kernel' else 'bias'}"].numpy()
        assert t.size == arr.size, key
        if leaf == "bias":
            assert not t.any(), key
        else:
            # the same distribution: the spreads agree within sampling noise
            assert np.std(t) == pytest.approx(np.std(arr), rel=0.25), key
            assert np.abs(t).max() <= np.abs(arr).max() * 1.3 + 1e-12, key


def _fit_steps_f64(model, ks, bs=4, lr=1e-3, iters=9, seed=1):
    """Three AdamW steps of a head in float64, JAX (optax) and the port, from
    the same weights, inputs and ground truth. mlp+lum is fitted on its PSF
    and a unit luminance (the JAX fit takes no tuple output)."""
    rng = np.random.default_rng(seed)
    inp = rng.uniform(-1, 1, (bs, 3))
    gt = rng.uniform(0, 1, (bs, ks, ks))
    net, params = _flax(model, ks)
    with jax.enable_x64(True):
        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
        tx = optax.adamw(jax_train.cosine_annealing(lr, max(iters // 3, 1)))
        opt_state = tx.init(params)

        def loss_fn(p):
            out = net.apply(p, jnp.asarray(inp))
            if model == "mlp+lum":
                psf, lum = out
                return jnp.mean((psf - gt) ** 2) + jnp.mean((lum - 1.0) ** 2)
            return jnp.mean((out.reshape(bs, ks, ks) - gt) ** 2)

        ref_losses, ref_params = [], []
        grad_fn = jax.jit(jax.value_and_grad(loss_fn))
        for _ in range(3):
            loss, grads = grad_fn(params)
            updates, opt_state = tx.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            ref_losses.append(float(loss))
            ref_params.append(_flat(params))
    _, p0 = _flax(model, ks)
    tnet = load_state(build_psfnet(model, ks), _flat(p0)).double()
    state = train.create_train_state(tnet, lr, iters)
    losses = []
    for _ in range(3):
        x, y = torch.from_numpy(inp), torch.from_numpy(gt)
        if model == "mlp+lum":
            state.opt.zero_grad(set_to_none=True)
            psf, lum = state.net(x)
            loss = torch.mean((psf - y) ** 2) + torch.mean((lum - 1.0) ** 2)
            loss.backward()
            state.opt.step()
            state.sched.step()
            loss = loss.detach()
        else:
            loss = train.fit_step(state, x, y)
        losses.append(float(loss))
    return losses, ref_losses, state.net, ref_params[-1]


@pytest.mark.parametrize("model,ks", [("mlpconv", 9), ("siren", 5), ("mlp+lum", 5)])
def test_three_fit_steps_float64_match_optax(model, ks):
    losses, ref_losses, tnet, ref = _fit_steps_f64(model, ks)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-8)
    from sdirt_tpu_torch.utils.weights import torch_to_flax

    got = torch_to_flax(tnet.state_dict())
    for key, arr in ref.items():
        np.testing.assert_allclose(got[key], arr, rtol=0, atol=1e-7 * np.abs(arr).max(),
                                   err_msg=key)


def _fake_rgb(xp, pts, ks):
    """RGB 'PSFs' [N, 3, ks, ks] that depend on every coordinate."""
    u = xp.linspace(-1.0, 1.0, ks)
    gx = (u[None, None, None, :] - pts[:, 0, None, None, None]) ** 2
    gy = (u[None, None, :, None] - pts[:, 1, None, None, None]) ** 2
    w = xp.asarray(np.array([1.0, 0.7, 0.4], np.float32))[None, :, None, None]
    return xp.exp(-(gx + gy) * w) * (1.0 + xp.abs(pts[:, 2, None, None, None]) / 1e4)


def test_training_psf_map_matches_jax(monkeypatch):
    """get_training_psf_map on the same draws and the same PSFs (a function
    of the grid points in both packages): the inputs and the tiled,
    antialiased-resized maps within 1e-6."""
    ks, bs = 7, 3
    jlens = JPSFNetLens(RF50, kernel_size=ks, sensor_res=(512, 768))
    lens = PSFNetLens(RF50, kernel_size=ks, sensor_res=(512, 768), device="cpu")
    import sdirt_tpu.dp.psf as jax_psf

    monkeypatch.setattr(jax_psf, "compute_psf_rgb",
                        lambda lens, pts, key=None, spp=0, ks=0: _fake_rgb(jnp, jnp.asarray(pts), ks))
    monkeypatch.setattr(train, "compute_psf_rgb",
                        lambda lens, pts, gen=None, spp=0, ks=0: _fake_rgb(
                            torch, torch.from_numpy(pts), ks))
    key = jax.random.PRNGKey(3)
    inp_ref, maps_ref = jax_train.get_training_psf_map(jlens, key, bs=bs, psf_grid=(5, 6),
                                                       psf_map_size=(16, 24))
    kf, kz, _ = jax.random.split(key, 3)
    idx = int(jax.random.randint(kf, (), 0, len(jlens.foc_z_arr)))
    g = np.asarray(jax.random.normal(kz, (bs,)))
    inp, maps = train.get_training_psf_map(lens, bs=bs, psf_grid=(5, 6),
                                           psf_map_size=(16, 24), draws=(idx, g))
    np.testing.assert_allclose(inp.numpy(), np.asarray(inp_ref), rtol=0, atol=1e-6)
    assert maps.shape == (bs, 3, 16, 24)
    np.testing.assert_allclose(maps.numpy(), np.asarray(maps_ref), rtol=0, atol=1e-6)
    gen = torch.Generator().manual_seed(0)
    inp2, maps2 = train.get_training_psf_map(lens, gen, bs=2, psf_grid=(3, 3),
                                             psf_map_size=(8, 8))
    assert inp2.shape == (2, 2) and maps2.shape == (2, 3, 8, 8)


def test_load_net_pkl_matches_jax(tmp_path):
    """A reference PyTorch state dict (.pkl, layers net.<i>) goes into the
    Dense layers in order, leaves of another shape skipped, as the JAX
    load_torch_psfnet does."""
    ks = 5
    jlens = JPSFNetLens(RF50, model_name="mlp@16", kernel_size=ks, sensor_res=(512, 768))
    lens = PSFNetLens(RF50, model_name="mlp@16", kernel_size=ks, sensor_res=(512, 768),
                      device="cpu")
    gen = torch.Generator().manual_seed(1)
    dims = [3, 4, 16, 16, 16, 16, 16, 16, 16, 16, 16, 99]    # the last layer mismatches
    sd = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        sd[f"net.{i}.weight"] = torch.randn(b, a, generator=gen)
        sd[f"net.{i}.bias"] = torch.randn(b, generator=gen)
    path = str(tmp_path / "ref.pkl")
    torch.save(sd, path)
    load_state(lens.net, _flat(jlens.params))
    jlens.load_net(path)
    lens.load_net(path)
    x = np.random.default_rng(0).uniform(-1, 1, (4, 3)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jlens.net.apply(jlens.params, jnp.asarray(x)))
    with torch.no_grad():
        got = lens.net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def test_build_psfnet_names():
    assert isinstance(build_psfnet("mlpconv", 21), MLPConv)
    assert isinstance(build_psfnet("siren", 21), Siren)
    assert isinstance(build_psfnet("mlp+lum", 21), PSFMLPLum)
    with pytest.raises(ValueError, match="Unsupported"):
        build_psfnet("resnet", 21)


@pytest.mark.parametrize("mode", ["scan", "specialized"])
def test_trace_switch(monkeypatch, mode):
    """SDIRT_TRACE=scan / specialized feed the fit the per-surface or the
    specialised trace's PSFs: the same pupil samples give the PSFs of
    dp_psf; an unknown name raises."""
    from sdirt_tpu_torch.dp.psf import dp_psf, lens_scalars

    lens = PSFNetLens(RF50, kernel_size=7, sensor_res=(512, 768), device="cpu")
    monkeypatch.setenv("SDIRT_TRACE", mode)
    assert train.trace_mode() == mode
    pts = torch.tensor([[0.2, -0.3, -900.0], [0.0, 0.0, -1500.0]])
    got = train.make_psf_fn(lens)(pts, torch.Generator().manual_seed(0), 256, 7, 2048)
    eta, skip = lens.eta_arrays(0.589, True)
    ref = dp_psf(lens.stack, eta, skip, pts, torch.Generator().manual_seed(0),
                 lens_scalars(lens), spp=256, ks=7)[0]
    assert torch.allclose(got, ref, atol=1e-5)
    monkeypatch.setenv("SDIRT_TRACE", "magic")
    with pytest.raises(ValueError, match="SDIRT_TRACE"):
        train.trace_mode()
