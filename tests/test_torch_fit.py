"""The port's PSF-surrogate fit (psfnet/train.py, fit_psfnet.py) against the
JAX package on the CPU: training points, the cosine schedule, AdamW steps
from the same Flax-initialised parameters, the held-out eval on the same
ground truth, the saved surrogate, and the fit as a whole."""

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
from sdirt_tpu_torch import fit_psfnet
from sdirt_tpu_torch.psfnet import train
from sdirt_tpu_torch.psfnet.arch import build_psfnet
from sdirt_tpu_torch.psfnet.surrogate import PSFNetLens
from sdirt_tpu_torch.utils.weights import load_npz, load_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RF50 = os.path.join(ROOT, "lenses", "rf50mm", "lens_web.json")


def _flax_init(model, ks, seed=0):
    net = jax_build_psfnet(model, ks)
    params = net.init(jax.random.PRNGKey(seed), jnp.zeros((1, 3), jnp.float32))
    return net, params


def _flat(params):
    return {k: np.array(v) for k, v in
            flax.traverse_util.flatten_dict(params, sep="/").items()}


def _torch_net(model, ks, params):
    return load_state(build_psfnet(model, ks), _flat(params))


def test_training_points_match_jax():
    """The same uniforms and normals through both transforms."""
    key = jax.random.PRNGKey(4)
    bs = 64
    foc_z = np.array([0.0415, 0.0416, 0.0417], np.float32)
    inp_ref, pts_ref = jax_train.sample_training_points(key, bs, jnp.asarray(foc_z),
                                                        -200.0, -20000.0)
    kf, kx, ky, kz = jax.random.split(key, 4)
    idx = int(jax.random.randint(kf, (), 0, 3))
    ux, uy, g = (torch.tensor(np.asarray(a)) for a in (
        jax.random.uniform(kx, (bs,)), jax.random.uniform(ky, (bs,)),
        jax.random.normal(kz, (bs,))))
    inp, pts = train.training_points(idx, ux, uy, g, foc_z, -200.0, -20000.0)
    np.testing.assert_allclose(inp.numpy(), np.asarray(inp_ref), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(pts.numpy(), np.asarray(pts_ref), rtol=1e-6, atol=1e-4)
    gen = torch.Generator().manual_seed(0)
    idx, ux, uy, g = train.draw_training_samples(gen, bs, 3)
    assert 0 <= idx < 3 and ux.shape == uy.shape == g.shape == (bs,)


def test_cosine_annealing_over_one_and_a_half_periods():
    lr, t_max = 1e-4, 10
    mine = train.cosine_annealing(lr, t_max)
    ref = jax_train.cosine_annealing(lr, t_max)
    steps = range(0, 16)
    np.testing.assert_allclose([mine(t) for t in steps],
                               [float(ref(jnp.int32(t))) for t in steps], rtol=1e-5)
    assert mine(t_max) == pytest.approx(0.0, abs=1e-20)
    assert mine(15) == pytest.approx(lr / 2)
    # the scheduler gives update t the rate schedule(t)
    state = train.create_train_state(build_psfnet("mlp@16", 3).init_(
        torch.Generator().manual_seed(0)), lr, 3 * t_max)
    for t in steps:
        assert state.opt.param_groups[0]["lr"] == pytest.approx(mine(t), rel=1e-12)
        state.opt.step()
        state.sched.step()


def test_three_train_steps_match_optax():
    """Loss and parameters after each of three AdamW steps, from the same
    Flax-initialised MLP, inputs and ground truth (lr 1e-4, t_max 3, so the
    rate moves during the steps)."""
    model, ks, bs, lr, iters = "mlp@64", 7, 8, 1e-4, 9
    rng = np.random.default_rng(0)
    inp = rng.uniform(-1, 1, (bs, 3)).astype(np.float32)
    gt = rng.uniform(0, 1, (bs, ks, ks)).astype(np.float32)
    net, params = _flax_init(model, ks)
    tx = optax.adamw(jax_train.cosine_annealing(lr, max(iters // 3, 1)))
    opt_state = tx.init(params)

    def loss_fn(p):
        return jnp.mean((net.apply(p, jnp.asarray(inp)).reshape(bs, ks, ks) - gt) ** 2)

    state = train.create_train_state(_torch_net(model, ks, params), lr, iters)
    for _ in range(3):
        with jax.default_matmul_precision("highest"):
            loss_ref, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        loss = train.fit_step(state, torch.from_numpy(inp), torch.from_numpy(gt))
        assert float(loss) == pytest.approx(float(loss_ref), rel=1e-5)
        ref = _flat(params)
        got = {k: v.detach().numpy() for k, v in state.net.state_dict().items()}
        for key, arr in ref.items():
            module, leaf = key.split("/")[-2:]
            mine = got[f"{module}.{'weight' if leaf == 'kernel' else 'bias'}"]
            mine = mine.T if leaf == "kernel" else mine
            np.testing.assert_allclose(mine, arr, rtol=1e-5, atol=1e-8, err_msg=key)
    assert state.step == 3


def _fake_psf(xp, pts, ks):
    """A ground truth that depends on every coordinate of the points."""
    u = xp.linspace(-1.0, 1.0, ks)
    gx = (u[None, None, :] - pts[:, 0, None, None]) ** 2
    gy = (u[None, :, None] - pts[:, 1, None, None]) ** 2
    return xp.exp(-gx - gy) * (1.0 + xp.abs(pts[:, 2, None, None]) / 1000.0)


def test_eval_matches_jax_same_ground_truth(monkeypatch):
    """make_eval_fn in both packages, their traced ground truth replaced by
    the same function of the eval points: the points, the net and the
    sum-normalised L1 / L2 agree (256 points: two chunks of 128)."""
    model, ks, bs = "mlp@64", 7, 256
    jlens = JPSFNetLens(RF50, model_name=model, kernel_size=ks, sensor_res=(512, 768))
    monkeypatch.setattr(jax_train, "dp_psf", lambda stack, eta, skip, pts, k, sc, **kw:
                        (_fake_psf(jnp, pts, ks), None))
    monkeypatch.setattr(train, "dp_psf_fused", lambda pts, gen, sc, plan, **kw:
                        (_fake_psf(torch, pts, ks), None))
    eta, skip = jlens.eta_arrays(0.589, True)
    l1_ref, l2_ref = jax_train.make_eval_fn(jlens, bs=bs, spp=64, ks=ks)(
        jlens.params, jax.random.PRNGKey(0), jlens.stack, eta, skip,
        jax_train.lens_scalars(jlens))
    lens = PSFNetLens(RF50, model_name=model, kernel_size=ks, sensor_res=(512, 768),
                      device="cpu")
    load_state(lens.net, _flat(jlens.params))
    l1, l2 = train.make_eval_fn(lens, bs=bs, spp=64, ks=ks)(lens.net, torch.Generator())
    assert float(l1) == pytest.approx(float(l1_ref), rel=1e-5)
    assert float(l2) == pytest.approx(float(l2_ref), rel=1e-5)
    with pytest.raises(ValueError, match="perfect square"):
        train.make_eval_fn(lens, bs=200, spp=64, ks=ks)


def test_save_net_roundtrip(tmp_path):
    lens = PSFNetLens(RF50, kernel_size=21, sensor_res=(512, 768), device="cpu")
    path = str(tmp_path / "psfnet_mlp.npz")
    lens.save_net(path)
    shipped = load_npz(os.path.join(ROOT, "sdirt_tpu_torch", "weights", "rf50mm",
                                    "F4_PSFNet_mlp.npz"))
    saved = load_npz(path)
    assert {k: v.shape for k, v in saved.items()} == {k: v.shape for k, v in shipped.items()}
    other = PSFNetLens(RF50, kernel_size=21, sensor_res=(512, 768), seed=1,
                       device="cpu").load_net(path)
    inp = torch.rand((5, 3), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert torch.equal(other.net(inp), lens.net(inp))
    assert torch.equal(other.pred(inp), lens.pred(inp))


def test_psfnet_lens_quirks():
    lens = PSFNetLens(RF50, kernel_size=21, sensor_res=(512, 768), device="cpu")
    jlens = JPSFNetLens(RF50, kernel_size=21, sensor_res=(512, 768))
    assert lens.d_sensor == jlens.d_sensor == 62.25
    assert lens.hfov == pytest.approx(jlens.hfov, rel=1e-6)
    np.testing.assert_array_equal(lens.foc_z_arr, jlens.foc_z_arr)
    lens.set_focus_prior(-5000.0)
    jlens.set_focus_prior(-5000.0)
    np.testing.assert_array_equal(lens.foc_z_arr, jlens.foc_z_arr)
    np.testing.assert_array_equal(lens.foc_d, jlens.foc_d)
    z = torch.tensor([0.0, 0.3, 1.0])
    np.testing.assert_allclose(lens.z2depth(z).numpy(), np.asarray(jlens.z2depth(z.numpy())))


FIT_CPU = ["--device", "cpu", "--bs", "4", "--spp", "256", "--iters", "3",
           "--evaluate-every", "2", "--eval-bs", "16", "--eval-spp", "512",
           "--skip-analysis"]


def test_fit_psfnet_slice_end_to_end(tmp_path, monkeypatch):
    """python -m sdirt_tpu_torch.fit_psfnet on the CPU at a tiny size: it
    runs iters + 1 steps, evaluates after steps 1 and 3, writes lens.json,
    the train state and the surrogate, which the serve path loads and
    renders with; --resume carries on from the newest state."""
    monkeypatch.chdir(ROOT)
    out = str(tmp_path / "fit")
    res = fit_psfnet.main(FIT_CPU + ["--result-dir", out])
    losses = np.array(res["losses"])
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert [e[0] for e in res["evals"]] == [1, 3]
    assert all(np.isfinite(e[1:]).all() for e in res["evals"])
    assert res["d_sensor"] == pytest.approx(62.25, abs=0.05)
    for name in ("lens.json", "psfnet_mlp.npz", "compare_psf.npz",
                 "state/step_2.pt", "state/step_4.pt"):
        assert os.path.exists(os.path.join(out, name)), name
    cmp = np.load(os.path.join(out, "compare_psf.npz"))
    assert cmp["traced"].shape == (2, 2, 3, 21, 21)
    assert cmp["pred"].shape == (2, 3, 2, 21, 21)

    lens = PSFNetLens(RF50, kernel_size=21, sensor_res=(512, 768), device="cpu")
    lens.load_net(os.path.join(out, "psfnet_mlp.npz"))
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (1, 3, 16, 24)).astype(np.float32)
    depth = -rng.uniform(500, 3000, (1, 1, 16, 24)).astype(np.float32)
    dof = lens.render(img, depth, None)
    assert dof.shape == (1, 6, 16, 24) and bool(torch.isfinite(dof).all())

    res2 = fit_psfnet.main(FIT_CPU + ["--iters", "5", "--resume", "--result-dir", out])
    assert res2["start"] == 4 and len(res2["losses"]) == 2


def test_fit_psfnet_refuses_what_is_not_ported(tmp_path):
    with pytest.raises(NotImplementedError, match="mesh"):
        fit_psfnet.main(["--device", "cpu", "--skip-analysis", "--mesh", "1", "2"])
