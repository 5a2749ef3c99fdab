"""Carrying parameters across from the JAX package's Flax trees to the
PyTorch port (sdirt_tpu_torch/utils/weights.py), and the committed exports.
"""

import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sdirt_tpu_torch.dfdp.basenet import build_basenet
from sdirt_tpu_torch.psfnet.arch import build_psfnet
from sdirt_tpu_torch.utils.weights import (flax_to_torch, load_npz,
                                           torch_to_flax)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "sdirt_tpu_torch", "weights", "rf50mm")


def _flat(tree, prefix):
    return {f"{prefix}/{k}": np.asarray(v) for k, v in
            flax.traverse_util.flatten_dict(tree, sep="/").items()}


def _roundtrip(flat, module):
    state = flax_to_torch(flat)
    for k, v in module.state_dict().items():
        if k.endswith("num_batches_tracked"):
            state[k] = v
    module.load_state_dict(state, strict=True)
    back = torch_to_flax(module.state_dict())
    assert set(back) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)


def test_psfmlp_roundtrip():
    from sdirt_tpu.psfnet.arch import build_psfnet as jax_build

    params = jax_build("mlp@64", 5).init(jax.random.PRNGKey(1), jnp.zeros((1, 3)))
    _roundtrip(_flat(params["params"], "params"), build_psfnet("mlp@64", 5))


def test_dddnet_roundtrip():
    from sdirt_tpu.dfdp.basenet import Basenet

    shapes = jax.eval_shape(lambda: Basenet().init(
        jax.random.PRNGKey(2), jnp.zeros((1, 6, 128, 192)), train=False))
    # distinct values for every leaf, so a swapped or mis-transposed leaf shows
    rng = np.random.default_rng(0)
    flat = {f"{coll}/{k}": rng.normal(size=s.shape).astype(np.float32)
            for coll in ("params", "batch_stats") for k, s in
            flax.traverse_util.flatten_dict(shapes[coll], sep="/").items()}
    _roundtrip(flat, build_basenet(device="cpu"))


@pytest.mark.parametrize("name", ["F4_PSFNet_mlp", "Sdirt_best_acc1"])
def test_committed_exports_equal_fresh_export(name):
    """The committed .npz files equal a fresh restore of the orbax trees."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "export_torch_weights",
        os.path.join(ROOT, "scripts", "export_torch_weights.py"))
    export = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(export)
    fresh = {"F4_PSFNet_mlp": export.psfnet_tree,
             "Sdirt_best_acc1": export.depthnet_tree}[name]()
    committed = load_npz(os.path.join(WEIGHTS, f"{name}.npz"))
    assert set(committed) == set(fresh)
    for k, v in fresh.items():
        assert committed[k].dtype == np.float32
        np.testing.assert_array_equal(committed[k], v, err_msg=k)


NEW_EXPORTS = [("rf50mm", "F4_PSFNet_mlpb@256x48"), ("rf35mm", "F4_PSFNet_mlp"),
               ("rf35mm", "F4_PSFNet_mlpb@256x48"), ("rf35mm", "Sdirt_best_acc1"),
               ("rf50mm", "F18_PSFNet_mlp_ks35"), ("rf50mm", "F4_PSFNet_mlp@256"),
               ("rf50mm", "Sdirt_f4_farfield"), ("rf50mm", "Sdirt_f18_farfield"),
               ("rf50mm", "Sdirt_deblur_demo_cpu"), ("rf35mm", "F4_PSFNet_mlp@256")]


def _export_script():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "export_torch_weights",
        os.path.join(ROOT, "scripts", "export_torch_weights.py"))
    export = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(export)
    return export


@pytest.mark.parametrize("lens,name", NEW_EXPORTS, ids=[f"{l}/{n}" for l, n in NEW_EXPORTS])
def test_lens_exports_equal_fresh_export(lens, name):
    """The rf35mm trees, both lenses' promoted basis students, the far-field
    A/B's nets (the F/1.8 ks-35 surrogate), the 256-wide F/4 surrogate and
    the deblur demo net: the committed .npz equal a fresh restore of the
    orbax trees (inference leaves only), and the port builds each net from
    its name and loads it strictly."""
    export = _export_script()
    fresh = export.tree(lens, name)
    assert {k.split("/")[0] for k in fresh} <= {"params", "batch_stats"}
    path = os.path.join(ROOT, "sdirt_tpu_torch", "weights", lens, f"{name}.npz")
    committed = load_npz(path)
    assert set(committed) == set(fresh)
    for k, v in fresh.items():
        assert committed[k].dtype == np.float32
        np.testing.assert_array_equal(committed[k], v, err_msg=k)
    if name.startswith("Sdirt"):
        mode = "deblur" if name in export.DEBLUR_NETS else "dfdp"
        net = build_basenet(path, device="cpu", train_mode=mode)
        assert hasattr(net, "deblur_net") == (mode == "deblur")
    else:
        from sdirt_tpu_torch.utils.weights import load_state

        load_state(build_psfnet(*export.psfnet_arch(name)), path)


def test_rf35mm_warm_start_forward_matches_jax():
    """The rf35mm F4_PSFNet_mlp@256 export (the basis students' warm start
    and gate_rf35_student's default student): the port's net on it equals
    the JAX net on its orbax tree, on seeded queries (f32, the MLP's
    summation order only)."""
    import torch

    from sdirt_tpu.psfnet.surrogate import PSFNetLens as JaxLens
    from sdirt_tpu_torch.psfnet.surrogate import PSFNetLens

    lens = os.path.join(ROOT, "lenses", "rf35mm", "lens_web.json")
    jax_lens = JaxLens(lens, model_name="mlp@256", kernel_size=21, sensor_res=(512, 768))
    jax_lens.load_net(os.path.join(ROOT, "ckpt", "rf35mm", "F4_PSFNet_mlp@256"))
    port = PSFNetLens(lens, model_name="mlp@256", kernel_size=21, sensor_res=(512, 768),
                      device="cpu")
    port.load_net(os.path.join(ROOT, "sdirt_tpu_torch", "weights", "rf35mm",
                               "F4_PSFNet_mlp@256.npz"))
    rng = np.random.default_rng(35)
    inp = np.stack([rng.uniform(-1, 1, 256), rng.uniform(-1, 1, 256),
                    rng.uniform(0, 1, 256)], -1).astype(np.float32)
    want = np.asarray(jax_lens.net.apply(jax_lens.params, jnp.asarray(inp)))
    with torch.no_grad():
        got = port.net(torch.from_numpy(inp)).numpy()
    assert got.shape == want.shape == (256, 441)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_exports_are_what_the_port_loads():
    """The script exports the trees the port's configs and promoted
    surrogates name, and nothing else."""
    export = _export_script()
    names = {(l, n) for l, n in export.EXPORTS}
    assert names == {("rf50mm", "F4_PSFNet_mlp"), ("rf50mm", "Sdirt_best_acc1"),
                     *NEW_EXPORTS}
    on_disk = {(l, f[:-4]) for l in ("rf50mm", "rf35mm")
               for f in os.listdir(os.path.join(ROOT, "sdirt_tpu_torch", "weights", l))}
    assert on_disk == names


@pytest.mark.parametrize("train_mode,n_views", [("deblur", 1), ("dfdp", 2)])
def test_deblur_and_stack_nets_roundtrip(train_mode, n_views):
    """The deblur Basenet (Mydeblur: biased convolutions, transposed ones,
    the attention gamma) and a 2-view net (a 6-channel feature tower)."""
    from sdirt_tpu.dfdp.basenet import Basenet

    shapes = jax.eval_shape(lambda: Basenet(train_mode=train_mode).init(
        jax.random.PRNGKey(2), jnp.zeros((1, 6 * n_views, 128, 192)),
        train=False))
    rng = np.random.default_rng(1)
    flat = {f"{coll}/{k}": rng.normal(size=s.shape).astype(np.float32)
            for coll in ("params", "batch_stats") for k, s in
            flax.traverse_util.flatten_dict(shapes[coll], sep="/").items()}
    _roundtrip(flat, build_basenet(device="cpu", train_mode=train_mode,
                                   n_views=n_views))


def test_basis_student_roundtrip():
    from sdirt_tpu.psfnet.arch import build_psfnet as jax_build

    params = jax_build("mlpb@64x12", 5).init(jax.random.PRNGKey(1), jnp.zeros((1, 3)))
    _roundtrip(_flat(params["params"], "params"), build_psfnet("mlpb@64x12", 5))
