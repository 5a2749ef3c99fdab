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
