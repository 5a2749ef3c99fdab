"""The PyTorch port's multi-GPU paths (sdirt_tpu_torch/parallel/) on the CPU:
2 and 4 gloo processes, each sharded step held to the one-rank step on the
same samples (SGD for the fit, as tests/test_parallel.py does, so the
update is linear in the gradient), and the data-parallel DfDP step to the
JAX package's sharded step in float64
(sdirt_tpu_torch/reference/dp_step_jax_cpu.json,
scripts/make_dp_step_reference.py).

Every test spawns its ranks through parallel.mesh.launch with a join time
limit of its own, so a hung rank fails the test instead of stalling the
suite.
"""

import json
import os

import numpy as np
import pytest
import torch

from sdirt_tpu_torch.parallel import launch, shard_batch
from sdirt_tpu_torch.parallel.equivalence import dfdp_rank, fit_rank, psf_rank
from sdirt_tpu_torch.parallel.mesh import Mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(ROOT, "sdirt_tpu_torch", "reference")
LENS = os.path.join(ROOT, "lenses", "rf50mm", "lens_web.json")
WEIGHTS = os.path.join(ROOT, "sdirt_tpu_torch", "weights", "rf50mm")
CPU = torch.device("cpu")
JOIN_S = 300.0


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test files at once on the machine's cores;
    the one-rank runs here keep to two threads (the ranks split the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _psf_spec():
    rng = np.random.default_rng(0)
    pts = np.stack([rng.uniform(-1, 1, 8), rng.uniform(-1, 1, 8),
                    -(rng.uniform(0, 1, 8) * 5000 + 500)], -1).astype(np.float32)

    def disk(n, radius):
        r, th = np.sqrt(rng.random(n)) * radius, rng.random(n) * 2 * np.pi
        return np.stack([r * np.cos(th), r * np.sin(th)], -1).astype(np.float32)

    return {"lens": LENS, "ks": 11, "spp": 512, "points": pts,
            "pupil_main": disk(512, 5.0), "pupil_chief": disk(128, 1.2)}


@pytest.mark.parametrize("world", [2, 4])
def test_dp_psf_split_over_rays(world):
    """dp_psf_fused with its rays split over 2 or 4 ranks (raw grids summed
    before the max-normalisation) equals the whole bundle on one rank."""
    spec = _psf_spec()
    one = psf_rank(0, 1, CPU, spec)
    outs = launch(psf_rank, world, args=(spec,), timeout=JOIN_S)
    for out in outs:
        for view in ("psf_l", "psf_r"):
            np.testing.assert_allclose(out[view], one[view], rtol=0, atol=1e-6)


@pytest.mark.parametrize("world,n_data", [(2, 1), (2, 2), (4, 2)])
def test_fit_step_equals_one_rank(world, n_data):
    """make_sharded_psfnet_step over (n_data, world / n_data): an SGD step
    gives the one-rank step's loss (1e-6 relative) and parameters."""
    spec = {"lens": LENS, "ks": 11, "model": "mlp@32", "bs": 8, "spp": 256,
            "lr": 10.0, "steps": 1, "n_data": n_data, "seed": 3}
    one = fit_rank(0, 1, CPU, {**spec, "n_data": 1})
    outs = launch(fit_rank, world, args=(spec,), timeout=JOIN_S)
    for out in outs:
        np.testing.assert_allclose(out["losses"], one["losses"], rtol=1e-6)
        scale = np.abs(one["params"]).max()
        np.testing.assert_allclose(out["params"], one["params"], rtol=0,
                                   atol=1e-6 * scale)
    assert not np.allclose(one["params"], fit_rank(0, 1, CPU, {**spec, "steps": 0,
                                                              "n_data": 1})["params"])


@pytest.fixture(scope="module")
def stored():
    with np.load(os.path.join(REF, "train_step_stacks.npz")) as z:
        stacks = z["stacks"].astype(np.float64) / 65535
        depths = z["depths"].astype(np.float64)
    with np.load(os.path.join(REF, "train_step_deblur_aif.npz")) as z:
        aifs = z["aif"].astype(np.float64) / 255
    return stacks, depths, aifs


def test_dfdp_step_matches_jax_sharded_float64(stored):
    """Three data-parallel DfDP steps over 2 ranks (bs 2, one sample each) in
    float64 from the shipped net: the losses and the BatchNorm running
    statistics within 1e-6 of the JAX package's sharded step on a (2, 1)
    CPU mesh."""
    with open(os.path.join(REF, "dp_step_jax_cpu.json")) as f:
        ref = json.load(f)
    stats = np.load(os.path.join(REF, "dp_step_batch_stats.npz"))
    stacks, depths, _ = stored
    spec = {"weights": os.path.join(WEIGHTS, "Sdirt_best_acc1.npz"), "dtype": "float64",
            "lr": ref["lr"], "total_steps": ref["total_steps"], "steps": ref["steps"],
            "stacks": stacks, "depths": depths}
    outs = launch(dfdp_rank, ref["n_data"], args=(spec,), timeout=JOIN_S)
    for out in outs:
        np.testing.assert_allclose([l["total"] for l in out["losses"]], ref["losses"],
                                   rtol=ref["rtol"])
        got = {k[len("batch_stats/"):]: v for k, v in out["batch_stats"].items()}
        assert set(got) == set(stats.files)
        for k in stats.files:
            np.testing.assert_allclose(got[k], stats[k], rtol=1e-6,
                                       atol=1e-6 * np.abs(stats[k]).max(), err_msg=k)
    np.testing.assert_array_equal(outs[0]["params"], outs[1]["params"])


@pytest.mark.parametrize("mode,weights", [("dfdp", "Sdirt_best_acc1"),
                                          ("deblur", "Sdirt_deblur_demo_cpu")])
def test_dfdp_step_equals_one_rank(stored, mode, weights):
    """One data-parallel SGD step over 2 ranks in float32 (the deblur step
    with the all-in-focus target split with the batch) equals the one-rank
    step on the whole batch: the loss terms and the BatchNorm running
    statistics within 1e-5 relative, the parameters within 1e-6 of their
    largest."""
    stacks, depths, aifs = stored
    spec = {"weights": os.path.join(WEIGHTS, f"{weights}.npz"), "train_mode": mode,
            "lr": 1e-2, "sgd": True, "total_steps": 3, "steps": 1, "stacks": stacks[:1],
            "depths": depths[:1], "aifs": aifs[:1]}
    one = dfdp_rank(0, 1, CPU, spec)
    outs = launch(dfdp_rank, 2, args=(spec,), timeout=JOIN_S)
    for out in outs:
        assert set(out["losses"][0]) == set(one["losses"][0])
        for k, v in one["losses"][0].items():
            assert abs(out["losses"][0][k] - v) <= 1e-5 * abs(v), (k, out["losses"], v)
        for k, v in one["batch_stats"].items():
            np.testing.assert_allclose(out["batch_stats"][k], v, rtol=1e-5,
                                       atol=1e-5 * np.abs(v).max(), err_msg=k)
        np.testing.assert_allclose(out["params"], one["params"], rtol=0,
                                   atol=1e-6 * np.abs(one["params"]).max())


def _fails(rank, world, dev, spec):
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    torch.distributed.barrier()          # rank 0 waits for a peer that never comes
    return {}


def _hangs(rank, world, dev, spec):
    import time

    time.sleep(600)


def test_launch_raises_when_a_rank_fails_or_hangs():
    """A rank's exception comes back as RuntimeError with its traceback; a
    rank past the join limit as TimeoutError; no process is left behind."""
    import multiprocessing

    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        launch(_fails, 2, args=({},), timeout=JOIN_S)
    with pytest.raises(TimeoutError):
        launch(_hangs, 2, args=({},), timeout=10.0)
    assert not multiprocessing.active_children()


def test_shard_batch_and_mesh_layout():
    """A rank's slice of a host batch is its data index's equal share; a
    batch that does not split raises."""
    x = np.arange(12).reshape(6, 2)
    mesh = Mesh(3, 2, rank=3)             # data index 1, rays index 1
    assert mesh.data_index == 1
    np.testing.assert_array_equal(shard_batch(x, mesh), x[2:4])
    assert shard_batch([x, None], mesh)[1] is None
    with pytest.raises(ValueError, match="does not split"):
        shard_batch(x[:5], mesh)


def test_data_parallel_training_over_two_ranks(tmp_path):
    """dfdp_net's --stage train on 2 gloo ranks (the path --data-parallel
    takes on two cards): each rank reads its half of the same batches, the
    step's losses are those of the whole batch on both ranks, and rank 0
    alone validates and writes the export and the train state."""
    from sdirt_tpu_torch import dfdp_net
    from sdirt_tpu_torch.utils.config import load_config

    cfg = load_config(os.path.join(ROOT, "configs", "dfdp_synthetic_smoke.yml"))
    cfg.update(synthetic_len=4, synthetic_val_len=1, results_dir=str(tmp_path),
               train_mode="dfdp", data_parallel=True,
               ckpt_out=str(tmp_path / "export"), train_state_dir=str(tmp_path / "state"))
    outs = launch(dfdp_net.train_rank, 2, args=(cfg,), timeout=JOIN_S)
    assert outs[0]["losses"] == outs[1]["losses"] and len(outs[0]["losses"]) == 2
    assert all(np.isfinite(outs[0]["losses"]))
    assert len(outs[0]["val"]) == 2 and outs[1]["val"] == []
    assert (tmp_path / "export.npz").exists()
    assert sorted(os.listdir(tmp_path / "state")) == ["step_1.pt", "train_meta.json"]
