"""The PyTorch port's ``--stage train`` and ``--stage full`` as a whole, on
the CPU at the smoke config's size, and the checkpoint pieces they stand
on: crash-resume, the best-acc1 watermark that a restart cannot clobber,
inference exports that the serve path loads, and the resumable train state.
The port's counterpart of tests/test_framework.py's resume tests.
"""

import json
import logging
import os

import numpy as np
import pytest
import torch

from sdirt_tpu_torch import dfdp_net
from sdirt_tpu_torch.dfdp import factory
from sdirt_tpu_torch.dfdp.basenet import build_basenet
from sdirt_tpu_torch.dfdp.datasets import Subset
from sdirt_tpu_torch.dfdp.train import create_dfdp_state, dfdp_train_step
from sdirt_tpu_torch.utils import checkpoint as C
from sdirt_tpu_torch.utils.config import load_config
from sdirt_tpu_torch.utils.logging import host_rss_gb, set_seed
from sdirt_tpu_torch.utils.stall import StallWatchdog
from sdirt_tpu_torch.utils.weights import load_npz, torch_to_flax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "configs", "dfdp_synthetic_smoke.yml")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test files at once on the machine's cores;
    this file's torch work keeps to two threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


@pytest.fixture
def records():
    handler = _Records()
    root = logging.getLogger()
    old = root.level
    root.addHandler(handler)
    root.setLevel(logging.INFO)
    yield handler.messages
    root.removeHandler(handler)
    root.setLevel(old)


def _smoke_args(tmp_path, **kw):
    args = load_config(SMOKE)
    args.update(res=(128, 192), bs=2, epochs=1, synthetic_len=4,
                synthetic_val_len=1, train_mode="dfdp",
                results_dir=str(tmp_path / "results"))
    args.update(kw)
    os.makedirs(args["results_dir"], exist_ok=True)
    return args


def test_train_stage_resumes(tmp_path, monkeypatch, records):
    """One epoch of --stage train, then a rerun: the rerun restores the
    saved epoch, trains no step, and keeps the watermark."""
    monkeypatch.chdir(ROOT)
    # the per-epoch real-box evaluation plays no part in resuming
    monkeypatch.setattr(dfdp_net, "test_depth", lambda *a, **k: {"acc1": 0.0})
    args = _smoke_args(tmp_path, ckpt_out=str(tmp_path / "best"),
                       train_state_dir=str(tmp_path / "state"))
    first = dfdp_net.train(dict(args), device="cpu")
    assert first["epochs_trained"] == 1 and len(first["losses"]) == 2
    assert np.isfinite(first["losses"]).all()
    assert [set(s) for s in first["steps"]] == [
        {"data_wait_s", "render_ms", "train_step_ms"}] * 2
    meta = json.loads((tmp_path / "state" / "train_meta.json").read_text())
    assert meta["best_acc1"] >= 0.0
    assert (tmp_path / "best.npz").exists()
    assert C.read_ckpt_watermark(str(tmp_path / "best")) == meta["best_acc1"]
    banked = (tmp_path / "best.npz").read_bytes()

    records.clear()
    second = dfdp_net.train(dict(args), device="cpu")
    resumed = [m for m in records if m.startswith("resumed train state")]
    assert resumed and "epoch 1" in resumed[0], records[:5]
    assert not any(m.startswith("Epoch ") for m in records)
    assert second["epochs_trained"] == 0 and second["losses"] == []
    assert json.loads((tmp_path / "state" / "train_meta.json").read_text()) == meta
    assert (tmp_path / "best.npz").read_bytes() == banked

    # the export is what --stage sample's depth part loads
    path = factory.ported_weights(str(tmp_path / "best"))
    assert path == str(tmp_path / "best.npz")
    exported = load_npz(path)
    loaded = torch_to_flax(build_basenet(path, device="cpu").state_dict())
    assert set(loaded) == set(exported)
    assert all(np.array_equal(loaded[k], v) for k, v in exported.items())


def test_restart_cannot_clobber_banked_ckpt(tmp_path, monkeypatch, records):
    """A restart with no resumable state against a banked export that scored
    0.99 seeds its watermark from the export's sidecar and never overwrites
    the export with its own epoch-0 net."""
    monkeypatch.chdir(ROOT)
    monkeypatch.setattr(dfdp_net, "test_depth", lambda *a, **k: {"acc1": 0.0})
    args = _smoke_args(tmp_path, epochs=0, synthetic_len=2,
                       ckpt_out=str(tmp_path / "best"))
    (tmp_path / "best.npz").write_text("banked peak params")
    C.write_ckpt_watermark(str(tmp_path / "best"), 0.99)
    dfdp_net.train(dict(args), device="cpu")
    assert any(m.startswith("seeded best-acc1 watermark 0.9900") for m in records)
    assert (tmp_path / "best.npz").read_text() == "banked peak params"
    assert not any(m.startswith("ckpt_out: saved") for m in records)


def test_full_stage_runs_on_cpu(tmp_path, monkeypatch):
    """--stage full on the smoke config (real sets at 128x192, no trained
    net named: the depth part runs on an untrained one), on the first scene
    of each set."""
    monkeypatch.chdir(ROOT)
    flat_sets, depth_sets = dfdp_net.get_flat_test_set, dfdp_net.get_depth_test_set
    monkeypatch.setattr(dfdp_net, "get_flat_test_set",
                        lambda args: Subset(flat_sets(args), [0]))
    monkeypatch.setattr(dfdp_net, "get_depth_test_set",
                        lambda args: tuple(Subset(d, [0]) for d in depth_sets(args)))
    out = tmp_path / "full"
    result = dfdp_net.main(["--stage", "full", "--config", SMOKE,
                            "--device", "cpu", "--out", str(out)])
    assert len(result["flat"]) == 1
    assert set(result["depth"]) == {"box", "f2d", "casual"}
    for rec in result["flat"]:
        assert all(np.isfinite(rec[k]) for k in dfdp_net.FLAT_COLUMNS)
    assert (out / "DPimages" / "res.csv").exists() and (out / "depth.csv").exists()


def test_data_parallel_on_one_device_trains_single_chip(tmp_path, records):
    """``--data-parallel`` with one device (the CPU counts as one) logs the
    JAX app's line and trains on it: one epoch of the smoke config cut to
    2 steps and one validation item."""
    cfg = load_config(SMOKE)
    cfg.update(synthetic_len=4, synthetic_val_len=1, results_dir=str(tmp_path),
               train_mode="dfdp", data_parallel=True)
    out = dfdp_net.train(cfg, device="cpu")
    assert ("data_parallel requested but only one usable device; running "
            "single-chip") in records
    assert out["epochs_trained"] == 1 and len(out["losses"]) == 2
    assert all(np.isfinite(out["losses"]))


@pytest.mark.parametrize("bs,cards,want", [(4, 1, 1), (4, 2, 2), (4, 3, 2), (4, 8, 4),
                                           (6, 4, 3), (5, 4, 1)])
def test_data_parallel_ranks(bs, cards, want):
    """n_data: the largest divisor of bs not above the card count."""
    assert dfdp_net.data_parallel_ranks(bs, cards) == want


def _flyingthings_tree(root, n, seed):
    """n FlyingThings3D scenes at 96x160: AiF.png and disp.exr (depth x 20)."""
    from sdirt_tpu_torch.io.exr import write_exr
    from sdirt_tpu_torch.utils.png import write_png

    rng = np.random.default_rng(seed)
    for s in range(n):
        scene = root / f"{s:04d}"
        os.makedirs(scene)
        write_png(str(scene / "AiF.png"), rng.integers(0, 256, (96, 160, 3), np.uint8))
        write_exr(str(scene / "disp.exr"),
                  rng.uniform(0.4, 8.0, (96, 160)).astype(np.float32) * 20.0)
    return str(root)


def test_published_config_trains_on_cpu(tmp_path, monkeypatch):
    """--stage train on configs/dfdp_by_sdirt_rf50mm.yml at 128x192, its
    dataset roots pointed at the committed NYU tree and written
    FlyingThings3D trees, cut to one step of the first-half mix (one NYU
    and one FlyingThings3D item), with --save-images."""
    import yaml

    monkeypatch.chdir(ROOT)
    monkeypatch.setattr(dfdp_net, "test_depth", lambda *a, **k: {"acc1": 0.0})
    get = dfdp_net.get_dataset
    monkeypatch.setattr(dfdp_net, "get_dataset", lambda args: (
        Subset(get(args)[0], (0, 2000)), Subset(get(args)[1], (0, 1)),
        get(args)[2]))
    with open(os.path.join(ROOT, "configs", "dfdp_by_sdirt_rf50mm.yml")) as f:
        cfg = yaml.safe_load(f)
    cfg.update(res=[128, 192], bs=2, epochs=1,
               NYUdata_train="sdirt_tpu_torch/reference/datasets/nyu2_train",
               FlyingThings3D_train=_flyingthings_tree(tmp_path / "fly_train", 2, 0),
               FlyingThings3D_test=_flyingthings_tree(tmp_path / "fly_val", 1, 1),
               real_box_test="./real_sample_set/box",
               real_flat_test="./real_sample_set/flat",
               real_casual_test="./real_sample_set/casual")
    path = tmp_path / "rf50mm.yml"
    path.write_text(yaml.safe_dump(cfg))
    out = tmp_path / "out"
    res = dfdp_net.main(["--stage", "train", "--config", str(path), "--device", "cpu",
                         "--out", str(out), "--save-images"])
    assert res["epochs_trained"] == 1 and len(res["losses"]) == 1
    assert np.isfinite(res["losses"]).all()
    assert len(res["val"]) == 2 and all(np.isfinite(v["acc1"]) for v in res["val"])
    saved = sorted(os.listdir(out / "results"))
    assert "fs_0_depth_est.png" in saved and "fs_0_rgb_rt_l.png" in saved, saved


@pytest.mark.parametrize("side", ["train", "test"])
def test_unknown_dataset_raises(side):
    args = load_config(os.path.join(ROOT, "configs", "dfdp_by_sdirt_rf50mm.yml"))
    args[side] = {**args[side], "dataset": "KITTI"}
    with pytest.raises(NotImplementedError, match="KITTI"):
        factory.get_dataset(args)


def test_synthetic_mix():
    args = load_config(SMOKE)
    fs_train, train, val = factory.get_dataset(args)
    assert len(fs_train) == len(train) == args["synthetic_len"]
    assert len(val) == args["synthetic_val_len"] and not val.train and val.seed == 999


def test_watermark_roundtrip(tmp_path):
    path = str(tmp_path / "best")
    assert C.read_ckpt_watermark(path) is None
    C.write_ckpt_watermark(path, 0.8986)
    assert C.read_ckpt_watermark(path) == pytest.approx(0.8986)
    assert C.read_ckpt_watermark(path + ".npz") == pytest.approx(0.8986)
    with open(path + ".npz.meta.json", "w") as f:
        f.write("{not json")
    assert C.read_ckpt_watermark(path) is None


def test_inference_ckpt_roundtrip(tmp_path):
    net = build_basenet(seed=1, device="cpu")
    written = C.save_inference_ckpt(str(tmp_path / "sub" / "net"), net)
    assert written == str(tmp_path / "sub" / "net.npz")
    other = C.restore_inference_ckpt(written, build_basenet(seed=2, device="cpu"))
    for k, v in net.state_dict().items():
        assert torch.equal(v, other.state_dict()[k]), k


def test_train_checkpointer_keeps_and_restores(tmp_path):
    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Linear(3, 2), torch.nn.BatchNorm1d(2))
    state = create_dfdp_state(net, 1e-2, 10)
    tc = C.TrainCheckpointer(str(tmp_path / "state"), max_to_keep=2)
    x = torch.randn(4, 3)
    for step in (1, 2, 3):
        state.opt.zero_grad()
        net(x).sum().backward()
        state.opt.step()
        state.sched.step()
        state.step = step
        tc.save(step, state)
    tc.wait()
    assert sorted(os.listdir(tmp_path / "state")) == ["step_2.pt", "step_3.pt"]
    fresh = create_dfdp_state(torch.nn.Sequential(torch.nn.Linear(3, 2),
                                                  torch.nn.BatchNorm1d(2)), 1e-2, 10)
    assert tc.restore_latest(fresh) == 3 and fresh.step == 3
    for k, v in net.state_dict().items():
        assert torch.equal(v, fresh.net.state_dict()[k])
    assert fresh.sched.state_dict() == state.sched.state_dict()
    assert fresh.opt.param_groups[0]["lr"] == state.opt.param_groups[0]["lr"]
    tc.close()
    assert C.TrainCheckpointer(str(tmp_path / "empty")).restore_latest(fresh) is None


def test_train_step_on_cpu_tensors_stays_finite():
    net = build_basenet(seed=0, device="cpu", train=True)
    state = create_dfdp_state(net, 1e-4, 2)
    gen = torch.Generator().manual_seed(0)
    stack = torch.rand(2, 6, 128, 192, generator=gen)
    depth = 0.5 + 3 * torch.rand(2, 1, 128, 192, generator=gen)
    losses = dfdp_train_step(state, stack, depth)
    assert torch.isfinite(losses["total"]) and state.step == 1
    assert state.net.training


def test_stall_watchdog_and_helpers():
    wd = StallWatchdog(timeout_s=60, poll_s=0.01)
    wd.beat()
    wd.close()
    wd._thread.join(timeout=1)
    assert not wd._thread.is_alive()
    assert host_rss_gb() > 0
    set_seed(5)
    a = (np.random.rand(), torch.rand(1))
    set_seed(5)
    assert a[0] == np.random.rand() and torch.equal(a[1], torch.rand(1))
