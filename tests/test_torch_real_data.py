"""The PyTorch port's real-data path against the JAX package on the CPU: the
NYU, FlyingThings3D, Middlebury and Middlebury focal-stack loaders on trees
written as tests/test_datasets.py writes them (and on the committed NYU
tree of scripts/make_dataset_reference.py), their training-mode draws,
``data_tools``, and ``get_dataset`` on the three published configurations.

Tolerances: the loaders' items bit-equal, or within 1e-6 where the
bicubic resize's summation order differs from PIL's; the draws of a
training item are the same when the port's item generator is seeded as the
JAX loader's global one.
"""

import os
import random

import cv2 as cv
import numpy as np
import pytest

from sdirt_tpu.dfdp import data_tools as JT
from sdirt_tpu.dfdp import datasets as JD
from sdirt_tpu.dfdp import factory as JF
from sdirt_tpu.io.exr import write_exr
from sdirt_tpu_torch.dfdp import data_tools as TT
from sdirt_tpu_torch.dfdp import datasets as TD
from sdirt_tpu_torch.dfdp import factory as TF
from sdirt_tpu_torch.utils.config import load_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NYU_REF = os.path.join(ROOT, "sdirt_tpu_torch", "reference", "datasets", "nyu2_train")
PUBLISHED = ("dfdp_by_sdirt_rf50mm.yml", "dfdp_by_sdirt_rf35mm.yml",
             "dfdp_by_sdirt_rf50mm_w256.yml")
RES = (48, 64)
RESIZE_TOL = 1e-6


def _write_rgb(path, h=96, w=128, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, (h, w, 3)).astype(np.uint8)
    assert cv.imwrite(path, img)
    return img


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """NYU (jpg + 8-bit png depth * 25.5), FlyingThings3D (AiF.png,
    disp.exr = depth * 20, three focal-stack frames) and Middlebury
    (im0.png, 16-bit depth.png in mm; AiF.png, disp.exr = depth * 10 with
    negatives) trees."""
    root = tmp_path_factory.mktemp("trees")
    rng = np.random.default_rng(7)
    for s in range(2):
        scene = root / "nyu" / f"scene_{s}"
        os.makedirs(scene)
        for i in range(3):
            _write_rgb(str(scene / f"{i:04d}.jpg"), 100, 132, seed=10 * s + i)
            d = rng.uniform(0.1, 9.5, (100, 132)) * 25.5
            d[:3, :5] = 0
            assert cv.imwrite(str(scene / f"{i:04d}.png"), d.astype(np.uint8))
    for s in ("s0", "s1", "s2"):
        d = root / "fly" / s
        os.makedirs(d)
        _write_rgb(str(d / "AiF.png"), 90, 160, seed=len(s) + ord(s[1]))
        write_exr(str(d / "disp.exr"),
                  rng.uniform(0.3, 9.0, (90, 160)).astype(np.float32) * 20.0)
        for dist in (10.0, 20.0, 40.0):
            _write_rgb(str(d / f"{dist:g}.png"), 90, 160, seed=int(dist) + ord(s[1]))
    for s in ("adirondack", "jadeplant"):
        scene = root / "mb" / s
        os.makedirs(scene)
        _write_rgb(str(scene / "im0.png"), 75, 101, seed=ord(s[0]))
        _write_rgb(str(scene / "AiF.png"), 75, 101, seed=ord(s[1]))
        dpng = rng.uniform(500, 9000, (75, 101)).astype(np.uint16)
        assert cv.imwrite(str(scene / "depth.png"), dpng)
        disp = rng.uniform(-5, 60, (75, 101)).astype(np.float32)
        write_exr(str(scene / "disp.exr"), disp, compression="zips")
    return {k: str(root / k) for k in ("nyu", "fly", "mb")}


def _assert_items(got, ref, tol=RESIZE_TOL):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        g, r = np.asarray(g), np.asarray(r)
        assert g.shape == r.shape and g.dtype == r.dtype
        np.testing.assert_allclose(g, r, rtol=0, atol=tol)


def _jax_item(ds, idx, seed):
    """The JAX loader's item with its global generators seeded."""
    np.random.seed(seed)
    random.seed(np.random.RandomState(seed).randint(0, 2**31 - 1))
    return ds[idx]


@pytest.mark.parametrize("res", [RES, (128, 192)])
def test_nyu_eval_items_match_jax(trees, res):
    ref = JD.NYUData(trees["nyu"], resize=res, train=False)
    got = TD.NYUData(trees["nyu"], resize=res, train=False)
    assert len(got) == len(ref) == 50 and got.imgs == ref.imgs
    for i in (0, 3, 5, 7):        # 7 wraps past the six frames
        _assert_items(got[i], ref[i])


def test_nyu_train_items_match_jax(trees):
    ref = JD.NYUData(trees["nyu"], resize=RES, train=True)
    got = TD.NYUData(trees["nyu"], resize=RES, train=True)
    assert len(got) == len(ref) == 2000
    for seed in range(8):
        _assert_items(got.__getitem__(seed, np.random.RandomState(seed)),
                      _jax_item(ref, seed, seed))


def test_committed_nyu_tree_matches_jax():
    """The committed tree (baseline JPEG q95 4:2:0 + 8-bit depth) at the
    published width, through both loaders."""
    ref = JD.NYUData(NYU_REF, resize=(512, 768), train=False)
    got = TD.NYUData(NYU_REF, resize=(512, 768), train=False)
    assert len(got.imgs) == 8 and sorted(got.imgs) == sorted(ref.imgs)
    for i in (0, 5):
        _assert_items(got[i], ref[i])
    seed = 3
    _assert_items(TD.NYUData(NYU_REF, resize=(512, 768)).__getitem__(
        1, np.random.RandomState(seed)),
        _jax_item(JD.NYUData(NYU_REF, resize=(512, 768)), 1, seed))


@pytest.mark.parametrize("train", [False, True])
def test_flyingthings_items_match_jax(trees, train):
    ref = JD.FlyingThings3D(trees["fly"], resize=RES, train=train)
    got = TD.FlyingThings3D(trees["fly"], resize=RES, train=train)
    assert got.scenes == ref.scenes and len(got) == len(ref) == 3
    for i in range(3):
        _assert_items(got.__getitem__(i, np.random.RandomState(40 + i)),
                      _jax_item(ref, i, 40 + i))


def test_flyingthings_focal_stack_matches_jax(trees):
    ref = JD.FlyingThings3D(trees["fly"], resize=RES, train=True, fs_num=2)
    got = TD.FlyingThings3D(trees["fly"], resize=RES, train=True, fs_num=2)
    for i, seed in ((0, 1), (1, 2), (2, 3)):
        g = got.__getitem__(i, np.random.RandomState(seed))
        r = _jax_item(ref, i, seed)
        assert g[0].shape == (2, 3, *RES)
        _assert_items(g, r)


@pytest.mark.parametrize("cls", ["Middlebury", "MiddleburyFS"])
def test_middlebury_items_match_jax(trees, cls):
    ref = getattr(JD, cls)(trees["mb"], resize=RES)
    got = getattr(TD, cls)(trees["mb"], resize=RES)
    assert got.scenes == ref.scenes and len(got) == 2
    for i in range(2):
        _assert_items(got[i], ref[i])
    if cls == "MiddleburyFS":
        assert (got[0][1] == 0).any()       # negative disparities zeroed


def test_item_draws_are_the_loaders(trees):
    """A loader seeds each item from its epoch seed and the index: the same
    seed gives the same batches, and the two FlyingThings3D passes of the
    first-half mix draw differently."""
    fly = TD.FlyingThings3D(trees["fly"], resize=RES)
    mix = TD.ConcatDataset(fly, fly)
    a = [b[0] for b in TD.DataLoader(mix, batch_size=2, num_workers=2, seed=5)]
    b = [b[0] for b in TD.DataLoader(mix, batch_size=2, num_workers=3, seed=5)]
    c = [b[0] for b in TD.DataLoader(mix, batch_size=2, num_workers=2, seed=6)]
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not all(np.array_equal(x, y) for x, y in zip(a, c))
    first, second = np.concatenate(a)[:3], np.concatenate(a)[3:]
    assert not all(np.array_equal(x, y) for x, y in zip(first, second))
    np.testing.assert_array_equal(
        mix.__getitem__(4, TD.item_rng(5, 4))[0], fly.__getitem__(1, TD.item_rng(5, 4))[0])


def test_data_tools_match_jax(tmp_path):
    h, w = 8, 10
    disp = np.linspace(10, 50, h * w).reshape(h, w).astype(np.float32)
    for name, sub in (("a", "ref"), ("b", "port")):
        d = tmp_path / sub
        os.makedirs(d)
        with open(d / "disp0.pfm", "wb") as f:
            f.write(b"Pf\n" + f"{w} {h}\n".encode() + b"-1.0\n")
            f.write(np.flipud(disp).astype("<f4").tobytes())
        (d / "calib.txt").write_text(
            "cam0=[3979.911 0 1244.772]\ncam1=x\ndoffs=124\nbaseline=193.001\n")
    for fn in ("read_pfm", "read_middlebury_calib"):
        arg = "disp0.pfm" if fn == "read_pfm" else "calib.txt"
        r = getattr(JT, fn)(str(tmp_path / "ref" / arg))
        g = getattr(TT, fn)(str(tmp_path / "port" / arg))
        assert len(g) == len(r) and all(np.array_equal(x, y) for x, y in zip(g, r))
    np.testing.assert_array_equal(TT.process_pfm(str(tmp_path / "port")),
                                  JT.process_pfm(str(tmp_path / "ref")))
    ref = cv.imread(str(tmp_path / "ref" / "depth.png"), -1)
    got = cv.imread(str(tmp_path / "port" / "depth.png"), -1)
    assert got.dtype == np.uint16 and np.array_equal(got, ref)
    np.testing.assert_array_equal(TD.read_png(str(tmp_path / "port" / "depth.png")), ref)


def _published(name, trees, **roots):
    args = load_config(os.path.join(ROOT, "configs", name))
    args.update(res=RES, NYUdata_train=trees["nyu"], FlyingThings3D_train=trees["fly"],
                FlyingThings3D_test=trees["fly"], **roots)
    return args


@pytest.mark.parametrize("name", PUBLISHED)
def test_get_dataset_published_configs(trees, name):
    """Lengths, the mix's order and the sets' files as the JAX factory gives
    them, and a FlyingThings3D item of the first-half mix."""
    args = _published(name, trees)
    ref = JF.get_dataset(args)
    got = TF.get_dataset(args)
    assert [len(d) for d in got] == [len(d) for d in ref] == [2000 + 6, 4000, 3]
    for g, r in zip(got[:2], ref[:2]):
        assert [type(d).__name__ for d in g.datasets] == [
            type(d).__name__ for d in r.datasets]
    assert [type(d).__name__ for d in got[0].datasets] == [
        "NYUData", "FlyingThings3D", "FlyingThings3D"]
    assert type(got[2]).__name__ == "FlyingThings3D" and not got[2].train
    assert got[0].datasets[0].imgs == ref[0].datasets[0].imgs
    _assert_items(got[0].__getitem__(2003, np.random.RandomState(9)),
                  _jax_item(ref[0], 2003, 9))
    _assert_items(got[2][1], ref[2][1])


@pytest.mark.parametrize("test_name,key,n", [
    ("Middlebury2014", "Middlebury2014_val", 2), ("Middlebury2021", "Middlebury2021_val", 2),
    ("Middlebury_FS", "Middlebury_FS", 2), ("NYUdata", "NYUdata_test", 50),
    ("Synthetic", None, 4)])
def test_get_dataset_test_sets(trees, test_name, key, n):
    args = _published("dfdp_by_sdirt_rf50mm.yml", trees)
    args["test"] = {**args["test"], "dataset": test_name}
    if key:
        args[key] = trees["nyu"] if test_name == "NYUdata" else trees["mb"]
    ref, got = JF.get_dataset(args)[2], TF.get_dataset(args)[2]
    assert type(got).__name__ == type(ref).__name__ and len(got) == len(ref) == n
    _assert_items(got[1], ref[1])


def test_get_dataset_flyingthings_train(trees):
    args = _published("dfdp_by_sdirt_rf50mm.yml", trees)
    args["train"] = {**args["train"], "dataset": "FlyingThings3D"}
    ref, got = JF.get_dataset(args), TF.get_dataset(args)
    assert [len(d) for d in got] == [len(d) for d in ref] == [9, 6, 3]


def test_get_dataset_refusals(trees, tmp_path):
    args = _published("dfdp_by_sdirt_rf50mm.yml", trees)
    for side in ("train", "test"):
        bad = dict(args, **{side: {**args[side], "dataset": "KITTI"}})
        for factory in (JF, TF):
            with pytest.raises(NotImplementedError, match="KITTI"):
                factory.get_dataset(bad)
    empty = tmp_path / "empty"
    os.makedirs(empty)
    for key in ("NYUdata_train", "FlyingThings3D_train", "FlyingThings3D_test"):
        with pytest.raises(FileNotFoundError, match=key):
            TF.get_dataset(dict(args, **{key: str(empty)}))
