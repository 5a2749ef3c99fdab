"""The port's ``ResultsMonitor.save_images`` against the JAX monitor's:
the JET table bit-equal to ``cv2.applyColorMap`` for all 256 values, and the
files (five RGB views, two JET depth maps) pixel-equal to those the JAX
monitor writes with OpenCV, in dfdp and deblur mode; and ``--save-images``
through the port's evaluation stage.
"""

import os

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from sdirt_tpu.dfdp.monitor import ResultsMonitor as JaxMonitor  # noqa: E402
from sdirt_tpu_torch import dfdp_net  # noqa: E402
from sdirt_tpu_torch.dfdp.cvops import apply_colormap_jet  # noqa: E402
from sdirt_tpu_torch.dfdp.datasets import Subset, read_png  # noqa: E402
from sdirt_tpu_torch.dfdp.monitor import ResultsMonitor  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("rgb_gt_aif", "rgb_gt_l", "rgb_gt_r", "rgb_rt_l", "rgb_rt_r",
         "depth_gt", "depth_est")


def test_jet_table_bit_equal():
    u8 = np.arange(256, dtype=np.uint8).reshape(16, 16)
    np.testing.assert_array_equal(apply_colormap_jet(u8),
                                  cv2.applyColorMap(u8, cv2.COLORMAP_JET))
    with pytest.raises(ValueError):
        apply_colormap_jet(u8.astype(np.float32))


def _outputs(seed, h=24, w=36, deblur=False):
    rng = np.random.default_rng(seed)
    views = {k: rng.uniform(-0.1, 1.1, (1, 3, h, w)).astype(np.float32)
             for k in ("gt_aif", "gt_l", "gt_r", "rt_render_l", "rt_render_r")}
    gt = rng.uniform(0.3, 9.0, (1, 1, h, w)).astype(np.float32)
    gt[0, 0, :2] = 0
    out = {**views, "gt_depth": gt,
           "pred_depth_est": rng.uniform(-0.5, 13.0, (1, 1, h, w)).astype(np.float32)}
    if deblur:
        out.update(pred_depth_fix=out["pred_depth_est"] * 0.9,
                   pred_aif=views["gt_aif"] * 0.95)
    return out


@pytest.mark.parametrize("mode", ["dfdp", "deblur"])
@pytest.mark.parametrize("seed", [0, 1])
def test_save_images_pixel_equal(tmp_path, mode, seed):
    outputs = _outputs(seed, deblur=mode == "deblur")
    ref, got = JaxMonitor(mode), ResultsMonitor(mode)
    ref.set_outputs(outputs)
    got.set_outputs(outputs)
    ref.save_images(str(tmp_path / "jax"), "box", 3)
    written = got.save_images(str(tmp_path / "port"), "box", 3)
    assert sorted(os.path.basename(p) for p in written) == sorted(
        f"box_3_{n}.png" for n in NAMES)
    for n in NAMES:
        want = cv2.imread(str(tmp_path / "jax" / f"box_3_{n}.png"), cv2.IMREAD_UNCHANGED)
        have = cv2.imread(str(tmp_path / "port" / f"box_3_{n}.png"), cv2.IMREAD_UNCHANGED)
        assert have.shape == want.shape == (24, 36, 3)
        np.testing.assert_array_equal(have, want)


def test_save_images_skips_missing_views(tmp_path):
    outputs = _outputs(2)
    for k in ("gt_aif", "rt_render_l", "rt_render_r"):
        outputs[k] = None
    got = ResultsMonitor("dfdp")
    got.set_outputs(outputs)
    names = sorted(os.path.basename(p) for p in got.save_images(str(tmp_path), "s", 0))
    assert names == ["s_0_depth_est.png", "s_0_depth_gt.png", "s_0_rgb_gt_l.png",
                     "s_0_rgb_gt_r.png"]


def test_stage_sample_save_images(tmp_path, monkeypatch):
    """--save-images through dfdp_net.main on the smoke config: one frame of
    each real set, its views and JET depth maps under <out>/tests/ named by
    the JAX app's scene tags."""
    monkeypatch.chdir(ROOT)
    flat, depth_sets = dfdp_net.get_flat_sample_set, dfdp_net.get_depth_sample_set
    monkeypatch.setattr(dfdp_net, "get_flat_sample_set", lambda a: Subset(flat(a), [0]))
    monkeypatch.setattr(dfdp_net, "get_depth_sample_set",
                        lambda a: tuple(Subset(d, [0]) for d in depth_sets(a)))
    out = tmp_path / "out"
    dfdp_net.main(["--stage", "sample", "--config", "configs/dfdp_synthetic_smoke.yml",
                   "--device", "cpu", "--out", str(out), "--save-images"])
    files = sorted(os.listdir(out / "tests"))
    for tag in ("boxSample", "f2dSample", "casualSample"):
        assert f"{tag}-UNTRAINED(no ckpt)_0_depth_est.png" in files or \
            f"{tag}_0_depth_est.png" in files, files
    est = [f for f in files if f.endswith("_depth_est.png")][0]
    assert read_png(str(out / "tests" / est)).shape == (128, 192, 3)
