"""Depth-metric accumulation and the per-split checkpoint policy (PyTorch
port's counterpart of sdirt_tpu/dfdp/monitor.py). In ``deblur`` mode the
refined depth's acc1..3 and, where an all-in-focus ground truth exists, the
deblurred image's PSNR and SSIM are accumulated too. ``save_images`` writes
a frame's views and depth maps as PNG files, as the JAX monitor writes them
with OpenCV.
"""

from __future__ import annotations

import logging
import os

import numpy as np

from ..utils.png import write_png
from . import metrics as M
from .cvops import apply_colormap_jet

# set_outputs' keys of the RGB views save_images writes, and their names
IMAGE_VIEWS = (("gt_aif", "rgb_gt_aif"), ("gt_l", "rgb_gt_l"), ("gt_r", "rgb_gt_r"),
               ("rt_render_l", "rgb_rt_l"), ("rt_render_r", "rgb_rt_r"))

DEPTH_METRICS = ("abs_rel", "sq_rel", "mse", "mae", "rmse", "rmse_log",
                 "acc1", "acc2", "acc3")
# deblur mode: acc1..3 of the refined depth, and the all-in-focus image's
# PSNR / SSIM (summed only over frames that carry an all-in-focus truth)
DEBLUR_METRICS = ("acc1_fix", "acc2_fix", "acc3_fix", "psnr_deblur",
                  "ssim_deblur")


def select_focus_dist(depth, num, foc_d=1.0):
    """Focus distance per sample: the reference pins it to 1 m for every
    sample (its linear/importance samplers are dead code)."""
    return np.full((depth.shape[0], num), foc_d, np.float32)


class ResultsMonitor:
    """Accumulates the depth metrics of a split, one frame at a time, and
    keeps the last and best-acc1 nets of a split."""

    def __init__(self, train_mode: str = "dfdp"):
        if train_mode not in ("dfdp", "deblur"):
            raise ValueError(f"train_mode {train_mode!r}")
        self.train_mode = train_mode
        keys = DEPTH_METRICS + (DEBLUR_METRICS if train_mode == "deblur" else ())
        self.sums = dict.fromkeys(keys, 0.0)
        self.count = 0

    @staticmethod
    def _depth(a):
        pred = np.array(np.squeeze(np.asarray(a)))
        pred[pred < 0] = 0
        return pred

    def set_outputs(self, outputs: dict):
        """outputs: "gt_depth" and "pred_depth_est" in metres, any shape
        that squeezes to [H, W]; in deblur mode also "pred_depth_fix"
        (metres) and "pred_aif" [1, 3, H, W], and "gt_aif" [1, 3, H, W] or
        None (the real capture sets have no all-in-focus truth). The RGB
        views that save_images writes ("gt_aif", "gt_l", "gt_r",
        "rt_render_l", "rt_render_r", [1, 3, H, W] in [0, 1]) are kept when
        given."""
        self.gt_depth = np.squeeze(np.asarray(outputs["gt_depth"]))
        self.test_mask = self.gt_depth > 1e-9
        self.pred_depth_est = self._depth(outputs["pred_depth_est"])
        self.views = {k: None if outputs.get(k) is None else np.asarray(outputs[k])
                      for k, _ in IMAGE_VIEWS}
        self.gt_aif = self.views["gt_aif"]
        if self.train_mode == "deblur":
            self.pred_depth_fix = self._depth(outputs["pred_depth_fix"])
            self.pred_aif = np.asarray(outputs["pred_aif"])

    def compute_metrics(self):
        est, gt, m = self.pred_depth_est, self.gt_depth, self.test_mask
        s = self.sums
        s["abs_rel"] += M.mask_abs_rel(est, gt, m)
        s["sq_rel"] += M.mask_sq_rel(est, gt, m)
        s["mse"] += M.mask_mse(est, gt, m)
        s["mae"] += M.mask_mae(est, gt, m)
        s["rmse"] += M.mask_rmse(est, gt, m)
        s["rmse_log"] += M.mask_rmse_log(est, gt, m)
        for k in (1, 2, 3):
            s[f"acc{k}"] += M.mask_accuracy_k(est, gt, k, m)
        if self.train_mode == "deblur":
            for k in (1, 2, 3):
                s[f"acc{k}_fix"] += M.mask_accuracy_k(self.pred_depth_fix, gt,
                                                      k, m)
            if self.gt_aif is not None:
                s["psnr_deblur"] += M.mask_psnr(self.pred_aif, self.gt_aif)
                s["ssim_deblur"] += M.mask_ssim(self.pred_aif, self.gt_aif)
        self.count += 1

    def save_images(self, result_img_dir, scene, idx) -> list:
        """Write the frame's RGB views (``<scene>_<idx>_rgb_*.png``, those
        given to set_outputs) and its true and estimated depth as JET maps
        (``_depth_gt.png``, ``_depth_est.png``, both scaled by 1.25 x the
        true maximum) under result_img_dir. Returns the paths written."""
        os.makedirs(result_img_dir, exist_ok=True)
        stem = f"{result_img_dir}/{scene}_{idx}"
        written = []
        for key, name in IMAGE_VIEWS:
            a = self.views[key]
            if a is None:
                continue
            if a.ndim == 4:
                a = a[0]
            img = np.clip(a.transpose(1, 2, 0) * 255 + 0.5, 0, 255).astype(np.uint8)
            written.append(write_png(f"{stem}_{name}.png", img))
        depth_max = self.gt_depth.max() * 1.25
        for name, depth in (("depth_gt", self.gt_depth), ("depth_est", self.pred_depth_est)):
            u8 = (depth / depth_max * 255.0).astype(np.uint8)
            written.append(write_png(f"{stem}_{name}.png", apply_colormap_jet(u8),
                                     bgr=True))
        return written

    def logging(self, epoch, num_scene):
        s = self.sums
        logging.info(f"Avg_mse/mae({epoch}): {s['mse'] / num_scene}, "
                     f"{s['mae'] / num_scene}")
        logging.info(f"Avg_acc_est({epoch}): {s['acc1'] / num_scene}, "
                     f"{s['acc2'] / num_scene}, {s['acc3'] / num_scene}")
        if self.train_mode == "deblur":
            logging.info(f"Avg_acc_fix({epoch}): {s['acc1_fix'] / num_scene}, "
                         f"{s['acc2_fix'] / num_scene}, "
                         f"{s['acc3_fix'] / num_scene}")
            logging.info(f"Avg_ps_deblur({epoch}): "
                         f"{s['psnr_deblur'] / num_scene} "
                         f"{s['ssim_deblur'] / num_scene}")

    def metric_dict(self, num_scene: int | None = None) -> dict:
        n = self.count if num_scene is None else num_scene
        return {k: float(v) / n for k, v in self.sums.items()}

    def save_pth(self, args: dict, scene, num_scene, net):
        """Write the net to ``<results_dir>/depth_net_last.npz`` and, when
        this split's acc1 beats ``args["acc1_<scene>_max"]``, to
        ``<results_dir>/<scene>_net_best_acc1.npz`` (parameters and BN
        running statistics)."""
        from ..utils.checkpoint import save_inference_ckpt

        save_inference_ckpt(f"{args['results_dir']}/depth_net_last", net)
        key = f"acc1_{scene}_max"
        args.setdefault(key, 0.0)
        acc1 = self.sums["acc1"] / num_scene
        if acc1 > args[key]:
            args[key] = acc1
            save_inference_ckpt(f"{args['results_dir']}/{scene}_net_best_acc1",
                                net)
