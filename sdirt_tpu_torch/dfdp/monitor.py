"""Depth-metric accumulation and the per-split checkpoint policy (PyTorch
port's counterpart of sdirt_tpu/dfdp/monitor.py). In ``deblur`` mode the
refined depth's acc1..3 and, where an all-in-focus ground truth exists, the
deblurred image's PSNR and SSIM are accumulated too.

``save_images`` (the visualisation dump) is not ported yet (ROADMAP.md §1
item 2).
"""

from __future__ import annotations

import logging

import numpy as np

from . import metrics as M

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
        None (the real capture sets have no all-in-focus truth)."""
        self.gt_depth = np.squeeze(np.asarray(outputs["gt_depth"]))
        self.test_mask = self.gt_depth > 1e-9
        self.pred_depth_est = self._depth(outputs["pred_depth_est"])
        if self.train_mode == "deblur":
            self.pred_depth_fix = self._depth(outputs["pred_depth_fix"])
            self.pred_aif = np.asarray(outputs["pred_aif"])
            gt_aif = outputs.get("gt_aif")
            self.gt_aif = None if gt_aif is None else np.asarray(gt_aif)

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

    def save_images(self, result_img_dir, scene, idx):
        raise NotImplementedError(
            "ResultsMonitor.save_images is not ported yet (ROADMAP.md §1 "
            "item 2)")

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
