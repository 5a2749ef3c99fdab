"""Depth-metric accumulation and the per-split checkpoint policy (PyTorch
port's counterpart of sdirt_tpu/dfdp/monitor.py, ``dfdp`` mode).

``save_images`` (the visualisation dump) is not ported yet (ROADMAP.md §1).
"""

from __future__ import annotations

import logging

import numpy as np

from . import metrics as M

DEPTH_METRICS = ("abs_rel", "sq_rel", "mse", "mae", "rmse", "rmse_log",
                 "acc1", "acc2", "acc3")


def select_focus_dist(depth, num, foc_d=1.0):
    """Focus distance per sample: the reference pins it to 1 m for every
    sample (its linear/importance samplers are dead code)."""
    return np.full((depth.shape[0], num), foc_d, np.float32)


class ResultsMonitor:
    """Accumulates the depth metrics of a split, one frame at a time, and
    keeps the last and best-acc1 nets of a split."""

    def __init__(self, train_mode: str = "dfdp"):
        if train_mode != "dfdp":
            raise NotImplementedError(
                f"train_mode {train_mode!r} is not ported yet (ROADMAP.md §1 "
                "item 5)")
        self.sums = dict.fromkeys(DEPTH_METRICS, 0.0)
        self.count = 0

    def set_outputs(self, outputs: dict):
        """outputs: "gt_depth" and "pred_depth_est" in metres, any shape
        that squeezes to [H, W]."""
        self.gt_depth = np.squeeze(np.asarray(outputs["gt_depth"]))
        self.test_mask = self.gt_depth > 1e-9
        pred = np.array(np.squeeze(np.asarray(outputs["pred_depth_est"])))
        pred[pred < 0] = 0
        self.pred_depth_est = pred

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
        self.count += 1

    def save_images(self, result_img_dir, scene, idx):
        raise NotImplementedError(
            "ResultsMonitor.save_images is not ported yet (ROADMAP.md §1)")

    def logging(self, epoch, num_scene):
        s = self.sums
        logging.info(f"Avg_mse/mae({epoch}): {s['mse'] / num_scene}, "
                     f"{s['mae'] / num_scene}")
        logging.info(f"Avg_acc_est({epoch}): {s['acc1'] / num_scene}, "
                     f"{s['acc2'] / num_scene}, {s['acc3'] / num_scene}")

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
