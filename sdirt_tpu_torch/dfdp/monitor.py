"""Depth-metric accumulation (PyTorch port's copy of the metric part of
sdirt_tpu/dfdp/monitor.py; image saving and checkpoint policy wait)."""

from __future__ import annotations

import numpy as np

from . import metrics as M

DEPTH_METRICS = ("abs_rel", "sq_rel", "mse", "mae", "rmse", "rmse_log",
                 "acc1", "acc2", "acc3")


def select_focus_dist(depth, num, foc_d=1.0):
    """Focus distance per sample: the reference pins it to 1 m for every
    sample (its linear/importance samplers are dead code)."""
    return np.full((depth.shape[0], num), foc_d, np.float32)


class ResultsMonitor:
    """Accumulates the depth metrics of a split, one frame at a time."""

    def __init__(self):
        self.sums = dict.fromkeys(DEPTH_METRICS, 0.0)
        self.count = 0

    def add(self, pred_depth, gt_depth):
        """pred_depth, gt_depth: metres, any shape that squeezes to [H, W]."""
        gt = np.squeeze(np.asarray(gt_depth))
        est = np.array(np.squeeze(np.asarray(pred_depth)))
        est[est < 0] = 0
        m = gt > 1e-9
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

    def metric_dict(self) -> dict:
        return {k: float(v) / self.count for k, v in self.sums.items()}
