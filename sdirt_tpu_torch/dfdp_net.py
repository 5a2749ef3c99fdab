"""Serve-path entry point of the PyTorch port (counterpart of
``apps/dfdp_net.py --stage sample``).

  python -m sdirt_tpu_torch.dfdp_net --stage sample \\
      --config configs/dfdp_by_sdirt_rf50mm.yml [--device cuda] [--out DIR]

Two parts, as in the JAX app:
  * DP-simulation fidelity: render the F/20 flat captures to F/4 through
    the PSF surrogate (``fused`` render: bf16 MLP -> CUDA conv kernel) and
    score them against the real F/4 captures (PSNR/SSIM per view);
  * depth: run DDDNet on the real box, flat-to-depth and casual DP pairs and
    score the depth (MAE, acc1..3, ...).
Writes ``DPimages/res.csv`` (flat scores) and ``depth.csv`` under ``--out``.
Stages ``full`` and ``train``, and the perceptual score, come with later
slices.
"""

from __future__ import annotations

import argparse
import csv
import logging
import os
import time
from datetime import datetime

import numpy as np
import torch

from .dfdp.basenet import build_basenet
from .dfdp.factory import (get_depth_sample_set, get_flat_sample_set,
                           get_lens, ported_weights)
from .dfdp.metrics import mask_psnr, mask_ssim
from .dfdp.monitor import DEPTH_METRICS, ResultsMonitor, select_focus_dist
from .dfdp.train import dfdp_infer
from .utils.config import load_config
from .utils.device import resolve_device

FLAT_COLUMNS = ("idx", "distance_mm", "psnr_l", "psnr_r", "ssim_l", "ssim_r")


def test_dp_images(lens, flat_set, variant: str = "fused"):
    """Per-scene PSNR/SSIM of F/20 -> F/4 renders against the F/4 captures."""
    records = []
    for idx in range(len(flat_set)):
        f4, f20, depth = (a[None] for a in flat_set[idx])
        focus = select_focus_dist(depth, 1)
        dist, foc = -depth * 1e3, -focus[:, 0] * 1e3
        dof_l = lens.render(f20[:, :3], dist, foc, variant)[:, :3].cpu().numpy()
        dof_r = lens.render(f20[:, 3:], dist, foc, variant)[:, 3:].cpu().numpy()
        f4_l, f4_r = f4[:, :3], f4[:, 3:]
        rec = dict(zip(FLAT_COLUMNS, (
            idx, round(float(depth[0, 0, 0, 0] * 1e3)),
            mask_psnr(dof_l, f4_l), mask_psnr(dof_r, f4_r),
            mask_ssim(dof_l, f4_l), mask_ssim(dof_r, f4_r))))
        logging.info(f"flat {rec}")
        records.append(rec)
    return records


def test_depth(net, test_set, device):
    """Depth metrics of the net over a real DP set, averaged over frames."""
    monitor = ResultsMonitor()
    for idx in range(len(test_set)):
        imgs, gt_depth = test_set[idx]
        stack = torch.from_numpy(imgs[None]).to(device)
        pred = dfdp_infer(net, stack).cpu().numpy()
        monitor.add(pred, gt_depth)
    return monitor.metric_dict()


def run_sample(args: dict, device="cuda", variant: str = "fused") -> dict:
    """``--stage sample`` on the config's sample sets; returns
    {"flat": [per-scene scores], "depth": {set: metrics}, "seconds": ...}."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    _, lens = get_lens(args, device=dev)
    flat = test_dp_images(lens, get_flat_sample_set(args), variant)
    t1 = time.perf_counter()
    net = build_basenet(ported_weights(args["train"]["dfdpnet_pretrained"]),
                        device=dev)
    depth = {}
    for tag, ds in zip(("box", "f2d", "casual"), get_depth_sample_set(args)):
        depth[tag] = test_depth(net, ds, dev)
        logging.info(f"depth {tag}: {depth[tag]}")
    t2 = time.perf_counter()
    return {"flat": flat, "depth": depth,
            "seconds": {"render_part": t1 - t0, "depth_part": t2 - t1}}


def write_csv(result: dict, out_dir: str):
    os.makedirs(f"{out_dir}/DPimages", exist_ok=True)
    with open(f"{out_dir}/DPimages/res.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=FLAT_COLUMNS)
        w.writeheader()
        w.writerows(result["flat"])
    with open(f"{out_dir}/depth.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(("set",) + DEPTH_METRICS)
        for tag, m in result["depth"].items():
            w.writerow((tag,) + tuple(m[k] for k in DEPTH_METRICS))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--config", default="configs/dfdp_by_sdirt_rf50mm.yml")
    ap.add_argument("--stage", choices=("sample",), default="sample")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None,
                    help="result folder (default ./results/<time>-Sdirt_torch)")
    cli = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s - %(message)s")
    args = load_config(cli.config)
    result = run_sample(args, device=cli.device)
    flat = np.array([[r[k] for k in FLAT_COLUMNS[2:]] for r in result["flat"]])
    logging.info(f"Avg [psnr_l, psnr_r, ssim_l, ssim_r]: {flat.mean(0)}")
    out = cli.out or ("./results/" + datetime.now().strftime("%m%d-%H%M%S")
                      + "-Sdirt_torch")
    write_csv(result, out)
    logging.info(f"results in {out}")
    return result


if __name__ == "__main__":
    main()
