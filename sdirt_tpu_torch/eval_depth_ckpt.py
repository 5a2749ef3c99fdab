"""Evaluate a DfDP depth net on the synthetic validation styles and the
bundled real sample sets (PyTorch counterpart of scripts/eval_depth_ckpt.py,
which picked the shipped ckpt/rf50mm/Sdirt_best_acc1).

  python -m sdirt_tpu_torch.eval_depth_ckpt --ckpt ckpt/rf50mm/Sdirt_best_acc1 \\
      [--res 512 768] [--val-len 16] [--skip-real] [--skip-synth] \\
      [--lens lenses/rf50mm/lens_web.json] [--psfnet ckpt/rf50mm/F4_PSFNet_mlp] \\
      [--device cuda|cpu]

Each synthetic style (v1-v6, SyntheticRGBD seed 999, eval mode) is rendered
one scene at a time, noise-free, through the surrogate lens (ks 21) with
SDIRT_RENDER_VARIANT or the port's default ``fused`` (the K2 kernel on the
card), and scored: acc1 and MAE over the frame, acc1 in the near band
(<= 3 m), and the best-constant-predictor floor of each (``constant_floor``:
a net only shows learning if it beats it). The real sets are box, f2d and
casual of real_sample_set/. Checkpoint names resolve as a config's do
(dfdp/factory.py:ported_weights).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .dfdp.basenet import build_basenet
from .dfdp.datasets import SyntheticRGBD
from .dfdp.factory import get_depth_sample_set, ported_weights
from .dfdp.metrics import mask_accuracy_k, mask_mae
from .dfdp.monitor import ResultsMonitor, select_focus_dist
from .dfdp.train import dfdp_infer
from .psfnet.surrogate import PSFNetLens
from .utils.device import resolve_device

STYLES = ("v1", "v2", "v3", "v4", "v5", "v6")
REAL_SETS = {"real_box_sample": "./real_sample_set/box",
             "real_flat_sample": "./real_sample_set/flat",
             "real_casual_sample": "./real_sample_set/casual"}


def constant_floor(depths) -> float:
    """The best acc1 (max ratio < 1.25) of one constant depth over 120
    log-spaced candidates from 0.3 to 9 m."""
    best = 0.0
    for c in np.exp(np.linspace(np.log(0.3), np.log(9), 120)):
        r = np.maximum(depths / c, c / depths)
        best = max(best, float((r < 1.25).mean()))
    return best


def eval_style(net, lens, style: str, res, val_len: int, dev) -> dict:
    """acc1 / MAE / near-band acc1 of one synthetic style, with floors."""
    ds = SyntheticRGBD(tuple(res), length=val_len, seed=999, train=False, style=style)
    accs, maes, gts, near_accs, near_gts = [], [], [], [], []
    for i in range(len(ds)):
        aif, gt = (a[None] for a in ds[i])
        focus = select_focus_dist(gt, 1)
        dp = lens.render(torch.from_numpy(aif).to(dev),
                         torch.from_numpy(-gt * 1e3).to(dev), -focus[:, 0] * 1e3,
                         train=False)
        pred = dfdp_infer(net, dp).cpu().numpy()
        mask = gt > 0
        accs.append(mask_accuracy_k(pred, gt, 1, mask))
        maes.append(mask_mae(pred, gt, mask))
        # near band: <= 3 m, where the DP disparity still discriminates depth
        near = mask & (gt <= 3.0)
        if near.any():
            near_accs.append(mask_accuracy_k(pred, gt, 1, near))
            near_gts.append(gt[near].ravel())
        gts.append(gt.ravel())
    out = {"acc1": float(np.mean(accs)), "mae": float(np.mean(maes)),
           "floor": constant_floor(np.concatenate(gts)),
           "near_acc1": None, "near_floor": None}
    if near_gts:
        out.update(near_acc1=float(np.mean(near_accs)),
                   near_floor=constant_floor(np.concatenate(near_gts)))
    return out


def eval_real(net, res, dev) -> dict:
    """acc1 and MAE of the real sample sets (box, f2d, casual)."""
    out = {}
    sets = get_depth_sample_set({"res": tuple(res), **REAL_SETS})
    for ds, tag in zip(sets, ("box", "f2d", "casual")):
        monitor = ResultsMonitor("dfdp")
        for i in range(len(ds)):
            imgs, gt = ds[i]
            pred = dfdp_infer(net, torch.from_numpy(imgs[None]).to(dev))
            monitor.set_outputs({"gt_depth": gt, "pred_depth_est": pred.cpu().numpy()})
            monitor.compute_metrics()
        m = monitor.metric_dict(len(ds))
        out[tag] = {"acc1": m["acc1"], "mae": m["mae"]}
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--res", type=int, nargs=2, default=(512, 768))
    ap.add_argument("--skip-real", action="store_true")
    ap.add_argument("--skip-synth", action="store_true",
                    help="real sample sets only (no rendered validation)")
    ap.add_argument("--val-len", type=int, default=16)
    ap.add_argument("--lens", default="lenses/rf50mm/lens_web.json")
    ap.add_argument("--psfnet", default="ckpt/rf50mm/F4_PSFNet_mlp")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    net = build_basenet(ported_weights(args.ckpt), device=dev)
    result = {"synthetic": {}, "real": {}}
    if not args.skip_synth:
        lens = PSFNetLens(args.lens, kernel_size=21, sensor_res=tuple(args.res),
                          device=dev)
        lens.load_net(ported_weights(args.psfnet))
        for style in STYLES:
            r = result["synthetic"][style] = eval_style(net, lens, style, args.res,
                                                        args.val_len, dev)
            near = ("n/a (no pixels <= 3 m)" if r["near_acc1"] is None else
                    f"{r['near_acc1']:.4f} (floor {r['near_floor']:.3f})")
            print(f"[{style}] val acc1 {r['acc1']:.4f}  mae {r['mae']:.3f}"
                  f"  (best-constant floor {r['floor']:.3f})  |  near<=3m acc1 "
                  f"{near}", flush=True)
    if not args.skip_real:
        result["real"] = eval_real(net, args.res, dev)
        for tag, m in result["real"].items():
            print(f"[real {tag}] acc1 {m['acc1']:.4f}  mae {m['mae']:.3f}", flush=True)
    return result


if __name__ == "__main__":
    main()
