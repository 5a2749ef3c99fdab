"""Far-field A/B of depth nets on the same synthetic scenes (PyTorch
counterpart of scripts/eval_farfield_ab.py).

Each arm renders the SyntheticRGBD v2 validation scenes (seed 999) through
its OWN aperture and PSF surrogate, the capture physics under test, and its
depth net predicts the depth; the metrics are split into near (<= 3 m) and
far (> 3 m) bands:

  python -m sdirt_tpu_torch.eval_farfield_ab \\
      --arm f4  ckpt/rf50mm/Sdirt_f4_farfield  ckpt/rf50mm/F4_PSFNet_mlp 21 \\
      --arm f18 ckpt/rf50mm/Sdirt_f18_farfield ckpt/rf50mm/F18_PSFNet_mlp_ks35 35 \\
      [--fnum18 1.8] [--res 256 384] [--val-len 16] [--device cuda|cpu]

Checkpoint names resolve as a config's do (dfdp/factory.py:ported_weights).
PSFNET may be a comma list of ``path[@focus_mm]`` entries, a multi-focus
stack arm whose net takes 6V channels. An arm whose name contains "18" is
re-stopped to ``--fnum18``. Renders take SDIRT_RENDER_VARIANT or the
port's default (``fused``, through the K2 kernel on the card).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .dfdp.basenet import build_basenet
from .dfdp.datasets import SyntheticRGBD
from .dfdp.factory import ported_weights
from .dfdp.metrics import mask_accuracy_k, mask_mae
from .dfdp.monitor import select_focus_dist
from .dfdp.train import dfdp_infer
from .psfnet.stack import FocalStackLens
from .psfnet.surrogate import PSFNetLens
from .render import fused_conv
from .utils import trace
from .utils.device import resolve_device

COLUMNS = ("acc1", "mae", "far_acc1", "far_mae", "near_acc1")


def build_arm_lens(name: str, psfnet: str, ks: int, args, dev):
    """The arm's lens: one PSFNetLens per ``path[@focus_mm]`` entry (a
    FocalStackLens for more than one), re-stopped when the name contains
    "18", refocused (focus and focus prior) when focus_mm is not -1000."""
    def build_one(spec):
        path, _, foc = spec.partition("@")
        sub = PSFNetLens(args.lens, kernel_size=ks, sensor_res=tuple(args.res),
                         device=dev)
        if "18" in name:
            sub.set_aperture(fnum=args.fnum18)
        if foc and float(foc) != -1000.0:
            sub.refocus(float(foc) + sub.d_sensor)
            sub.set_focus_prior(float(foc))
        return sub.load_net(ported_weights(path))

    subs = [build_one(s) for s in psfnet.split(",")]
    return subs[0] if len(subs) == 1 else FocalStackLens(subs)


def evaluate_arm(name, ckpt, psfnet, ks, args, dev) -> dict:
    """One arm over the validation scenes: the COLUMNS means (far and near
    over the scenes that have such pixels), the render ms per scene and the
    K2 launches of the arm's renders."""
    lens = build_arm_lens(name, psfnet, ks, args, dev)
    net = build_basenet(ported_weights(ckpt), device=dev,
                        n_views=getattr(lens, "n_views", 1))
    ds = SyntheticRGBD(tuple(args.res), length=args.val_len, seed=999,
                       train=False, style="v2")
    acc, mae, facc, fmae, nacc, render_ms = [], [], [], [], [], []
    k2_before = fused_conv.launches
    for i in range(len(ds)):
        aif, gt = (a[None] for a in ds[i])
        focus = select_focus_dist(gt, 1)
        m0 = trace.mark(dev)
        dp = lens.render(aif, -gt * 1e3, -focus[:, 0] * 1e3)
        m1 = trace.mark(dev)
        pred = dfdp_infer(net, dp).cpu().numpy()       # synchronises
        render_ms.append(trace.elapsed_ms(m0, m1))
        mask = gt > 0
        acc.append(mask_accuracy_k(pred, gt, 1, mask))
        mae.append(mask_mae(pred, gt, mask))
        far, near = mask & (gt > 3.0), mask & (gt <= 3.0)
        if far.any():
            facc.append(mask_accuracy_k(pred, gt, 1, far))
            fmae.append(mask_mae(pred, gt, far))
        if near.any():
            nacc.append(mask_accuracy_k(pred, gt, 1, near))
    row = dict(zip(COLUMNS, (float(np.mean(v)) for v in
                             (acc, mae, facc, fmae, nacc))))
    return {"name": name, **row, "render_ms": render_ms,
            "k2_launches": fused_conv.launches - k2_before,
            "ks": ks, "n_views": getattr(lens, "n_views", 1)}


def main(argv=None) -> list:
    """Runs the arms and prints the JAX script's table; returns one dict per
    arm (COLUMNS, ``render_ms`` per scene, ``k2_launches``, ``ks``,
    ``n_views``)."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arm", nargs=4, action="append", required=True,
                    metavar=("NAME", "CKPT", "PSFNET", "KS"),
                    help="evaluation arm: name, depth checkpoint, surrogate "
                         "(or a comma list of path[@focus_mm]), ks")
    ap.add_argument("--fnum18", type=float, default=1.8,
                    help="aperture for any arm whose name contains '18'")
    ap.add_argument("--res", type=int, nargs=2, default=(256, 384))
    ap.add_argument("--val-len", type=int, default=16)
    ap.add_argument("--lens", default="lenses/rf50mm/lens_web.json")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    # full-f32 matrix products and convolutions (cuDNN allows TF32 by default)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = []
    for name, ckpt, psfnet, ks in args.arm:
        r = evaluate_arm(name, ckpt, psfnet, int(ks), args, dev)
        rows.append(r)
        print(f"[{name}] overall acc1 {r['acc1']:.4f} mae {r['mae']:.3f}"
              f" | FAR>3m acc1 {r['far_acc1']:.4f} mae {r['far_mae']:.3f}"
              f" | near acc1 {r['near_acc1']:.4f}", flush=True)
    print("\narm      acc1    mae    far_acc1  far_mae  near_acc1")
    for r in rows:
        print(f"{r['name']:8s} {r['acc1']:.4f}  {r['mae']:.3f}  "
              f"{r['far_acc1']:.4f}    {r['far_mae']:.3f}    {r['near_acc1']:.4f}")
    return rows


if __name__ == "__main__":
    main()
