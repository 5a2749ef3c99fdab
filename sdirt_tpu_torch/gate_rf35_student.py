"""Teacher-relative fidelity gate of rf35mm surrogate students (PyTorch
counterpart of scripts/gate_rf35_student.py).

  python -m sdirt_tpu_torch.gate_rf35_student --student-ckpt CKPT \\
      [--student mlp@256] [--variants fused fused_int8] \\
      [--teacher-ckpt ckpt/rf35mm/F4_PSFNet_mlp] [--limit 4] [--margin 1.0] \\
      [--skip-calibration] [--device cuda|cpu]

There are no rf35mm real captures, so the student is held to its teacher:
the F/20 flat captures of real_sample_set/flat (their content only; the
lens is rf35mm) are rendered at their plane depths, focus 1 m, through the
w512 teacher on ``scan_f32`` (the scan variant with the network in f32) and
through the student on each variant, and the agreement is the PSNR of the
student's render against the teacher's, per view, averaged over the scenes.
The calibration measures the same for the rf50mm pair w256 ``fused_int8``
against w512 ``scan_f32``, a pair that passed the real-capture gate; a
variant PASSes when both of its agreements are within ``--margin`` dB of
the calibration's. The ``fused`` variants run K2, once per view and scene.
Checkpoint names are read from their exports (dfdp/factory.py:
ported_weights). A variant that fails raises.
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from .dfdp.datasets import CanonFlatSet
from .dfdp.factory import ported_weights
from .dfdp.metrics import mask_psnr
from .psfnet.surrogate import PSFNetLens
from .render import fused_conv
from .utils.device import resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RF50 = os.path.join(ROOT, "lenses", "rf50mm", "lens_web.json")
RF35 = os.path.join(ROOT, "lenses", "rf35mm", "lens_web.json")
FLAT = os.path.join(ROOT, "real_sample_set", "flat")
RES = (512, 768)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--student", default="mlp@256")
    ap.add_argument("--student-ckpt", required=True)
    ap.add_argument("--variants", nargs="+", default=("fused", "fused_int8"))
    ap.add_argument("--teacher-ckpt", default="ckpt/rf35mm/F4_PSFNet_mlp")
    ap.add_argument("--limit", type=int, default=4)
    ap.add_argument("--margin", type=float, default=1.0,
                    help="allowed dB shortfall vs the rf50mm precedent")
    ap.add_argument("--skip-calibration", action="store_true")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def render_pairs(lens, scenes, variant):
    """Each scene's F/20 pair rendered at its plane depth, focus 1 m, on
    ``variant`` (``scan_f32``: scan with the network in f32); returns
    [(dof_l, dof_r)] numpy [1, 3, H, W] per scene."""
    kw = ({"variant": "scan", "mlp_bf16": False} if variant == "scan_f32"
          else {"variant": variant})
    foc = torch.full((1,), -1000.0)
    outs = []
    for _, f20, depth in scenes:
        dist = -depth[None] * 1e3
        dof_l = lens.render(f20[None, :3], dist, foc, **kw)[:, :3]
        dof_r = lens.render(f20[None, 3:], dist, foc, **kw)[:, 3:]
        outs.append((dof_l.cpu().numpy(), dof_r.cpu().numpy()))
    return outs


def agreement_db(a_pairs, b_pairs):
    """Mean PSNR of a's renders against b's, per view."""
    pl = [mask_psnr(a[0], b[0]) for a, b in zip(a_pairs, b_pairs)]
    pr = [mask_psnr(a[1], b[1]) for a, b in zip(a_pairs, b_pairs)]
    return sum(pl) / len(pl), sum(pr) / len(pr)


def main(argv=None) -> dict:
    """Run the gate; returns {"calibration": (psnr_l, psnr_r) or None, "bar",
    "rows": {variant: {"agree_l", "agree_r", "verdict", "k2_launches",
    "render_ms"}}}. The renders are RES (the JAX script's 512x768)."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    flat_set = CanonFlatSet(FLAT, resize=RES)
    scenes = [flat_set[i] for i in range(min(args.limit, len(flat_set)))]

    def lens(path, model, ckpt):
        out = PSFNetLens(path, model_name=model, kernel_size=21, sensor_res=RES,
                         device=dev)
        return out.load_net(ported_weights(ckpt))

    precedent = None
    if not args.skip_calibration:
        ref = render_pairs(lens(RF50, "mlp", "ckpt/rf50mm/F4_PSFNet_mlp"), scenes,
                           "scan_f32")
        stu = render_pairs(lens(RF50, "mlp@256", "ckpt/rf50mm/F4_PSFNet_mlp@256"),
                           scenes, "fused_int8")
        precedent = agreement_db(stu, ref)
        print(f"calibration rf50mm w256/fused_int8 vs w512/scan_f32: "
              f"psnr_l {precedent[0]:.3f} psnr_r {precedent[1]:.3f}", flush=True)

    teacher = lens(RF35, "mlp", args.teacher_ckpt)
    student = lens(RF35, args.student, args.student_ckpt)
    ref35 = render_pairs(teacher, scenes, "scan_f32")
    rows = {}
    for v in args.variants:
        before = fused_conv.launches
        t0 = time.perf_counter()
        stu35 = render_pairs(student, scenes, v)
        ms = 1e3 * (time.perf_counter() - t0) / (2 * len(scenes))
        al, ar = agreement_db(stu35, ref35)
        rows[v] = {"agree_l": al, "agree_r": ar,
                   "k2_launches": fused_conv.launches - before, "render_ms": ms}
        print(f"--- rf35 {v}: agree_l {al:.3f} agree_r {ar:.3f}", flush=True)

    bar = None
    if precedent and rows:
        bar = (precedent[0] - args.margin, precedent[1] - args.margin)
        for v, row in rows.items():
            row["verdict"] = ("PASS" if (row["agree_l"] >= bar[0]
                                         and row["agree_r"] >= bar[1]) else "FAIL")
            print(f"GATE rf35 {v}: {row['verdict']} (bar {bar[0]:.2f}/{bar[1]:.2f})",
                  flush=True)
    return {"calibration": precedent, "bar": bar, "rows": rows}


if __name__ == "__main__":
    main()
