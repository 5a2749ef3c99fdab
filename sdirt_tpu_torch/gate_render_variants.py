"""Quality gate for the render variants (PyTorch counterpart of
scripts/gate_render_variants.py).

  python -m sdirt_tpu_torch.gate_render_variants [--config CFG]
      [--variants scan fused fused_int8 ...] [--limit 6] [--model NAME]
      [--psfnet PATH] [--f32-baseline] [--device cuda|cpu]

Renders the real F/20 flat captures of the config's sample set to F/4 once
per variant with the same surrogate (dfdp_net.test_dp_images) and prints a
PSNR/SSIM/perceptual table. The first row is the baseline; a variant passes
when its PSNR of both views is within 0.1 dB of it. ``--f32-baseline``
puts a ``scan_f32`` row first (the scan variant with the network in f32) and
gates against it. ``--model`` / ``--psfnet`` replace the config's surrogate
(e.g. ``mlpb@256x48`` and ``./ckpt/rf50mm/F4_PSFNet_mlpb@256x48``, read
from its export, dfdp/factory.ported_weights). A variant that fails raises.
"""

from __future__ import annotations

import argparse
import logging

import numpy as np

from .dfdp.factory import get_flat_sample_set, get_lens
from .dfdp_net import test_dp_images
from .render import dense_bf16, fused_conv
from .utils.config import load_config
from .utils.device import resolve_device

GATE_DB = 0.1
SCORES = ("psnr_l", "psnr_r", "ssim_l", "ssim_r", "perc_l", "perc_r")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--config", default="configs/dfdp_by_sdirt_rf50mm.yml")
    ap.add_argument("--variants", nargs="+",
                    default=("scan", "fused", "fused_int8"))
    ap.add_argument("--limit", type=int, default=6,
                    help="flat captures to evaluate per variant")
    ap.add_argument("--model", default=None,
                    help="replace the surrogate architecture (e.g. mlp@256, "
                         "mlpb@256x48)")
    ap.add_argument("--psfnet", default=None,
                    help="replace the surrogate checkpoint path")
    ap.add_argument("--f32-baseline", action="store_true",
                    help="add a scan_f32 row (scan, network in f32) and gate "
                         "against it")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> list[dict]:
    """Run the gate; returns one row per variant: its mean scores over the
    scenes, the per-scene records ("flat") and the K2 and K3 launches it
    made."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = load_config(args.config)
    if args.model:
        cfg["test"]["psfnet_model"] = args.model
    if args.psfnet:
        cfg["test"]["psfnet_path"] = args.psfnet
    _, lens = get_lens(cfg, device=dev)
    flat_set = get_flat_sample_set(cfg)
    n = min(args.limit, len(flat_set)) if args.limit else len(flat_set)
    scenes = [flat_set[i] for i in range(n)]      # decoded once, for every row

    variants = list(args.variants)
    if args.f32_baseline:
        variants.insert(0, "scan_f32")
    rows = []
    for variant in variants:
        kw = ({"variant": "scan", "mlp_bf16": False} if variant == "scan_f32"
              else {"variant": variant})
        before = fused_conv.launches, dense_bf16.launches
        flat = test_dp_images(lens, scenes, **kw)
        row = {"variant": variant, "flat": flat,
               "k2_launches": fused_conv.launches - before[0],
               "k3_launches": dense_bf16.launches - before[1]}
        row.update({k: float(np.mean([r[k] for r in flat])) for k in SCORES})
        rows.append(row)
        logging.info(f"--- {variant}: " + " ".join(f"{k} {row[k]:.4f}" for k in SCORES))

    print(f"\n{'variant':>12} " + " ".join(f"{k:>8}" for k in SCORES))
    for r in rows:
        print(f"{r['variant']:>12} {r['psnr_l']:>8.3f} {r['psnr_r']:>8.3f} "
              f"{r['ssim_l']:>8.4f} {r['ssim_r']:>8.4f} {r['perc_l']:>8.5f} "
              f"{r['perc_r']:>8.5f}")
    base = rows[0]
    for r in rows[1:]:
        dl, dr = r["psnr_l"] - base["psnr_l"], r["psnr_r"] - base["psnr_r"]
        ok = abs(dl) <= GATE_DB and abs(dr) <= GATE_DB
        print(f"{r['variant']}: dPSNR_l {dl:+.3f} dB, dPSNR_r {dr:+.3f} dB "
              f"against {base['variant']}: {'within' if ok else 'OUTSIDE'} "
              f"{GATE_DB} dB")
    return rows


if __name__ == "__main__":
    main()
