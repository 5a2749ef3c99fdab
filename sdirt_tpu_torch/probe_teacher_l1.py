"""Ray-traced truth L1 / L2 of a fitted PSF surrogate under the fit's
evaluation (PyTorch counterpart of scripts/probe_teacher_l1.py).

  python -m sdirt_tpu_torch.probe_teacher_l1 [--lens lenses/rf35mm/lens_web.json] \\
      [--model mlp] [--ckpt ckpt/rf35mm/F4_PSFNet_mlp] [--ks 21] [--device cuda|cpu]

The net (read from its export, dfdp/factory.py:ported_weights) on a
PSFNetLens at 512x768 goes through psfnet/train.py:make_eval_fn: 1024 field
points x 65536 rays traced through K1 (dp_psf_fused, 16 launches), from a
generator seeded 123. If a distilled student's truth L1 floors at X while
its distillation loss keeps falling, this tells whether the teacher itself
scores about X.
"""

from __future__ import annotations

import argparse
import time

import torch

from .dfdp.factory import ported_weights
from .psfnet.surrogate import PSFNetLens
from .psfnet.train import make_eval_fn
from .utils.device import resolve_device


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--lens", default="lenses/rf35mm/lens_web.json")
    ap.add_argument("--model", default="mlp")
    ap.add_argument("--ckpt", default="ckpt/rf35mm/F4_PSFNet_mlp")
    ap.add_argument("--ks", type=int, default=21)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Print and return {"l1", "l2", "seconds"}."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    lens = PSFNetLens(args.lens, model_name=args.model, kernel_size=args.ks,
                      sensor_res=(512, 768), device=dev)
    lens.load_net(ported_weights(args.ckpt))
    eval_fn = make_eval_fn(lens, ks=args.ks)
    t0 = time.perf_counter()
    l1, l2 = (float(v) for v in eval_fn(lens.net,
                                        torch.Generator(device=dev).manual_seed(123)))
    seconds = time.perf_counter() - t0
    print(f"{args.ckpt}: truth L1 {l1:.6f}  L2 {l2:.3e}")
    return {"l1": l1, "l2": l2, "seconds": seconds}


if __name__ == "__main__":
    main()
