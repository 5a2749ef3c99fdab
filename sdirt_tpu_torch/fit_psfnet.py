"""PSF-surrogate fit of the PyTorch port (counterpart of
``apps/fit_psfnet.py``): fit the implicit dual-pixel PSF network against
ray-traced DP PSFs, made in every step by the fused trace (K1, a CUDA
kernel on the card).

  python -m sdirt_tpu_torch.fit_psfnet [--device cuda] --skip-analysis \\
      [--iters N --bs 64 --spp 20000 --eval-bs 1024 --eval-spp 65536 ...]

The defaults are the published configuration (Canon RF50mm, ``mlp``, ks 21,
512x768, refocused to 1 m, bs 64 x 20000 rays, lr 1e-4). The result folder
gets ``lens.json``, the resumable train state (``state/``), the fitted net
``psfnet_<model>.npz`` (the layout the serve path loads) and
``compare_psf.npz`` (traced vs predicted PSFs). Matrix products run in full
f32: TF32 is switched off, as the JAX code asks for ``Precision.HIGHEST``.

Not ported yet (ROADMAP.md §1): the lens analysis of ``optics/analysis.py``
(so ``--skip-analysis`` is required) and ``compare_psf``'s figures (item 1),
and the multi-chip ``--mesh`` (item 7).
"""

from __future__ import annotations

import argparse
import logging
import os
import time
from datetime import datetime

import torch

from .psfnet.surrogate import PSFNetLens
from .psfnet.train import fit_psfnet
from .utils.device import resolve_device

NOT_PORTED = "not ported yet (ROADMAP.md §1 item {item}: {what})"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--lens", default="./lenses/rf50mm/lens_web.json")
    ap.add_argument("--model", default="mlp", help="mlp | mlp@WIDTH")
    ap.add_argument("--ks", type=int, default=21, help="21 for F/4, 35 for F/1.8")
    ap.add_argument("--fnum", type=float, default=None,
                    help="re-stop the lens to this f-number before fitting")
    ap.add_argument("--res", type=int, nargs=2, default=(512, 768))
    ap.add_argument("--focus-mm", type=float, default=-1000.0,
                    help="object-side focus distance in mm (negative)")
    ap.add_argument("--iters", type=int, default=90000)
    ap.add_argument("--bs", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--spp", type=int, default=20000)
    ap.add_argument("--evaluate-every", type=int, default=1000)
    ap.add_argument("--pretrained", default=None,
                    help="exported .npz surrogate to warm-start from")
    ap.add_argument("--result-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--skip-analysis", action="store_true")
    ap.add_argument("--resume", action="store_true",
                    help="resume the full train state from result-dir")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--eval-bs", type=int, default=1024)
    ap.add_argument("--keep-states", type=int, default=3,
                    help="resumable train-state checkpoints kept")
    ap.add_argument("--eval-spp", type=int, default=65536)
    ap.add_argument("--mesh", type=int, nargs=2, metavar=("DATA", "RAYS"),
                    default=None, help=NOT_PORTED.format(item=7, what="multi-GPU"))
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the fit; returns {"losses", "evals", "d_sensor", "result_dir",
    "seconds"} (losses per step, evals as (step, l1, l2))."""
    args = parse_args(argv)
    if args.mesh is not None:
        raise NotImplementedError("--mesh: " + NOT_PORTED.format(item=7,
                                                                 what="multi-GPU"))
    if not args.skip_analysis:
        raise NotImplementedError(
            "the lens analysis (optics/analysis.py) is "
            + NOT_PORTED.format(item=1, what="optics/analysis.py") + "; pass --skip-analysis")
    device = resolve_device(args.device)
    # full-f32 matrix products in the splat and the MLP
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    logging.basicConfig(level=logging.INFO, format="%(asctime)s - %(message)s")
    t0 = time.perf_counter()

    result_dir = args.result_dir or (
        "./results/" + datetime.now().strftime("%m%d-%H%M%S") + "-psfnet_torch")
    os.makedirs(result_dir, exist_ok=True)
    torch.manual_seed(args.seed)

    lens = PSFNetLens(filename=args.lens, model_name=args.model,
                      sensor_res=tuple(args.res), kernel_size=args.ks,
                      seed=args.seed, device=device)
    if args.fnum is not None:
        lens.set_aperture(fnum=args.fnum)
        logging.info(f"aperture re-stopped to F/{lens.fnum:.3f}")
    lens.refocus(args.focus_mm + lens.d_sensor)
    if args.focus_mm != -1000.0:
        # re-centre the training-z sampler and eval band on the new focus
        lens.set_focus_prior(args.focus_mm)
    lens.write_lens_json(f"{result_dir}/lens.json")
    logging.info(f"d_sensor: {lens.d_sensor}")

    if args.pretrained and os.path.exists(args.pretrained):
        lens.load_net(args.pretrained)

    t_fit = time.perf_counter()
    fit = fit_psfnet(lens, iters=args.iters, bs=args.bs, lr=args.lr,
                     spp=args.spp, evaluate_every=args.evaluate_every,
                     result_dir=result_dir, seed=args.seed, log_fn=logging.info,
                     resume=args.resume, eval_bs=args.eval_bs,
                     eval_spp=args.eval_spp, keep_states=args.keep_states)
    t_cmp = time.perf_counter()
    lens.compare_psf(save_path=f"{result_dir}/compare_psf.npz")
    t1 = time.perf_counter()
    logging.info("Finish PSF net fitting.")
    return {**fit, "d_sensor": lens.d_sensor, "result_dir": result_dir,
            "seconds": {"setup": t_fit - t0, "fit": t_cmp - t_fit,
                        "compare": t1 - t_cmp, "total": t1 - t0}}


if __name__ == "__main__":
    main()
