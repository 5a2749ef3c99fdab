"""PSF-surrogate fit of the PyTorch port (counterpart of
``apps/fit_psfnet.py``): fit the implicit dual-pixel PSF network against
ray-traced DP PSFs, made in every step by the fused trace (K1, a CUDA
kernel on the card).

  python -m sdirt_tpu_torch.fit_psfnet [--device cuda] [--skip-analysis] \\
      [--model mlp|mlp@W|mlpconv|siren] \\
      [--iters N --bs 64 --spp 20000 --eval-bs 1024 --eval-spp 65536 ...]

The defaults are the published configuration (Canon RF50mm, ``mlp``, ks 21,
512x768, refocused to 1 m, bs 64 x 20000 rays, lr 1e-4). Unless
``--skip-analysis`` is given, the lens analysis (optics/analysis.py) runs
first at -500 and -20000 mm from the sensor: ``<depth>.npz`` (set-up and
ray paths), ``<depth>_psf<d>mm_left.png`` / ``.npz`` (the PSF map) and the
printed RMS radii. The result folder then gets ``lens.json``, the resumable
train state (``state/``), the fitted net ``psfnet_<model>.npz`` (the
layout the serve path loads), ``compare_psf.npz`` (traced vs predicted
PSFs) and its panels ``compare_<depth>_v0*.png``. Matrix products run in
full f32: TF32 is switched off, as the JAX code asks for
``Precision.HIGHEST``.

``--mesh DATA RAYS`` fits over DATA x RAYS processes, one card each
(NCCL; gloo with ``--device cpu``): the field points split over DATA, the
Monte-Carlo rays of every step's main bundle over RAYS, their splat grids
summed (parallel/steps.py); bs must divide by DATA. Rank 0 runs the
analysis, logs, writes the checkpoints and the net and compares the PSFs.
"""

from __future__ import annotations

import argparse
import logging
import os
import time
from datetime import datetime

import torch

from .optics.analysis import analysis
from .parallel.mesh import launch, make_mesh
from .psfnet.surrogate import PSFNetLens
from .psfnet.train import fit_psfnet
from .utils.device import resolve_device


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--lens", default="./lenses/rf50mm/lens_web.json")
    ap.add_argument("--model", default="mlp",
                    help="mlp | mlp@WIDTH | mlpconv | siren")
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
                    default=None,
                    help="fit over a (data, rays) grid of DATA x RAYS processes, "
                         "one card each: field points split over DATA, "
                         "Monte-Carlo rays over RAYS (bs %%%% DATA == 0)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the fit; returns {"losses", "evals", "d_sensor", "result_dir",
    "analysis", "seconds"} (losses per step, evals as (step, l1, l2), the
    RMS radii (avg, on-axis, off-axis) [mm] by analysis depth). With
    ``--mesh`` these are rank 0's, and "k1_launches" lists every rank's K1
    launches."""
    args = parse_args(argv)
    if args.mesh is None:
        return run(args, resolve_device(args.device))
    n_data, n_rays = args.mesh
    world = n_data * n_rays
    if args.bs % n_data:
        raise ValueError(f"--mesh: bs {args.bs} does not split over {n_data} data ranks")
    device = resolve_device(args.device)
    if device.type == "cuda" and world > torch.cuda.device_count():
        raise ValueError(f"--mesh {n_data} {n_rays} needs {world} cards, "
                         f"{torch.cuda.device_count()} visible")
    result_dir = args.result_dir or (
        "./results/" + datetime.now().strftime("%m%d-%H%M%S") + "-psfnet_torch")
    args.result_dir = result_dir
    logging.basicConfig(level=logging.INFO, format="%(asctime)s - %(message)s")
    logging.info(f"multi-chip fit over mesh {{'data': {n_data}, 'rays': {n_rays}}}")
    outs = launch(_mesh_rank, world, device=device.type, args=(args,),
                  timeout=7 * 24 * 3600.0)
    return {**outs[0], "k1_launches": [o["k1_launches"] for o in outs]}


def _mesh_rank(rank, world, dev, args):
    from .dp import fused_trace

    out = run(args, dev, make_mesh(*args.mesh))
    return {**out, "k1_launches": fused_trace.launches}


def run(args, device, mesh=None) -> dict:
    """The fit of main() on ``device``, over ``mesh`` (parallel.mesh.Mesh)
    when given."""
    chief = mesh is None or mesh.rank == 0
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
    d_sensor = lens.d_sensor
    lens.refocus(args.focus_mm + d_sensor)
    if args.focus_mm != -1000.0:
        # re-centre the training-z sampler and eval band on the new focus
        lens.set_focus_prior(args.focus_mm)
    if chief:
        lens.write_lens_json(f"{result_dir}/lens.json")
    logging.info(f"d_sensor: {lens.d_sensor}")

    rms, t_analysis = {}, {}
    if not args.skip_analysis and chief:
        # at the pinned sensor distance's offsets, as the JAX app does
        for depth0 in (-500, -20000):
            depth = depth0 + d_sensor
            t_a = time.perf_counter()
            rms[depth] = analysis(lens, save_name=f"{result_dir}/{int(depth)}",
                                  depth=depth, ks=args.ks)
            t_analysis[depth] = time.perf_counter() - t_a

    if args.pretrained and os.path.exists(args.pretrained):
        lens.load_net(args.pretrained)

    t_fit = time.perf_counter()
    fit = fit_psfnet(lens, iters=args.iters, bs=args.bs, lr=args.lr,
                     spp=args.spp, evaluate_every=args.evaluate_every,
                     result_dir=result_dir, seed=args.seed, log_fn=logging.info,
                     resume=args.resume, eval_bs=args.eval_bs,
                     eval_spp=args.eval_spp, keep_states=args.keep_states,
                     mesh=mesh)
    t_cmp = time.perf_counter()
    if chief:
        lens.compare_psf(save_path=f"{result_dir}/compare_psf.npz", save_dir=result_dir)
    t1 = time.perf_counter()
    logging.info("Finish PSF net fitting.")
    return {**fit, "d_sensor": lens.d_sensor, "result_dir": result_dir,
            "analysis": rms,
            "seconds": {"setup": t_fit - t0 - sum(t_analysis.values()),
                        "analysis": t_analysis, "fit": t_cmp - t_fit,
                        "compare": t1 - t_cmp, "total": t1 - t0}}


if __name__ == "__main__":
    main()
