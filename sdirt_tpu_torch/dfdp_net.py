"""DfDP entry point of the PyTorch port (counterpart of
``apps/dfdp_net.py``).

  python -m sdirt_tpu_torch.dfdp_net --stage sample|full|train \\
      --config configs/<name>.yml [--train-mode dfdp|deblur] \\
      [--device cuda|cpu] [--out DIR] [--save-images]

  --stage sample  evaluate on the bundled real_sample_set: DP-simulation
                  fidelity (render the F/20 flat captures to F/4 through the
                  PSF surrogate and score PSNR/SSIM per view against the real
                  F/4 captures) and depth (DDDNet on the real box,
                  flat-to-depth and casual DP pairs: MAE, acc1..3, ...);
  --stage full    the same on the config's ``real_*_test`` sets;
  --stage train   train DDDNet on DP pairs rendered on the fly from the
                  config's RGB-D sets (``NYUdata`` mixed with two passes of
                  ``FlyingThings3D`` for the first half of the epochs, or
                  ``FlyingThings3D``, or ``Synthetic`` scenes; render under
                  no_grad, then one AdamW step), validating on rendered
                  pairs of the test set (``FlyingThings3D``, ``NYUdata``,
                  ``Middlebury2014/2021``, ``Middlebury_FS`` or
                  ``Synthetic``) and on the real box set every epoch,
                  exporting the peak-validation-acc1 net to ``ckpt_out``
                  and the resumable train state to ``train_state_dir``.

The dataset roots are config keys (``NYUdata_train``,
``FlyingThings3D_train``, ``FlyingThings3D_test``, ``Middlebury_FS``, ...);
point them at local copies in the published layouts. --save-images writes
each validation and test frame's RGB views and JET depth maps under
``--out``/results/ and ``--out``/tests/ (dfdp/monitor.py:save_images).

--train-mode deblur adds the Mydeblur head: its refined depth and
all-in-focus image are scored beside the depth (acc1..3 of the refined
depth; PSNR and SSIM of the image where an all-in-focus truth exists) and
trained with the three-term loss. The config's lens may be a re-stopped
(``fnum``) or refocused (``focus_mm``) surrogate, a thin lens or a
multi-focus stack of V views; the net then takes 6V channels, and the real
captures (single-focus pairs) are not scored for V > 1.

Every render takes the variant SDIRT_RENDER_VARIANT names (render/pipeline.py:
scan, fused, fused_int8, basis, basis_int8), else the port's default
``fused`` (bf16 MLP -> the K2 CUDA kernel); the JAX package defaults to
``fused_int8``. Matrix products and convolutions run in full f32 (TF32 off).
The evaluation stages write ``DPimages/res.csv`` (flat scores: PSNR, SSIM
and the weight-free perceptual distance per view) and ``depth.csv`` under
``--out``.

--data-parallel (or the config key ``data_parallel``) trains over
n_data processes, one card each (NCCL), n_data the largest divisor of bs
not above the number of cards: every rank reads its slice of the same
batches, renders it through K2 and takes the data-parallel step
(parallel/steps.py); rank 0 validates and writes the checkpoints and the
images while the others wait. With one card it trains on that card.
"""

from __future__ import annotations

import argparse
import csv
import json
import logging
import os
import sys
import time
from datetime import datetime

import numpy as np
import torch
import torch.distributed as dist

from .dfdp.basenet import build_basenet
from .dfdp.datasets import DataLoader
from .dfdp.factory import (get_dataset, get_depth_sample_set,
                           get_depth_test_set, get_flat_sample_set,
                           get_flat_test_set, get_lens, ported_weights)
from .dfdp.metrics import mask_psnr, mask_ssim
from .dfdp.perceptual import batch_perceptual
from .dfdp.monitor import DEPTH_METRICS, ResultsMonitor, select_focus_dist
from .dfdp.train import create_dfdp_state, dfdp_infer, dfdp_train_step
from .parallel.mesh import broadcast_module, launch, make_mesh
from .render.pipeline import resolve_variant
from .utils import trace
from .utils.checkpoint import (TrainCheckpointer, read_ckpt_watermark,
                               save_inference_ckpt, write_ckpt_watermark)
from .utils.config import load_config
from .utils.device import resolve_device
from .utils.logging import host_rss_gb, set_logger, set_seed
from .utils.stall import StallWatchdog

FLAT_COLUMNS = ("idx", "distance_mm", "psnr_l", "psnr_r", "ssim_l", "ssim_r",
                "perc_l", "perc_r")


def test_dp_images(lens, flat_set, variant: str | None = None, **render_kw):
    """Per-scene PSNR, SSIM and perceptual distance (lower is better) of
    F/20 -> F/4 renders against the F/4 captures, per view. variant: None
    for SDIRT_RENDER_VARIANT or the port's default; render_kw go to
    lens.render."""
    variant = resolve_variant(variant)
    records = []
    for idx in range(len(flat_set)):
        f4, f20, depth = (a[None] for a in flat_set[idx])
        focus = select_focus_dist(depth, 1)
        dist, foc = -depth * 1e3, -focus[:, 0] * 1e3
        dof_l = lens.render(f20[:, :3], dist, foc, variant, **render_kw)[:, :3]
        dof_r = lens.render(f20[:, 3:], dist, foc, variant, **render_kw)[:, 3:]
        f4_l, f4_r = f4[:, :3], f4[:, 3:]
        perc = [round(batch_perceptual(d, f), 5)
                for d, f in ((dof_l, f4_l), (dof_r, f4_r))]
        dof_l, dof_r = dof_l.cpu().numpy(), dof_r.cpu().numpy()
        rec = dict(zip(FLAT_COLUMNS, (
            idx, round(float(depth[0, 0, 0, 0] * 1e3)),
            mask_psnr(dof_l, f4_l), mask_psnr(dof_r, f4_r),
            mask_ssim(dof_l, f4_l), mask_ssim(dof_r, f4_r), *perc)))
        logging.info(f"flat ({variant}) {rec}")
        records.append(rec)
    return records


MULTI_FOCUS_SKIP = ("multi-focus stack net: real-capture eval skipped "
                    "(bundled sets are single-focus 1 m captures)")


def _infer_outputs(net, stack, gt_depth, gt_aif=None, views=None) -> dict:
    """The monitor's outputs of one frame: the depth, and in deblur mode
    the refined depth and the all-in-focus image with its truth; ``views``
    adds the RGB views that save_images writes."""
    pred = dfdp_infer(net, stack)
    out = {"gt_depth": gt_depth, **(views or {})}
    if net.train_mode != "deblur":
        return {**out, "pred_depth_est": pred.cpu().numpy()}
    depth, depth_fix, aif = pred
    return {**out, "pred_depth_est": depth.cpu().numpy(),
            "pred_depth_fix": depth_fix.cpu().numpy(),
            "pred_aif": aif.float().cpu().numpy(),
            "gt_aif": None if gt_aif is None else np.asarray(gt_aif)}


def _saves_images(args) -> bool:
    return bool(args is not None and args.get("save_images"))


def test_depth(net, test_set, device, scene: str | None = None, epoch: int = 0,
               args: dict | None = None):
    """Depth metrics of the net over a real DP set, averaged over frames
    (in deblur mode also those of the refined depth; the real sets carry no
    all-in-focus truth). With a ``scene`` name the averages are logged, and
    with ``args`` (unless ``args["save_ckpt"]`` is false) the net is kept
    by the monitor's last/best policy under ``args["results_dir"]``; with
    ``args["save_images"]`` each frame's images go to
    ``<results_dir>/tests/``."""
    monitor = ResultsMonitor(net.train_mode)
    t_infer = 0.0
    save = _saves_images(args)
    for idx in range(len(test_set)):
        imgs, gt_depth = test_set[idx]
        t0 = time.perf_counter()
        stack = torch.from_numpy(imgs[None]).to(device)
        views = {"gt_l": imgs[None, :3], "gt_r": imgs[None, 3:6]} if save else None
        outputs = _infer_outputs(net, stack, gt_depth, views=views)
        t_infer += time.perf_counter() - t0
        monitor.set_outputs(outputs)
        monitor.compute_metrics()
        if save:
            monitor.save_images(f"{args['results_dir']}/tests/", scene, idx)
    n = len(test_set)
    if scene is not None:
        logging.info(f"Test Depth Est on {scene} ({t_infer:.2f}s inference)")
        monitor.logging(epoch, n)
    if args is not None and args.get("save_ckpt", True):
        monitor.save_pth(args, scene, n, net)
    return monitor.metric_dict(n)


def _render_batch(lens, aif, gt_depth, generator=None, train: bool = False):
    """Render the DP input stack of a batch on the lens's device.

    The all-in-focus image goes to the device as uint8 (round(x * 255)) and
    the depth as f16, both widened there, as the JAX app uploads them: the
    render sees the quantised values. Returns (stack [B, 6V, H, W] for a
    lens of V views, depth [B, 1, H, W] f32 metres, aif [B, 3, H, W] f32),
    on the device."""
    dev = lens.device
    with trace.span("render.prep", dev):
        aif_u8 = torch.from_numpy((np.asarray(aif) * 255.0 + 0.5)
                                  .astype(np.uint8))
        depth_f16 = torch.from_numpy(np.asarray(gt_depth).astype(np.float16))
        if dev.type == "cuda":
            aif_u8, depth_f16 = aif_u8.pin_memory(), depth_f16.pin_memory()
        aif_dev = aif_u8.to(dev, non_blocking=True).float() / 255.0
        depth_dev = depth_f16.to(dev, non_blocking=True).float()
        focus = select_focus_dist(gt_depth, 1)
    stack = lens.render(aif_dev, -depth_dev * 1e3, -focus[:, 0] * 1e3,
                        train=train, generator=generator)
    return stack, depth_dev, aif_dev


def validate(net, test_lens, valid_set, scene, args, epoch=0):
    """Depth metrics on rendered (noise-free) pairs of a synthetic set (in
    deblur mode also the refined depth's, and the all-in-focus image's PSNR
    and SSIM against the scene); the net is kept by the monitor's last/best
    policy. With ``args["save_images"]`` each frame's images go to
    ``<results_dir>/results/``."""
    loader = DataLoader(valid_set, batch_size=1, num_workers=2)
    monitor = ResultsMonitor(net.train_mode)
    n = len(valid_set)
    save = _saves_images(args)
    for idx, (aif, gt_depth) in enumerate(loader):
        stack, _, _ = _render_batch(test_lens, aif, gt_depth, train=False)
        views = None
        if save:
            rendered = stack.float().cpu().numpy()
            views = {"gt_aif": aif, "rt_render_l": rendered[:, :3],
                     "rt_render_r": rendered[:, 3:6]}
        monitor.set_outputs(_infer_outputs(net, stack, gt_depth, aif, views))
        monitor.compute_metrics()
        if save:
            monitor.save_images(f"{args['results_dir']}/results/", scene, idx)
    logging.info(f"Validate Depth Est on {scene}")
    monitor.logging(epoch, n)
    monitor.save_pth(args, scene, n, net)
    return monitor.metric_dict(n)


def _total_steps(args, n_train: int) -> int:
    """The cosine's T_max. anneal_over_steps: the optimiser steps of the
    run; otherwise the reference's epochs x samples, which keeps the LR
    near its peak (the scheduler steps once per batch)."""
    if args.get("anneal_over_steps"):
        return args["epochs"] * (n_train // args["bs"])
    return args["epochs"] * n_train


def data_parallel_ranks(bs: int, n_cards: int) -> int:
    """The largest divisor of bs that is at most the number of cards."""
    return max(d for d in range(1, min(n_cards, bs) + 1) if bs % d == 0)


def train(args, device="cuda", mesh=None) -> dict:
    """``--stage train``. Returns {"state", "start_epoch", "epochs_trained",
    "best_acc1", "val": [per-epoch metrics], "losses": [per step total],
    "loss_terms": [per step, every term of the loss],
    "steps": [per-step timings], "epoch_seconds": [per trained epoch]}:
    each step's timing holds the host's wait for the batch (s), the render
    and the train step (ms; CUDA events on the card); an epoch's seconds
    run from its loader's start to its last loss on the host.

    ``args["data_parallel"]`` on more than one card launches one rank per
    card (train_rank) and returns rank 0's results without "state", with
    "k2_launches" per rank; ``mesh`` is the rank's (parallel.mesh.Mesh)."""
    train_mode = args.get("train_mode", "dfdp")
    dev = resolve_device(device)
    if args.get("data_parallel") and mesh is None:
        n_cards = torch.cuda.device_count() if dev.type == "cuda" else 1
        n_data = data_parallel_ranks(args["bs"], n_cards)
        if n_data > 1:
            logging.info(f"data-parallel training over {n_data} devices")
            outs = launch(train_rank, n_data, device="cuda", args=(args,),
                          timeout=30 * 24 * 3600.0)
            return {**outs[0], "k2_launches": [o["k2_launches"] for o in outs]}
        logging.info("data_parallel requested but only one usable device; "
                     "running single-chip")
    chief = mesh is None or mesh.rank == 0
    wd = StallWatchdog(timeout_s=float(args.get("stall_timeout_s", 1800)))
    train_lens, test_lens = get_lens(args, device=dev)
    nyu_fs_train, nyu_train, val_set = get_dataset(args)
    wd.beat()
    logging.info(f"Totally {len(nyu_fs_train)} images for training, "
                 f"{len(val_set)} images for test.")

    n_views = getattr(train_lens, "n_views", 1)
    net = build_basenet(seed=0, device=dev, train=True, train_mode=train_mode,
                        n_views=n_views)
    state = create_dfdp_state(net, args["lr"],
                              _total_steps(args, len(nyu_fs_train)))
    pretrained = args["train"].get("dfdpnet_pretrained")
    if pretrained:
        try:
            path = ported_weights(pretrained)
        except FileNotFoundError as e:
            logging.warning(f"warm start skipped: {e}")
        else:
            from .utils.weights import load_state

            load_state(state.net, path)
            logging.info(f"warm start from {path}")
    step_fn = dfdp_train_step
    if mesh is not None:
        from .parallel.steps import make_sharded_dfdp_step

        broadcast_module(state.net)
        step_fn = make_sharded_dfdp_step(mesh, train_mode)
    box_set = get_depth_test_set(args)[0] if chief else None

    ckpt_out = args.get("ckpt_out")
    best_acc1 = -1.0
    resume_epoch, tc = 0, None
    state_dir = args.get("train_state_dir")
    if state_dir:
        tc = TrainCheckpointer(state_dir, max_to_keep=args.get("train_state_keep", 2))
        step = tc.restore_latest(state)
        if step is not None:
            resume_epoch = int(step)
            side = os.path.join(state_dir, "train_meta.json")
            if os.path.exists(side):
                try:
                    with open(side) as f:
                        best_acc1 = json.load(f).get("best_acc1", -1.0)
                except (json.JSONDecodeError, OSError):
                    logging.warning("train_meta.json unreadable; best-acc1 "
                                    "watermark resets (peak ckpt may be "
                                    "re-exported)")
            logging.info(f"resumed train state at epoch {resume_epoch} "
                         f"(best val acc1 so far {best_acc1:.4f})")
    # a banked export's own watermark wins over a lost or older train state,
    # so a restart can never overwrite a better export
    if ckpt_out:
        banked = read_ckpt_watermark(ckpt_out)
        if banked is not None and banked > best_acc1:
            best_acc1 = banked
            logging.info(f"seeded best-acc1 watermark {best_acc1:.4f} from "
                         f"banked checkpoint {ckpt_out}")

    def write_meta():
        if not state_dir or not chief:
            return
        tmp = os.path.join(state_dir, "train_meta.json.tmp")
        with open(tmp, "w") as f:
            json.dump({"best_acc1": best_acc1}, f)
        os.replace(tmp, os.path.join(state_dir, "train_meta.json"))

    wd.beat()
    out = {"state": state, "start_epoch": resume_epoch, "epochs_trained": 0,
           "val": [], "losses": [], "loss_terms": [], "steps": [],
           "epoch_seconds": []}
    for epoch in range(resume_epoch, args["epochs"] + 1):
        # epoch-keyed noise: the same draws whether or not the run resumed
        # (and per data rank: each renders other samples)
        rank_seed = 0 if mesh is None else 1_000_033 * mesh.data_index
        generator = torch.Generator(device=dev).manual_seed(1_000_003 + epoch
                                                            + rank_seed)
        wd.beat()
        if chief:
            val_metrics = validate(state.net, test_lens, val_set, "fs", args, epoch)
            out["val"].append(val_metrics)
            wd.beat()
            if n_views == 1:
                test_depth(state.net, box_set, dev, "box", epoch, args)
            elif epoch == resume_epoch:
                logging.info(MULTI_FOCUS_SKIP)
            wd.beat()
            if ckpt_out and val_metrics["acc1"] > best_acc1:
                best_acc1 = val_metrics["acc1"]
                save_inference_ckpt(ckpt_out, state.net)
                write_ckpt_watermark(ckpt_out, best_acc1)
                write_meta()
                logging.info(f"ckpt_out: saved epoch {epoch} "
                             f"(val acc1 {best_acc1:.4f}) -> {ckpt_out}")
            logging.info("")
        if mesh is not None:
            dist.barrier()
        if epoch == args["epochs"]:
            break

        dataset = nyu_fs_train if epoch <= args["epochs"] // 2 else nyu_train
        loader = DataLoader(dataset, batch_size=args["bs"], shuffle=True,
                            num_workers=4, drop_last=True, seed=epoch,
                            shard=None if mesh is None else (mesh.data_index,
                                                             mesh.n_data))
        epoch_loss, n_steps, t0 = 0.0, 0, time.perf_counter()
        pending, timing = [], []

        def drain():
            nonlocal epoch_loss
            for losses in pending:
                terms = {k: float(v) for k, v in losses.items()}
                if not all(np.isfinite(v) for v in terms.values()):
                    raise FloatingPointError(f"non-finite train loss {terms}")
                epoch_loss += terms["total"]
                out["losses"].append(terms["total"])
                out["loss_terms"].append(terms)
            pending.clear()
            wd.beat()

        batches = iter(loader)
        while True:
            t_wait = time.perf_counter()
            batch = next(batches, None)
            if batch is None:
                break
            t_wait = time.perf_counter() - t_wait
            m0 = trace.mark(dev)
            stack, depth_dev, aif_dev = _render_batch(train_lens, *batch,
                                                      generator, train=True)
            m1 = trace.mark(dev)
            losses = step_fn(state, stack, depth_dev,
                             aif_dev if train_mode == "deblur" else None)
            timing.append((t_wait, m0, m1, trace.mark(dev)))
            pending.append(losses)
            n_steps += 1
            if len(pending) >= 8:
                drain()
        drain()
        out["epoch_seconds"].append(time.perf_counter() - t0)
        out["steps"] += [{"data_wait_s": t_wait,
                          "render_ms": trace.elapsed_ms(m0, m1),
                          "train_step_ms": trace.elapsed_ms(m1, m2)}
                         for t_wait, m0, m1, m2 in timing]
        out["epochs_trained"] += 1
        logging.info(f"Epoch {epoch}: train loss {epoch_loss / max(n_steps, 1):.4f} "
                     f"({n_steps} steps, {out['epoch_seconds'][-1]:.1f}s)")
        wd.beat()
        if tc is not None and chief:
            tc.save(epoch + 1, state)
            tc.wait()
            write_meta()
        if mesh is not None:
            dist.barrier()
        elif tc is not None:
            wd.beat()
            rss = host_rss_gb()
            logging.info(f"host RSS {rss:.1f} GiB")
            if rss > float(args.get("max_rss_gb", 48)):
                logging.warning(
                    f"host RSS {rss:.1f} GiB exceeds max_rss_gb="
                    f"{args.get('max_rss_gb', 48)}: re-exec to reclaim it; "
                    f"auto-resume at epoch {epoch + 1}")
                tc.close()
                logging.shutdown()
                try:
                    os.execv(sys.executable, [sys.executable] + sys.argv)
                except OSError as e:
                    logging.basicConfig(level=logging.INFO)
                    logging.error(f"re-exec failed: {e}; continuing in-process")
    wd.close()
    if tc is not None:
        tc.close()
    out["best_acc1"] = best_acc1
    return out


def train_rank(rank, world, dev, args):
    """One rank of data-parallel training (launched by train)."""
    from .render import fused_conv

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    logging.basicConfig(level=logging.INFO if rank == 0 else logging.WARNING,
                        format="%(asctime)s - %(message)s")
    out = train(args, device=dev, mesh=make_mesh(world, 1))
    out.pop("state")
    return {**out, "k2_launches": fused_conv.launches}


def _depth_net(args, dev, n_views: int = 1):
    """The config's trained net (``args["train_mode"]``, ``n_views``), or an
    untrained one (with a warning) when the config names none. Returns
    (net, tag suffix)."""
    kw = dict(device=dev, train_mode=args.get("train_mode", "dfdp"),
              n_views=n_views)
    ckpt = args["train"].get("dfdpnet_pretrained")
    if ckpt:
        return build_basenet(ported_weights(ckpt), **kw), ""
    logging.warning("No pretrained DfDP checkpoint found - depth metrics "
                    "below come from an UNTRAINED net and are meaningless "
                    "(DP-image fidelity above is checkpoint-free). Train "
                    "one with --stage train or set train.dfdpnet_pretrained.")
    return build_basenet(seed=0, **kw), "-UNTRAINED(no ckpt)"


def run_eval(args: dict, stage: str = "sample", device="cuda",
             variant: str | None = None) -> dict:
    """``--stage sample`` (the bundled sample sets) or ``--stage full`` (the
    config's real test sets), rendering with ``variant`` (None for
    SDIRT_RENDER_VARIANT or the port's default); returns {"flat": [per-scene scores],
    "depth": {set: metrics}, "seconds": ...}."""
    if stage not in ("sample", "full"):
        raise ValueError(f"stage {stage!r}")
    dev = resolve_device(device)
    t0 = time.perf_counter()
    _, lens = get_lens(args, device=dev)
    full = stage == "full"
    flat_set = get_flat_test_set(args) if full else get_flat_sample_set(args)
    flat = test_dp_images(lens, flat_set, variant)
    t1 = time.perf_counter()
    n_views = getattr(lens, "n_views", 1)
    net, untrained = _depth_net(args, dev, n_views)
    depth = {}
    if n_views > 1:
        logging.info(MULTI_FOCUS_SKIP)
    else:
        sets = get_depth_test_set(args) if full else get_depth_sample_set(args)
        for tag, ds in zip(("box", "f2d", "casual"), sets):
            # logged (and images named) by the JAX app's scene tags
            scene = tag + ("" if full else "Sample") + untrained
            depth[tag] = test_depth(net, ds, dev, scene,
                                    args={**args, "save_ckpt": False})
            logging.info(f"depth {tag}{untrained}: {depth[tag]}")
    t2 = time.perf_counter()
    return {"flat": flat, "depth": depth,
            "seconds": {"render_part": t1 - t0, "depth_part": t2 - t1}}


def run_sample(args: dict, device="cuda", variant: str | None = None) -> dict:
    """``--stage sample`` on the config's sample sets."""
    return run_eval(args, "sample", device, variant)


def write_csv(result: dict, out_dir: str):
    os.makedirs(f"{out_dir}/DPimages", exist_ok=True)
    with open(f"{out_dir}/DPimages/res.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=FLAT_COLUMNS)
        w.writeheader()
        w.writerows(result["flat"])
    keys = tuple(next(iter(result["depth"].values()), DEPTH_METRICS))
    with open(f"{out_dir}/depth.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(("set",) + keys)
        for tag, m in result["depth"].items():
            w.writerow((tag,) + tuple(m[k] for k in keys))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--config", default="configs/dfdp_by_sdirt_rf50mm.yml")
    ap.add_argument("--stage", choices=("sample", "full", "train"),
                    default="sample")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None,
                    help="result folder (default ./results/<time>-Sdirt_torch)")
    ap.add_argument("--train-mode", choices=("dfdp", "deblur"), default="dfdp",
                    help="'deblur' adds the Mydeblur refinement head and its "
                         "depth_fix / aif loss terms")
    ap.add_argument("--save-images", action="store_true",
                    help="write each validation and test frame's RGB views "
                         "and JET depth maps under --out")
    ap.add_argument("--data-parallel", action="store_true",
                    help="train over one process per card (the largest divisor "
                         "of bs not above the card count), NCCL")
    cli = ap.parse_args(argv)
    resolve_device(cli.device)
    args = load_config(cli.config)
    out = cli.out or ("./results/" + datetime.now().strftime("%m%d-%H%M%S")
                      + "-Sdirt_torch")
    args.update(results_dir=out, train_mode=cli.train_mode, save_images=cli.save_images,
                data_parallel=cli.data_parallel or args.get("data_parallel", False))
    os.makedirs(out, exist_ok=True)
    set_logger(out)
    set_seed(123456)
    logging.info(f"Result folder: {out}")
    # full-f32 matrix products and convolutions (cuDNN allows TF32 by default)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if cli.stage == "train":
        return train(args, device=cli.device)
    result = run_eval(args, cli.stage, device=cli.device)
    flat = np.array([[r[k] for k in FLAT_COLUMNS[2:]] for r in result["flat"]])
    logging.info(f"Avg [psnr_l, psnr_r, ssim_l, ssim_r, perc_l, perc_r]: "
                 f"{flat.mean(0)}")
    write_csv(result, out)
    logging.info(f"results in {out}")
    return result


if __name__ == "__main__":
    main()
