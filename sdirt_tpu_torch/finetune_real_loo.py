"""Leave-one-scene-out fine-tuning of a DfDP depth net on the bundled real
capture sets (PyTorch counterpart of scripts/finetune_real_loo.py).

  python -m sdirt_tpu_torch.finetune_real_loo --ckpt ckpt/rf50mm/Sdirt_best_acc1 \\
      [--steps 300] [--lr 2e-5] [--batch 2] [--res 512 768] \\
      [--holdout-set] [--sets box f2d casual] [--save-all-ckpt NAME] \\
      [--out DIR] [--device cuda|cpu]

real_sample_set/ holds 19 scenes (box 5, f2d 2, casual 12): too few for a
train/test split, so every scene of ``--sets`` is held out in turn, the net
is fine-tuned on the other 18 and scored on the held-out scene only;
``--holdout-set`` holds out a whole set instead. ``--save-all-ckpt NAME``
also fine-tunes on all 19 scenes and writes the net to ``<out>/NAME.npz``
(the layout utils/weights.py:load_npz reads).

The augmentation is DP-aware: a captured pair flipped in x must also swap
its views (``hflip_dp``); vertical flips and photometric jitter applied to
both views keep the geometry. Batches and augmentation draw from a numpy
``Generator`` seeded per fold, as the JAX script's do.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import time
from datetime import datetime

import numpy as np
import torch

from .dfdp.basenet import build_basenet
from .dfdp.factory import get_depth_sample_set, ported_weights
from .dfdp.metrics import mask_accuracy_k, mask_mae
from .dfdp.train import create_dfdp_state, dfdp_infer, dfdp_train_step
from .eval_depth_ckpt import REAL_SETS
from .utils.checkpoint import save_inference_ckpt
from .utils.device import resolve_device


def load_all_scenes(res) -> list:
    """Every bundled real scene as (set tag, img [6, H, W], depth [1, H, W])."""
    scenes = []
    for ds, tag in zip(get_depth_sample_set({"res": tuple(res), **REAL_SETS}),
                       ("box", "f2d", "casual")):
        for i in range(len(ds)):
            img, depth = ds[i]
            scenes.append((tag, img.astype(np.float32), depth.astype(np.float32)))
    return scenes


def hflip_dp(img, depth):
    """Horizontal flip of a captured DP pair (img CHW stacked [l; r]): the
    mirrored left view becomes the right one and vice versa. An
    involution."""
    img = np.flip(img, 2)
    img = np.concatenate([img[3:], img[:3]], 0)
    return img, np.flip(depth, 2)


def augment(img, depth, rng):
    """DP-aware photometric + flip augmentation (CHW, img stacked [l; r])."""
    if rng.random() > 0.5:
        contrast = rng.uniform(0.75, 1.25)
        brightness = rng.uniform(-0.25, 0.25)
        img = np.clip(contrast * img + brightness, 0.0, 1.0)
    if rng.random() > 0.5:
        gamma = rng.uniform(1, 2) if rng.random() > 0.5 else rng.uniform(0.5, 1)
        img = img ** gamma
    if rng.random() > 0.5:                      # vertical flip: geometry-safe
        img, depth = np.flip(img, 1), np.flip(depth, 1)
    if rng.random() > 0.5:                      # horizontal flip: swap l<->r
        img, depth = hflip_dp(img, depth)
    return np.ascontiguousarray(img), np.ascontiguousarray(depth)


def finetune(base_net, train_scenes, args, seed: int):
    """``args.steps`` AdamW steps (cosine over them, ``args.lr``) of a copy
    of ``base_net`` on batches of ``args.batch`` augmented scenes drawn from
    ``np.random.default_rng(seed)``, on the net's device and in its dtype.
    Returns (net, per-step total losses)."""
    net = copy.deepcopy(base_net)
    p = next(net.parameters())
    state = create_dfdp_state(net, args.lr, args.steps)
    rng = np.random.default_rng(seed)
    losses = []
    for _ in range(args.steps):
        idx = rng.choice(len(train_scenes), size=args.batch,
                         replace=len(train_scenes) < args.batch)
        imgs, gts = [], []
        for j in idx:
            img, d = augment(train_scenes[j][1], train_scenes[j][2], rng)
            imgs.append(img)
            gts.append(d)
        step = dfdp_train_step(state, torch.from_numpy(np.stack(imgs)).to(p),
                               torch.from_numpy(np.stack(gts)).to(p))
        losses.append(step["total"])
    return state.net, [float(v) for v in losses]


def eval_scene(net, img, depth):
    """(acc1, MAE) of the net on one scene."""
    p = next(net.parameters())
    pred = dfdp_infer(net, torch.from_numpy(img[None]).to(p)).cpu().numpy()
    mask = depth[None] > 0
    return (float(mask_accuracy_k(pred, depth[None], 1, mask)),
            float(mask_mae(pred, depth[None], mask)))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--res", type=int, nargs=2, default=(512, 768))
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--lr", type=float, default=2e-5)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--holdout-set", action="store_true",
                    help="hold out a whole set instead of one scene")
    ap.add_argument("--sets", nargs="*", default=["box", "f2d", "casual"],
                    help="the sets whose scenes (or which, with --holdout-set) "
                         "are held out; training uses every other scene")
    ap.add_argument("--save-all-ckpt", default=None, metavar="NAME",
                    help="also fine-tune on all 19 scenes and write the net "
                         "to <out>/NAME.npz")
    ap.add_argument("--out", default=None,
                    help="output folder (default ./results/<time>-finetune_loo)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    base = build_basenet(ported_weights(args.ckpt), device=dev)

    scenes = load_all_scenes(args.res)
    print(f"loaded {len(scenes)} real scenes ({', '.join(t for t, _, _ in scenes)})",
          flush=True)
    zero_shot = [eval_scene(base, img, d) for _, img, d in scenes]
    if args.holdout_set:
        folds = [[i for i, s in enumerate(scenes) if s[0] == tag] for tag in args.sets]
    else:
        folds = [[i] for i, s in enumerate(scenes) if s[0] in args.sets]

    held, fold_losses = {}, []
    for fold in folds:
        train_scenes = [s for i, s in enumerate(scenes) if i not in fold]
        t0 = time.time()
        net, losses = finetune(base, train_scenes, args, seed=fold[0])
        fold_losses.append(losses)
        for i in fold:
            tag, img, d = scenes[i]
            held[i] = eval_scene(net, img, d)
            print(f"[fold {tag}/{i}] held-out acc1 {held[i][0]:.4f} mae "
                  f"{held[i][1]:.3f} (zero-shot {zero_shot[i][0]:.4f}/"
                  f"{zero_shot[i][1]:.3f}) [{time.time() - t0:.0f}s]", flush=True)
        del net

    summary = {}
    for tag in args.sets:
        idxs = [i for i, s in enumerate(scenes) if s[0] == tag]
        if not idxs or any(i not in held for i in idxs):
            continue
        row = summary[tag] = {
            "acc1": float(np.mean([held[i][0] for i in idxs])),
            "mae": float(np.mean([held[i][1] for i in idxs])),
            "zero_shot_acc1": float(np.mean([zero_shot[i][0] for i in idxs])),
            "zero_shot_mae": float(np.mean([zero_shot[i][1] for i in idxs]))}
        print(f"[loo {tag}] acc1 {row['acc1']:.4f} mae {row['mae']:.3f}  (zero-shot "
              f"acc1 {row['zero_shot_acc1']:.4f} mae {row['zero_shot_mae']:.3f})",
              flush=True)
        print(json.dumps({"metric": f"loo_{tag}_acc1", "value": row["acc1"],
                          "zero_shot": row["zero_shot_acc1"], "mae": row["mae"],
                          "steps": args.steps, "lr": args.lr}), flush=True)

    saved = None
    if args.save_all_ckpt:
        out = args.out or ("./results/" + datetime.now().strftime("%m%d-%H%M%S")
                           + "-finetune_loo")
        net, _ = finetune(base, scenes, args, seed=1234)
        saved = save_inference_ckpt(os.path.join(out, os.path.basename(args.save_all_ckpt)),
                                    net)
        print(f"saved all-scenes fine-tune -> {saved} (report the LOO numbers above "
              "as its estimate)", flush=True)
    return {"zero_shot": zero_shot, "held_out": held, "fold_losses": fold_losses,
            "summary": summary, "saved": saved}


if __name__ == "__main__":
    main()
