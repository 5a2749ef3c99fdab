"""Distil a linear-head basis student (PSFMLPBasis) from a fitted PSFMLP
teacher on dense taps instead of ray tracing (PyTorch counterpart of
scripts/distill_basis_student.py).

  python -m sdirt_tpu_torch.distill_basis_student --out DIR \\
      [--student mlpb@256x32] [--teacher mlp@256] \\
      [--teacher-ckpt ckpt/rf50mm/F4_PSFNet_mlp@256] [--warm CKPT] \\
      [--iters 200000 --bs 8192 --lr 5e-5 --eval-every 20000 --ks 21] \\
      [--resume] [--device cuda|cpu]

Each step draws bs queries from the fit's distribution
(psfnet/train.py: draw_training_samples + training_points), takes the
teacher's raw f32 taps under no_grad as the target and makes one AdamW step
(cosine_annealing(lr, iters // 3)) of the student on their mean squared
error. Every ``--eval-every`` steps the student's ray-traced truth L1 / L2
is printed (psfnet/train.py:make_eval_fn: K1 through dp_psf_fused, 1024
points x 65536 rays, 16 K1 launches) and the train state saved
(``DIR/state``, utils/checkpoint.py:TrainCheckpointer); the student goes to
``DIR/psfnet_<student>.npz`` at the end. Step i draws from a generator
seeded from (0, i) and the evaluation after it from (0, iters + i + 1), as
the JAX script folds its key, so ``--resume`` replays the stream of an
unbroken run. ``--warm`` warm-starts the student from an exported
surrogate: a PSFMLP checkpoint of the same width fills the trunk
(PSFNetLens.load_net's partial load). Checkpoint names are read from their
exports (dfdp/factory.py:ported_weights).
"""

from __future__ import annotations

import argparse
import logging
import os
import time

import torch

from .dfdp.factory import ported_weights
from .psfnet.surrogate import PSFNetLens
from .psfnet.train import (create_train_state, draw_training_samples, fit_step,
                           make_eval_fn, training_points)
from .utils.checkpoint import TrainCheckpointer
from .utils.device import resolve_device

SEED = 0


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--lens", default="lenses/rf50mm/lens_web.json")
    ap.add_argument("--teacher", default="mlp@256")
    ap.add_argument("--teacher-ckpt", default="ckpt/rf50mm/F4_PSFNet_mlp@256")
    ap.add_argument("--student", default="mlpb@256x32")
    ap.add_argument("--warm", default=None,
                    help="student checkpoint to warm-start (trunk and head)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--iters", type=int, default=200000)
    ap.add_argument("--bs", type=int, default=8192)
    ap.add_argument("--lr", type=float, default=5e-5)
    ap.add_argument("--eval-every", type=int, default=20000)
    ap.add_argument("--ks", type=int, default=21)
    ap.add_argument("--resume", action="store_true",
                    help="resume the full train state from OUT/state")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def fold_in(seed: int, i: int) -> int:
    """The seed of draw ``i`` of a run seeded ``seed``."""
    return (seed * 1_000_003 + i) % (2 ** 63)


def generator(dev, seed: int, i: int) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(fold_in(seed, i))


def queries(lens, gen, bs: int):
    """bs queries [bs, 3] of the fit's distribution, on the lens's device."""
    samples = draw_training_samples(gen, bs, len(lens.foc_z_arr))
    return training_points(*samples, lens.foc_z_arr, lens.d_min, lens.d_max)[0].to(lens.device)


def make_distill_step(teacher_net, state, ks: int):
    """step(inp [bs, 3]) -> the loss (0-d tensor, not synchronised): the
    teacher's taps under no_grad, then one optimiser step of state.net on
    their mean squared error."""

    def step(inp):
        with torch.no_grad():
            gt = teacher_net(inp)
        return fit_step(state, inp, gt.reshape(-1, ks, ks))

    return step


def lenses(args, dev):
    """(teacher, student) PSFNetLens at 512x768, the teacher loaded and the
    student warm-started when ``--warm`` is given."""
    kw = dict(kernel_size=args.ks, sensor_res=(512, 768), device=dev)
    teacher = PSFNetLens(args.lens, model_name=args.teacher, **kw)
    teacher.load_net(ported_weights(args.teacher_ckpt))
    student = PSFNetLens(args.lens, model_name=args.student, **kw)
    if args.warm:
        student.load_net(ported_weights(args.warm))
    return teacher, student


def main(argv=None) -> dict:
    """Run the distillation; returns {"losses": [per step run here],
    "evals": [(step, l1, l2)], "start": the resumed step, "student": the
    saved file, "seconds": {"steps", "evals"}}."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    teacher, student = lenses(args, dev)
    teacher.net.eval()
    state = create_train_state(student.net, args.lr, args.iters)
    step = make_distill_step(teacher.net, state, args.ks)
    eval_fn = make_eval_fn(student, ks=args.ks)

    os.makedirs(args.out, exist_ok=True)
    ckptr = TrainCheckpointer(f"{args.out}/state")
    start = 0
    if args.resume:
        restored = ckptr.restore_latest(state)
        if restored is not None:
            start = restored
            print(f"resumed train state at iter {start}", flush=True)

    losses, evals = [], []
    t_steps = t_evals = 0.0
    t0 = t_mark = time.perf_counter()
    for i in range(start, args.iters):
        losses.append(step(queries(student, generator(dev, SEED, i), args.bs)))
        if (i + 1) % args.eval_every == 0:
            loss = float(losses[-1])
            t_eval = time.perf_counter()
            t_steps += t_eval - t_mark
            l1, l2 = (float(v) for v in eval_fn(
                state.net, generator(dev, SEED, args.iters + i + 1)))
            t_mark = time.perf_counter()
            t_evals += t_mark - t_eval
            evals.append((i + 1, l1, l2))
            print(f"iter {i + 1}: distill mse {loss:.3e}  truth L1 {l1:.6f}  "
                  f"L2 {l2:.3e}  ({time.perf_counter() - t0:.0f}s)", flush=True)
            ckptr.save(i + 1, state)
    losses = [float(v) for v in losses]
    t_steps += time.perf_counter() - t_mark
    student.net.eval()
    path = f"{args.out}/psfnet_{args.student}.npz"
    student.save_net(path)
    print(f"saved {path}")
    return {"losses": losses, "evals": evals, "start": start, "student": path,
            "seconds": {"steps": t_steps, "evals": t_evals}}


if __name__ == "__main__":
    main()
