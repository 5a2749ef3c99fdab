"""What the loops share: the program's objects built from a configuration
(the lens with its surrogate, the scene set and its loader, the timed
render call), set-up phase notes, the percentile, and the reference's
render with the gaps it is judged by."""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..harness import ROOT, process_start
from ..reference import render as ref_render
from ..reference import weights as ref_weights


def path(rel: str) -> str:
    return os.path.join(ROOT, rel)


def full_precision():
    """Float32 GEMMs and convolutions with TF32 off, as the program's
    entry points set them."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def phase(ctx, name: str):
    """Note the seconds since process start at the end of a set-up phase."""
    ctx.phases[name] = time.time() - process_start()


def select_variant(config: dict, variant=None):
    """The render variant, set as the program reads it
    (SDIRT_RENDER_VARIANT): ``variant`` or the configuration's."""
    os.environ["SDIRT_RENDER_VARIANT"] = variant or config["render_variant"]


def build_lens(config: dict, device):
    """The program's surrogate lens of the configuration, weights loaded."""
    from sdirt_tpu_torch.psfnet.surrogate import PSFNetLens

    psf = config["psfnet"]
    lens = PSFNetLens(filename=path(config["lens"]["file"]),
                      sensor_res=tuple(config["res"]), kernel_size=psf["ks"],
                      model_name=psf["model"], device=device)
    lens.load_net(path(psf["weights"]))
    return lens


def scenes(config: dict, length: int, seed: int):
    """The program's procedural RGB-D set of the configuration's style."""
    from sdirt_tpu_torch.dfdp.datasets import SyntheticRGBD

    return SyntheticRGBD(resize=tuple(config["res"]), length=length, seed=seed,
                         style=config["data"]["style"])


def loader(dataset, bs: int, workers: int, seed: int, shuffle: bool):
    from sdirt_tpu_torch.dfdp.datasets import DataLoader

    return DataLoader(dataset, batch_size=bs, shuffle=shuffle,
                      num_workers=workers, drop_last=True, seed=seed)


def render_stack(lens, aif, depth, generator):
    """The trainer's noisy render of a host batch (the timed call)."""
    from sdirt_tpu_torch.dfdp_net import _render_batch

    return _render_batch(lens, aif, depth, generator, train=True)


def p95(values) -> float:
    return float(np.percentile(np.asarray(values, np.float64), 95))


def reference_render(config: dict, batches, device):
    """The reference's render of [(aif, depth, generator state)]."""
    psf = config["psfnet"]
    kind = "basis" if psf.get("basis_k") else "mlp"
    layers = ref_render.device_layers(ref_weights.dense_stack(path(psf["weights"])), device)
    return [ref_render.render_batch(layers, aif, depth, config["lens"], psf["ks"], kind,
                                    state, device)
            for aif, depth, state in batches]


def render_gaps(got, want) -> dict:
    """The widest and the mean absolute gap between program and reference
    stacks, over every value of every batch compared."""
    gaps = [(g.float() - w).abs() for g, w in zip(got, want)]
    return {"max_abs_gap": max(float(g.max()) for g in gaps),
            "mean_abs_gap": float(sum(g.double().sum() for g in gaps)
                                  / sum(g.numel() for g in gaps))}
