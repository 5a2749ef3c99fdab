"""Config-driven construction of the serve path's lens and sample sets
(PyTorch counterpart of sdirt_tpu/dfdp/factory.py).

The configs name orbax checkpoints (``./ckpt/<lens>/<name>``); the port reads
their exported copies, ``sdirt_tpu_torch/weights/<lens>/<name>.npz``
(scripts/export_torch_weights.py). Thin lenses, focal stacks, re-stopped
apertures and the training/full-test sets come with later slices.
"""

from __future__ import annotations

import os

from .datasets import (CanonCasualSet, CanonDepthSet, CanonFlat2DepthSet,
                       CanonFlatSet)

WEIGHTS_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "weights")


def ported_weights(ckpt_path: str) -> str:
    """``[./]ckpt/<lens>/<name>`` -> the exported ``.npz`` in the port."""
    lens, name = os.path.normpath(ckpt_path).split(os.sep)[-2:]
    path = os.path.join(WEIGHTS_DIR, lens, f"{name}.npz")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{ckpt_path} has no exported copy at {path}; export it with "
            "scripts/export_torch_weights.py")
    return path


def get_lens(args, device="cuda"):
    """(train lens, test lens) of the config, surrogates loaded."""
    from ..psfnet.surrogate import PSFNetLens

    def build(cfg):
        unported = {"stack", "fnum", "focus_mm"} & set(cfg)
        if cfg["lens"] == "thinlens" or unported:
            raise NotImplementedError(
                f"lens config {sorted(unported) or 'thinlens'} is not ported yet")
        lens = PSFNetLens(filename=cfg["lens"], sensor_res=args["res"],
                          kernel_size=args["ks"],
                          model_name=cfg.get("psfnet_model", "mlp"),
                          device=device)
        if cfg.get("psfnet_path"):
            lens.load_net(ported_weights(cfg["psfnet_path"]))
        return lens

    return build(args["train"]), build(args["test"])


def get_depth_sample_set(args):
    res = args["res"]
    return (CanonDepthSet(args["real_box_sample"], resize=res),
            CanonFlat2DepthSet(args["real_flat_sample"], resize=res),
            CanonCasualSet(args["real_casual_sample"], resize=res))


def get_flat_sample_set(args):
    return CanonFlatSet(args["real_flat_sample"], resize=args["res"])
