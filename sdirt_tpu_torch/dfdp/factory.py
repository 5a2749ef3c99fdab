"""Config-driven construction of the lens, the training mix and the real
test sets (PyTorch counterpart of sdirt_tpu/dfdp/factory.py).

The configs name orbax checkpoints (``./ckpt/<lens>/<name>``); the port reads
their exported copies, ``sdirt_tpu_torch/weights/<lens>/<name>.npz``
(scripts/export_torch_weights.py), or its own export ``<name>.npz`` where
one lies beside the name. A config's lens is a surrogate lens, optionally
re-stopped (``fnum``) and refocused (``focus_mm``), a thin lens
(``lens: thinlens``) or a multi-focus stack (``stack``: per-view
sub-configs). The NYU, FlyingThings3D and Middlebury loaders are not ported
yet (ROADMAP.md §1 item 1): the training mix is ``Synthetic`` only.

Unlike the JAX factory, which builds an untrained surrogate when the named
checkpoint is missing, the port raises (ROADMAP.md §3).
"""

from __future__ import annotations

import os

from .datasets import (CanonCasualSet, CanonDepthSet, CanonFlat2DepthSet,
                       CanonFlatSet, ConcatDataset, SyntheticRGBD)

WEIGHTS_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "weights")


def ported_weights(ckpt_path: str) -> str:
    """A config's checkpoint name -> the ``.npz`` the port loads: the name
    itself when it is an ``.npz``, ``<name>.npz`` when the port exported one
    there, else the exported copy ``weights/<lens>/<name>.npz``."""
    if ckpt_path.endswith(".npz"):
        if not os.path.exists(ckpt_path):
            raise FileNotFoundError(f"no checkpoint at {ckpt_path}")
        return ckpt_path
    if os.path.exists(ckpt_path + ".npz"):
        return ckpt_path + ".npz"
    lens, name = os.path.normpath(ckpt_path).split(os.sep)[-2:]
    path = os.path.join(WEIGHTS_DIR, lens, f"{name}.npz")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{ckpt_path} has no exported copy at {path}; export it with "
            "scripts/export_torch_weights.py")
    return path


def get_lens(args, device="cuda"):
    """(train lens, test lens) of the config, surrogates loaded. Per side:
    ``lens: thinlens`` builds a ThinLens (``foc_len``, ``fnum``,
    ``sensor_size``); a ``stack`` list builds a FocalStackLens of its
    sub-configs, each merged over the side's other keys, in order;
    otherwise a PSFNetLens re-stopped to ``fnum`` first, then refocused to
    ``focus_mm`` with its focus prior moved there (the order of the fit)."""
    from ..psfnet.surrogate import PSFNetLens

    def build(cfg):
        if cfg["lens"] == "thinlens":
            from ..psfnet.thinlens import ThinLens

            return ThinLens(foc_len=cfg["foc_len"], fnum=cfg["fnum"],
                            kernel_size=args["ks"],
                            sensor_size=[float(i) for i in cfg["sensor_size"]],
                            sensor_res=args["res"], device=device)
        if cfg.get("stack"):
            from ..psfnet.stack import FocalStackLens

            base = {k: v for k, v in cfg.items() if k != "stack"}
            return FocalStackLens([build({**base, **sub})
                                   for sub in cfg["stack"]])
        lens = PSFNetLens(filename=cfg["lens"], sensor_res=args["res"],
                          kernel_size=args["ks"],
                          model_name=cfg.get("psfnet_model", "mlp"),
                          device=device)
        if cfg.get("fnum"):
            lens.set_aperture(fnum=float(cfg["fnum"]))
        if cfg.get("focus_mm"):
            lens.refocus(float(cfg["focus_mm"]) + lens.d_sensor)
            lens.set_focus_prior(float(cfg["focus_mm"]))
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


NOT_PORTED_DATA = ("the {} loader is not ported yet (ROADMAP.md §1 item 1: it "
                   "waits for such data in the repository); use 'Synthetic'")


def get_dataset(args):
    """(first-half training set, second-half training set, validation set).
    The ``Synthetic`` mix trains on one set throughout."""
    res = args["res"]
    name, tname = args["train"]["dataset"], args["test"]["dataset"]
    for n in (name, tname):
        if n != "Synthetic":
            raise NotImplementedError(NOT_PORTED_DATA.format(n))
    style = args.get("synthetic_style", "v1")
    train_set = SyntheticRGBD(resize=res, length=args.get("synthetic_len", 64),
                              style=style)
    val_set = SyntheticRGBD(resize=res, length=args.get("synthetic_val_len", 4),
                            seed=999, train=False, style=style)
    return ConcatDataset(train_set), ConcatDataset(train_set), val_set


def get_depth_test_set(args):
    res = args["res"]
    return (CanonDepthSet(args["real_box_test"], resize=res),
            CanonFlat2DepthSet(args["real_flat_test"], resize=res),
            CanonCasualSet(args["real_casual_test"], resize=res))


def get_flat_test_set(args):
    return CanonFlatSet(args["real_flat_test"], resize=args["res"])
