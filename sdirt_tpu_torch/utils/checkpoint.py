"""Checkpoints of the port: inference exports, their best-acc1 watermark,
and the resumable train state (PyTorch counterpart of
sdirt_tpu/utils/checkpoint.py).

  * An inference checkpoint is the net's parameters AND BatchNorm running
    statistics as a flat Flax-key ``.npz`` (utils/weights.py), the layout
    ``build_basenet`` and ``--stage sample`` load; ``path`` names it with or
    without the ``.npz`` suffix.
  * Its watermark is the validation acc1 it was exported at, in the sidecar
    ``<checkpoint>.meta.json`` (``{"best_acc1": x}``), so that a restart can
    never overwrite a banked peak with a worse net.
  * ``TrainCheckpointer`` keeps the full train state (net, optimiser,
    scheduler, step) under a directory, one ``torch.save`` file per step,
    the newest ``max_to_keep`` kept.

Every file is written to a temporary name and renamed into place.
"""

from __future__ import annotations

import glob
import json
import os

import numpy as np
import torch

from .weights import load_state, torch_to_flax


def ckpt_file(path: str) -> str:
    """The ``.npz`` file of an inference checkpoint named ``path``."""
    path = os.path.abspath(path)
    return path if path.endswith(".npz") else path + ".npz"


def _watermark_path(path: str) -> str:
    return ckpt_file(path) + ".meta.json"


def write_ckpt_watermark(path: str, best_acc1: float) -> None:
    """Record the validation acc1 the checkpoint at ``path`` was exported
    at (atomic)."""
    sidecar = _watermark_path(path)
    with open(sidecar + ".tmp", "w") as f:
        json.dump({"best_acc1": float(best_acc1)}, f)
    os.replace(sidecar + ".tmp", sidecar)


def read_ckpt_watermark(path: str):
    """The acc1 the checkpoint at ``path`` was exported at, or None when the
    sidecar is absent or unreadable."""
    try:
        with open(_watermark_path(path)) as f:
            return float(json.load(f)["best_acc1"])
    except (OSError, ValueError, KeyError, TypeError):
        return None


def save_inference_ckpt(path: str, net: torch.nn.Module) -> str:
    """Export the net (parameters and BN running statistics) to
    ``<path>.npz``; returns the file written."""
    out = ckpt_file(path)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = out[:-len(".npz")] + ".tmp.npz"
    np.savez(tmp, **torch_to_flax(net.state_dict()))
    os.replace(tmp, out)
    return out


def restore_inference_ckpt(path: str, net: torch.nn.Module) -> torch.nn.Module:
    """Load an inference checkpoint into ``net`` (strict)."""
    return load_state(net, ckpt_file(path))


class TrainCheckpointer:
    """The full train state under ``directory``: ``state`` is any object
    with ``net``, ``opt``, ``sched`` and ``step`` attributes."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _steps(self):
        names = glob.glob(os.path.join(self.directory, "step_*.pt"))
        return sorted(int(os.path.basename(n)[5:-3]) for n in names)

    def save(self, step: int, state) -> None:
        path = os.path.join(self.directory, f"step_{step}.pt")
        torch.save({"net": state.net.state_dict(), "opt": state.opt.state_dict(),
                    "sched": state.sched.state_dict(), "step": state.step},
                   path + ".tmp")
        os.replace(path + ".tmp", path)
        for old in self._steps()[:-self.max_to_keep]:
            os.remove(os.path.join(self.directory, f"step_{old}.pt"))

    def restore_latest(self, state):
        """Restore the newest checkpoint into ``state`` in place; returns its
        step, or None when the directory holds none."""
        steps = self._steps()
        if not steps:
            return None
        ckpt = torch.load(os.path.join(self.directory, f"step_{steps[-1]}.pt"),
                          map_location=next(state.net.parameters()).device)
        state.net.load_state_dict(ckpt["net"])
        state.opt.load_state_dict(ckpt["opt"])
        state.sched.load_state_dict(ckpt["sched"])
        state.step = ckpt["step"]
        return steps[-1]

    def wait(self) -> None:
        """Saves are synchronous; kept for the JAX checkpointer's interface."""

    def close(self) -> None:
        """Nothing to release; kept for the JAX checkpointer's interface."""
