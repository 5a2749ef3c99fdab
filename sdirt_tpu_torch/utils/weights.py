"""Carry parameters across from the JAX package's Flax trees.

The exported ``.npz`` files (scripts/export_torch_weights.py) hold a Flax
tree flattened to ``"<collection>/<module path>/<leaf>"`` keys of float32
numpy arrays, e.g. ``"params/Dense_0/kernel"`` or
``"batch_stats/dfdp_net/Feature_0/BasicConv_0/BatchNorm_0/mean"``. The port's
modules carry the Flax module names as attribute names, so the mapping is by
name; only the leaves change:

  Dense kernel [in, out]                  -> Linear.weight [out, in]
  Conv kernel HWIO / DHWIO                -> Conv.weight OIHW / OIDHW
  ConvTranspose kernel (D)HWIO, SAME pad  -> ConvTranspose.weight I O (D)HW,
                                             spatially flipped (Flax applies
                                             it unflipped to the dilated input)
  BatchNorm scale / bias / mean / var     -> weight / bias / running_mean /
                                             running_var
  any other parameter (CAMModule's gamma) -> the parameter of that name
"""

from __future__ import annotations

import numpy as np
import torch

COLLECTIONS = ("params", "batch_stats")
_BN_LEAVES = {"scale": "weight", "bias": "bias", "mean": "running_mean",
              "var": "running_var"}
# parameters that keep their Flax name and layout
_PLAIN_LEAVES = ("gamma",)


def _kernel_to_torch(module: str, k: np.ndarray) -> np.ndarray:
    nd = k.ndim - 2
    if module.startswith("Dense"):
        return k.T
    if module.startswith("ConvTranspose"):
        k = np.flip(k, axis=tuple(range(nd)))
        return k.transpose(nd, nd + 1, *range(nd))
    if module.startswith("Conv"):
        return k.transpose(nd + 1, nd, *range(nd))
    raise KeyError(f"no kernel layout known for module {module}")


def _kernel_to_flax(module: str, w: np.ndarray) -> np.ndarray:
    nd = w.ndim - 2
    if module.startswith("Dense"):
        return w.T
    if module.startswith("ConvTranspose"):
        k = w.transpose(*range(2, nd + 2), 0, 1)
        return np.flip(k, axis=tuple(range(nd)))
    if module.startswith("Conv"):
        return w.transpose(*range(2, nd + 2), 1, 0)
    raise KeyError(f"no kernel layout known for module {module}")


def flax_to_torch(flat: dict) -> dict[str, torch.Tensor]:
    """Flat Flax tree (numpy leaves) -> PyTorch state dict (float32)."""
    out = {}
    for key, arr in flat.items():
        parts = key.split("/")
        if parts[0] in COLLECTIONS:
            parts = parts[1:]
        *path, leaf = parts
        module = path[-1] if path else ""
        arr = np.asarray(arr, np.float32)
        if leaf == "kernel":
            name, arr = "weight", _kernel_to_torch(module, arr)
        elif module.startswith("BatchNorm"):
            name = _BN_LEAVES[leaf]
        elif leaf == "bias" or leaf in _PLAIN_LEAVES:
            name = leaf
        else:
            raise KeyError(f"unknown Flax leaf {key}")
        out[".".join([*path, name])] = torch.from_numpy(
            np.ascontiguousarray(arr))
    return out


def torch_to_flax(state: dict) -> dict[str, np.ndarray]:
    """Inverse of flax_to_torch: PyTorch state dict -> flat Flax tree with
    ``params/`` and ``batch_stats/`` prefixes. BatchNorm's
    ``num_batches_tracked`` has no Flax counterpart and is dropped."""
    inv_bn = {v: k for k, v in _BN_LEAVES.items()}
    out = {}
    for key, t in state.items():
        *path, name = key.split(".")
        module = path[-1] if path else ""
        if name == "num_batches_tracked":
            continue
        arr = t.detach().cpu().float().numpy()
        coll = "params"
        if name == "weight" and not module.startswith("BatchNorm"):
            leaf, arr = "kernel", _kernel_to_flax(module, arr)
        elif module.startswith("BatchNorm"):
            leaf = inv_bn[name]
            if leaf in ("mean", "var"):
                coll = "batch_stats"
        else:
            leaf = name
        out["/".join([coll, *path, leaf])] = np.ascontiguousarray(arr)
    return out


def load_npz(path: str) -> dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def load_state(module: torch.nn.Module, tree) -> torch.nn.Module:
    """Load a flat Flax tree into ``module``: the path of an exported
    ``.npz``, or the tree itself as a dict of numpy leaves (strict: every
    parameter and running statistic must be present, and nothing else)."""
    state = flax_to_torch(load_npz(tree) if isinstance(tree, str) else tree)
    own = module.state_dict()
    for k, v in own.items():
        if k.endswith("num_batches_tracked"):
            state[k] = v
    module.load_state_dict(state, strict=True)
    return module
