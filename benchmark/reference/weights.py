"""Read the shipped ``.npz`` weight trees with the benchmark's own code.

A tree is a flat dict of float32 arrays keyed ``params/<module path>/<leaf>``
(and ``batch_stats/...`` for BatchNorm's running statistics). Dense kernels
are stored [in, out]; convolution kernels HWIO / DHWIO; transposed
convolution kernels (D)HWIO and applied unflipped, as Flax does.
"""

from __future__ import annotations

import numpy as np


def load_tree(path: str) -> dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: np.asarray(z[k], np.float32) for k in z.files}


def dense_stack(path: str) -> list[tuple[np.ndarray, np.ndarray]]:
    """[(kernel [in, out], bias [out]), ...] of ``Dense_0``, ``Dense_1``, ...
    in layer order."""
    tree = load_tree(path)
    layers = []
    while f"params/Dense_{len(layers)}/kernel" in tree:
        i = len(layers)
        layers.append((tree[f"params/Dense_{i}/kernel"], tree[f"params/Dense_{i}/bias"]))
    if not layers:
        raise ValueError(f"{path} holds no Dense layers")
    return layers
