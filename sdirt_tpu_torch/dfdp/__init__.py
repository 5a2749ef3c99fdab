"""Depth from dual pixels: the depth net, its training and evaluation, the
datasets.

The JAX package's names are re-exported lazily (PEP 562): an eager import
would pull the depth net and the training modules (and through
``dfdp.train`` the PSF fit's) into every loader-only import
(``dfdp.datasets``, ``dfdp.cvops``).
"""

_EXPORTS = {
    "Basenet": "basenet", "compute_loss": "basenet", "linear_depth": "basenet",
    "ResultsMonitor": "monitor", "select_focus_dist": "monitor",
    "create_dfdp_state": "train", "dfdp_infer": "train", "dfdp_train_step": "train",
}


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        value = getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
