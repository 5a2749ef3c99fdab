"""Experiment configs (configs/*.yml), read as apps/dfdp_net.py reads them."""

from __future__ import annotations

import yaml


def load_config(path: str) -> dict:
    """The config with ``res`` a tuple and ``lr`` a float."""
    with open(path) as f:
        args = yaml.safe_load(f)
    args["res"] = tuple(args["res"])
    args["lr"] = float(args["lr"])
    return args
