"""The port's ``eval_depth_ckpt`` against scripts/eval_depth_ckpt.py on the
CPU: every synthetic style and the real sample sets at 128x192 with
--val-len 2, acc1 and MAE within 0.005 (the depth metrics' limit).
"""

import importlib.util
import io
import os
import re
import sys
from contextlib import redirect_stdout

import pytest
import torch

from sdirt_tpu_torch import eval_depth_ckpt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEPTH_TOL = 0.005


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test files at once on the machine's cores;
    this file's torch work keeps to two threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_main(argv, monkeypatch) -> str:
    spec = importlib.util.spec_from_file_location(
        "jax_eval_depth_ckpt", os.path.join(ROOT, "scripts", "eval_depth_ckpt.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", [mod.__name__, *argv])
    buf = io.StringIO()
    with redirect_stdout(buf):
        mod.main()
    return buf.getvalue()


def test_eval_depth_ckpt_matches_jax(monkeypatch):
    """Every synthetic style (the JAX package's scan render; the port's
    default fused render, K2's plain version on the CPU) and the real sets
    at 128x192, two validation scenes per style."""
    monkeypatch.chdir(ROOT)
    monkeypatch.setenv("SDIRT_RENDER_VARIANT", "scan")
    import cv2

    argv = ["--ckpt", "ckpt/rf50mm/Sdirt_best_acc1", "--res", "128", "192",
            "--val-len", "2"]
    # the port's scenes equal the JAX package's with OpenCV's IPP off
    ipp = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    try:
        text = _jax_main([*argv, "--cpu"], monkeypatch)
    finally:
        cv2.ipp.setUseIPP(ipp)
    ref = {m[0]: (float(m[1]), float(m[2])) for m in re.findall(
        r"^\[(v\d|real \w+)\] (?:val )?acc1 ([\d.]+)\s+mae ([\d.]+)", text, re.M)}
    assert len(ref) == 9, text
    monkeypatch.delenv("SDIRT_RENDER_VARIANT")
    got = eval_depth_ckpt.main([*argv, "--device", "cpu"])
    rows = {**{s: r for s, r in got["synthetic"].items()},
            **{f"real {t}": r for t, r in got["real"].items()}}
    assert set(rows) == set(ref)
    for k, (acc1, mae) in ref.items():
        assert abs(rows[k]["acc1"] - acc1) <= DEPTH_TOL, (k, rows[k], acc1)
        assert abs(rows[k]["mae"] - mae) <= DEPTH_TOL, (k, rows[k], mae)
        if k.startswith("v"):
            assert 0.0 < rows[k]["floor"] <= 1.0
