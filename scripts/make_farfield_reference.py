#!/usr/bin/env python
"""Reference numbers of the F/1.8 ks-35 serve path and of the far-field A/B,
from the JAX package on the CPU, for the PyTorch port's checks
(chip_smoke.py phases 14-15, tests/test_torch_farfield.py).

  stage_sample_f18_jax_cpu.json   ``apps/dfdp_net.py --stage sample`` on a
      copy of configs/dfdp_f18_farfield_256.yml that names the shipped
      depth net (``train.dfdpnet_pretrained: ./ckpt/rf50mm/
      Sdirt_f18_farfield``): the shipped config names none, and an
      untrained net's depth could never agree across the two packages.
  eval_farfield_ab_jax_cpu.json   ``scripts/eval_farfield_ab.py`` with the
      f4 (Sdirt_f4_farfield + F4_PSFNet_mlp, ks 21) and f18
      (Sdirt_f18_farfield + F18_PSFNet_mlp_ks35, ks 35, F/1.8) arms, on 16
      v2 validation scenes at 256x384 ("full") and on 2 at 128x192
      ("small", the CPU test's size).

Both render with the JAX ``scan`` variant; the A/B runs with OpenCV's IPP
off, so that its SyntheticRGBD scenes equal the port's.

Usage:
  JAX_PLATFORMS=cpu python scripts/make_farfield_reference.py [--only sample|ab]
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import yaml

REF_DIR = os.path.join(ROOT, "sdirt_tpu_torch", "reference")
F18_CONFIG = "configs/dfdp_f18_farfield_256.yml"
F18_NET = "./ckpt/rf50mm/Sdirt_f18_farfield"
SAMPLE_JSON = os.path.join(REF_DIR, "stage_sample_f18_jax_cpu.json")
AB_JSON = os.path.join(REF_DIR, "eval_farfield_ab_jax_cpu.json")
ARMS = (("f4", "ckpt/rf50mm/Sdirt_f4_farfield", "ckpt/rf50mm/F4_PSFNet_mlp", "21"),
        ("f18", "ckpt/rf50mm/Sdirt_f18_farfield",
         "ckpt/rf50mm/F18_PSFNet_mlp_ks35", "35"))
AB_RUNS = {"small": {"res": (128, 192), "val_len": 2},
           "full": {"res": (256, 384), "val_len": 16}}
AB_KEYS = ("acc1", "mae", "far_acc1", "far_mae", "near_acc1")


def with_depth_net(config: str, net: str, out_dir: str) -> str:
    """A copy of ``config`` under ``out_dir`` whose train.dfdpnet_pretrained
    names ``net``; returns its path."""
    with open(os.path.join(ROOT, config)) as f:
        args = yaml.safe_load(f)
    args["train"]["dfdpnet_pretrained"] = net
    path = os.path.join(out_dir, os.path.basename(config))
    with open(path, "w") as f:
        yaml.safe_dump(args, f, sort_keys=False)
    return path


def stage_sample_f18() -> dict:
    from export_torch_weights import parse_stage_sample_log

    with tempfile.TemporaryDirectory() as tmp:
        cfg = with_depth_net(F18_CONFIG, F18_NET, tmp)
        env = dict(os.environ, JAX_PLATFORMS="cpu", SDIRT_RENDER_VARIANT="scan")
        run = subprocess.run([sys.executable, "apps/dfdp_net.py", "--stage",
                              "sample", "--config", cfg], cwd=ROOT, env=env,
                             capture_output=True, text=True, check=True)
    ref = parse_stage_sample_log(run.stdout + run.stderr, F18_CONFIG)
    ref["command"] = ("JAX_PLATFORMS=cpu SDIRT_RENDER_VARIANT=scan python "
                      f"apps/dfdp_net.py --stage sample --config <copy of "
                      f"{F18_CONFIG} with train.dfdpnet_pretrained: {F18_NET}>")
    ref["dfdpnet_pretrained"] = F18_NET
    return ref


def parse_ab_table(text: str) -> dict:
    """The closing table of scripts/eval_farfield_ab.py -> {arm: metrics}."""
    lines = text.splitlines()
    start = next(i for i, ln in enumerate(lines) if ln.startswith("arm "))
    rows = {}
    for ln in lines[start + 1:]:
        parts = ln.split()
        if len(parts) == 1 + len(AB_KEYS):
            rows[parts[0]] = dict(zip(AB_KEYS, map(float, parts[1:])))
    return rows


def eval_farfield_ab(res, val_len) -> dict:
    """scripts/eval_farfield_ab.py in this process (OpenCV's IPP off)."""
    import cv2

    cv2.ipp.setUseIPP(False)
    spec = importlib.util.spec_from_file_location(
        "jax_eval_farfield_ab", os.path.join(ROOT, "scripts", "eval_farfield_ab.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    argv = ["eval_farfield_ab.py", "--res", *map(str, res), "--val-len",
            str(val_len)]
    for arm in ARMS:
        argv += ["--arm", *arm]
    out = io.StringIO()
    old_argv, old_cwd = sys.argv, os.getcwd()
    try:
        sys.argv = argv
        os.chdir(ROOT)
        with contextlib.redirect_stdout(out):
            mod.main()
    finally:
        sys.argv = old_argv
        os.chdir(old_cwd)
    return {"argv": argv[1:], "arms": parse_ab_table(out.getvalue())}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--only", choices=("sample", "ab"))
    args = ap.parse_args(argv)
    os.environ["SDIRT_RENDER_VARIANT"] = "scan"
    import jax

    jax.config.update("jax_platforms", "cpu")
    if args.only in (None, "sample"):
        ref = stage_sample_f18()
        with open(SAMPLE_JSON, "w") as f:
            json.dump(ref, f, indent=1)
            f.write("\n")
        print(SAMPLE_JSON, json.dumps(ref["depth"]))
    if args.only in (None, "ab"):
        out = {"what": "scripts/eval_farfield_ab.py, arms f4 and f18, on "
                       "SyntheticRGBD v2 validation scenes (seed 999), JAX "
                       "scan render, OpenCV IPP off",
               "command": "JAX_PLATFORMS=cpu python scripts/make_farfield_reference.py",
               "jax": jax.__version__}
        for name, run in AB_RUNS.items():
            out[name] = {"res": list(run["res"]), "val_len": run["val_len"],
                         **eval_farfield_ab(run["res"], run["val_len"])}
            print(name, json.dumps(out[name]["arms"]), flush=True)
        with open(AB_JSON, "w") as f:
            json.dump(out, f, indent=1)
            f.write("\n")
        print(AB_JSON)


if __name__ == "__main__":
    main()
