#!/usr/bin/env python
"""Reference numbers of the rf35mm student gate, from the JAX package on the
CPU, for the PyTorch port's tests and its check on the card
(tests/test_torch_distill.py, chip_smoke.py).

The JAX script scripts/gate_rf35_student.py is run as it is, through its own
``render_pairs`` and ``agreement_db``, on the repository's
real_sample_set/flat (the script itself reads a copy outside the
repository), at 512x768 and at 128x192:

  * the rf50mm calibration: w256 ``fused_int8`` against w512 ``scan_f32``;
  * run ``mlp``: the rf35mm ``F4_PSFNet_mlp@256`` at the script's default
    variants (fused, fused_int8);
  * run ``mlpb``: the promoted rf35mm ``F4_PSFNet_mlpb@256x48`` through
    ``basis``, ``scan`` and ``scan_f32`` (the script's scan with the network
    in f32: the bf16 scan of a linear-head net carries bf16 rounding noise,
    which XLA's CPU backend and torch round differently);

each student's agreement (PSNR per view against the rf35mm w512 teacher's
``scan_f32`` render) and its PASS / FAIL verdict at the default margin:

  sdirt_tpu_torch/reference/student_gate_jax_cpu.json

Usage (about 15 minutes on 8 CPU cores):
  JAX_PLATFORMS=cpu python scripts/make_student_gate_reference.py
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

OUT = os.path.join(ROOT, "sdirt_tpu_torch", "reference", "student_gate_jax_cpu.json")
FLAT = os.path.join(ROOT, "real_sample_set", "flat")
RUNS = {"mlp": ("mlp@256", "ckpt/rf35mm/F4_PSFNet_mlp@256", ("fused", "fused_int8")),
        "mlpb": ("mlpb@256x48", "ckpt/rf35mm/F4_PSFNet_mlpb@256x48",
                 ("basis", "scan", "scan_f32"))}
RESOLUTIONS = ((512, 768), (128, 192))
LIMIT, MARGIN = 4, 1.0


def _gate_script():
    spec = importlib.util.spec_from_file_location(
        "jax_gate_rf35_student", os.path.join(ROOT, "scripts", "gate_rf35_student.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def one_resolution(gate, res):
    from sdirt_tpu.dfdp.datasets import CanonFlatSet
    from sdirt_tpu.psfnet.surrogate import PSFNetLens

    def lens(path, model, ckpt):
        out = PSFNetLens(os.path.join(ROOT, path), model_name=model,
                         kernel_size=21, sensor_res=res)
        out.load_net(os.path.join(ROOT, ckpt))
        return out

    flat_set = CanonFlatSet(FLAT, resize=res)
    t0 = time.perf_counter()
    ref = gate.render_pairs(lens(gate.RF50, "mlp", "ckpt/rf50mm/F4_PSFNet_mlp"),
                            flat_set, "scan_f32", LIMIT)
    stu = gate.render_pairs(lens(gate.RF50, "mlp@256", "ckpt/rf50mm/F4_PSFNet_mlp@256"),
                            flat_set, "fused_int8", LIMIT)
    precedent = gate.agreement_db(stu, ref)
    print(f"{res} calibration {precedent}", flush=True)
    ref35 = gate.render_pairs(lens(gate.RF35, "mlp", "ckpt/rf35mm/F4_PSFNet_mlp"),
                              flat_set, "scan_f32", LIMIT)
    bar = (precedent[0] - MARGIN, precedent[1] - MARGIN)
    runs = {}
    for name, (model, ckpt, variants) in RUNS.items():
        student = lens(gate.RF35, model, ckpt)
        rows = {}
        for v in variants:
            al, ar = gate.agreement_db(gate.render_pairs(student, flat_set, v, LIMIT),
                                       ref35)
            rows[v] = {"agree_l": al, "agree_r": ar,
                       "verdict": "PASS" if (al >= bar[0] and ar >= bar[1]) else "FAIL"}
            print(f"{res} {name} {v} {rows[v]}", flush=True)
        runs[name] = {"student": model, "student_ckpt": ckpt, "rows": rows}
    return {"calibration": {"psnr_l": precedent[0], "psnr_r": precedent[1]},
            "bar": list(bar), "runs": runs, "seconds": time.perf_counter() - t0}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    gate = _gate_script()
    out = {
        "what": "scripts/gate_rf35_student.py's render_pairs + agreement_db on "
                "real_sample_set/flat: rf50mm calibration, the rf35mm mlp@256 "
                "(fused, fused_int8) and mlpb@256x48 (basis, scan, scan_f32) students",
        "limit": LIMIT, "margin": MARGIN, "backend": jax.default_backend(),
        "jax": jax.__version__,
        "command": "JAX_PLATFORMS=cpu python scripts/make_student_gate_reference.py",
    }
    for res in RESOLUTIONS:
        out[f"{res[0]}x{res[1]}"] = one_resolution(gate, res)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
