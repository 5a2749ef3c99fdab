#!/usr/bin/env python
"""Reference of the lens-design demo, from the JAX package on the CPU, for
the PyTorch port's check on the card (chip_smoke.py).

Runs ``scripts/demo_lens_design.py`` at its defaults (300 steps, spp 256,
perturbation 0.002, seed 0) on the in-repo rf50mm, and stores its own
random draws with its tables, so the port can run on the same numbers:

  sdirt_tpu_torch/reference/lens_design_jax_cpu.npz
      pupil_<i> [spp, 2]   the pupil samples of wavelength i (the demo's
                           key PRNGKey(seed + i), sampling.sample_disk)
      perturb_<j>          perturb_stack's five normal draws (c, k, ai, d,
                           r) from PRNGKey(seed + 100)
      nominal, detuned, recovered [3]  the RMS spot table (um per field),
                           as rms_table returns it
      ok                   1 when the demo printed RECOVERY OK

Usage (about 40 seconds on 8 CPU cores):
  JAX_PLATFORMS=cpu python scripts/make_lens_design_reference.py
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np

OUT = os.path.join(ROOT, "sdirt_tpu_torch", "reference", "lens_design_jax_cpu.npz")
LENS = "./lenses/rf50mm/lens_web.json"
SEED, SPP = 0, 256


def jax_demo():
    spec = importlib.util.spec_from_file_location(
        "jax_demo_lens_design", os.path.join(ROOT, "scripts", "demo_lens_design.py"))
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    return demo


def jax_draws(seed: int = SEED, spp: int = SPP) -> dict:
    """The demo's draws: its pupil samples per wavelength and its
    perturbation normals, as its keys give them."""
    import jax

    from sdirt_tpu.optics.lens import Lens
    from sdirt_tpu.optics.sampling import sample_disk

    lens = Lens(os.path.join(ROOT, LENS), sensor_res=(512, 768))
    _, pupilr = lens.entrance_pupil()
    out = {f"pupil_{i}": np.asarray(sample_disk(jax.random.PRNGKey(seed + i), (spp,), pupilr))
           for i in range(3)}
    keys = jax.random.split(jax.random.PRNGKey(seed + 100), 5)
    s = lens.stack.num_surfaces
    shapes = ((s,), (s,), tuple(lens.stack.ai.shape), (s,), (s,))
    for j, (k, sh) in enumerate(zip(keys, shapes)):
        out[f"perturb_{j}"] = np.asarray(jax.random.normal(k, sh))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    demo = jax_demo()
    tables = []
    rms_table = demo.rms_table
    demo.rms_table = lambda *a: tables.append(rms_table(*a)) or tables[-1]
    printed = io.StringIO()
    argv0 = sys.argv
    sys.argv = ["demo_lens_design.py", "--lens", LENS, "--cpu"]
    try:
        with contextlib.redirect_stdout(printed):
            rc = demo.main()
    finally:
        sys.argv = argv0
    print(printed.getvalue())
    nominal, detuned, recovered = tables
    np.savez(args.out, **jax_draws(), nominal=nominal, detuned=detuned,
             recovered=recovered, ok=np.array(int(rc == 0)))
    print(args.out)


if __name__ == "__main__":
    main()
