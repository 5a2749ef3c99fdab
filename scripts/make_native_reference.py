#!/usr/bin/env python
"""The JAX package's native engine (sdirt_tpu/native: libpng + libjpeg
decode, Catmull-Rom / nearest resize) on the CPU, for chip_smoke.py's check
of the PyTorch port's native loader (sdirt_tpu_torch/native, zlib alone) on
the card's machine, which has no libpng, libjpeg or JAX.

  sdirt_tpu_torch/reference/native_decode_jax_cpu.npz

What it holds, for the flat l/r PNGs of real_sample_set/flat (8 files,
3 channels), the orbbec 16-bit depth PNG casual/orbbec/001/d.png (1 channel)
and two committed NYU JPEGs, decoded at 96x144 and 256x384 under NEAREST
and CUBIC:

  files                 the files, relative to the repository
  bits                  their bit depths (8 or 16)
  pick_<H>x<W>          2048 seeded flat pixel positions of an H x W image
  d<i>_<H>x<W>_<interp> file i's output at those positions, [C, 2048]
  d<i>_<H>x<W>_<interp>_sum   its float64 sum over each channel, [C]
  full<i>_<H>x<W>_<interp>    the whole output, for files FULL at 96x144

and ``CanonFlatSet(real_sample_set/flat, resize=(256, 384))`` under the
JAX loader's ``native`` engine: ``item<k>_<j>`` array j of item k at the
256x384 positions ([6, 2048] for the F/4 and F/20 views), ``_sum`` its
per-channel sum, and ``item<k>_2_full`` the depth map whole. Storing the
whole outputs would take ~20 MB; the positions and the sums keep the file
under 2 MB.

Usage:
  JAX_PLATFORMS=cpu python scripts/make_native_reference.py
"""

from __future__ import annotations

import glob
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np

OUT = os.path.join(ROOT, "sdirt_tpu_torch", "reference", "native_decode_jax_cpu.npz")
SIZES = ((96, 144), (256, 384))
INTERPS = ("nearest", "cubic")
N_PICK = 2048


def reference_files():
    """(path relative to the repository, channels) of every file decoded."""
    flat = sorted(glob.glob(os.path.join(ROOT, "real_sample_set", "flat", "**", "*.png"),
                            recursive=True))
    files = [(os.path.relpath(p, ROOT), 3) for p in flat]
    files.append((os.path.join("real_sample_set", "casual", "orbbec", "001", "d.png"), 1))
    nyu = os.path.join("sdirt_tpu_torch", "reference", "datasets", "nyu2_train")
    files += [(os.path.join(nyu, s, "0000.jpg"), 3) for s in ("scene_00", "scene_01")]
    return files


def picks(hw):
    return np.sort(np.random.default_rng(hw[0] * 10007 + hw[1]).choice(
        hw[0] * hw[1], N_PICK, replace=False)).astype(np.int32)


# files stored whole at 96x144: a flat view, the 16-bit depth map, a JPEG
FULL = (0, 8, 9)


def main():
    from sdirt_tpu import native
    from sdirt_tpu.dfdp import datasets as D

    files = reference_files()
    out = {"files": np.array([f for f, _ in files]),
           "bits": np.zeros(len(files), np.int32)}
    for hw in SIZES:
        out[f"pick_{hw[0]}x{hw[1]}"] = picks(hw)
    for i, (rel, channels) in enumerate(files):
        for hw in SIZES:
            pick = out[f"pick_{hw[0]}x{hw[1]}"]
            for name in INTERPS:
                interp = native.CUBIC if name == "cubic" else native.NEAREST
                img, bits = native.decode(os.path.join(ROOT, rel), hw, channels, interp,
                                          return_bit_depth=True)
                out["bits"][i] = bits
                key = f"d{i}_{hw[0]}x{hw[1]}_{name}"
                out[key] = img.reshape(channels, -1)[:, pick]
                out[f"{key}_sum"] = img.astype(np.float64).sum((1, 2))
                if i in FULL and hw == SIZES[0]:
                    out[f"full{i}_{hw[0]}x{hw[1]}_{name}"] = img
    D.set_image_engine("native")
    ds = D.CanonFlatSet(os.path.join(ROOT, "real_sample_set", "flat"), resize=SIZES[1])
    pick = out[f"pick_{SIZES[1][0]}x{SIZES[1][1]}"]
    for k in range(len(ds)):
        for j, arr in enumerate(ds[k]):
            arr = np.asarray(arr, np.float32)
            out[f"item{k}_{j}"] = arr.reshape(arr.shape[0], -1)[:, pick]
            out[f"item{k}_{j}_sum"] = arr.astype(np.float64).sum((1, 2))
            if j == 2:
                out[f"item{k}_{j}_full"] = arr
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT}: {len(files)} files, {len(ds)} CanonFlatSet items, "
          f"{os.path.getsize(OUT) / 1e6:.3f} MB")


if __name__ == "__main__":
    main()
