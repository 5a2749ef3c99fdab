"""Data-preparation tools: Middlebury PFM disparity -> 16-bit depth PNG
(PyTorch port's counterpart of sdirt_tpu/dfdp/data_tools.py, with the port's
PNG writer in place of cv2.imwrite).

depth [mm] = baseline * f / (disp * pfm_scale + doffs), written as a uint16
PNG that the Middlebury loader reads back in millimetres.

  python -m sdirt_tpu_torch.dfdp.data_tools [ROOT]   # ./Middlebury2014
"""

from __future__ import annotations

import re
from glob import glob

import numpy as np

from ..utils.png import write_png


def read_pfm(path: str) -> tuple[np.ndarray, float]:
    """Parse a PFM file (http://davis.lbl.gov/Manuals/NETPBM/doc/pfm.html).

    Returns (data [H, W] or [H, W, 3], scale). Rows are bottom-up in the file
    and returned top-down.
    """
    with open(path, "rb") as f:
        header = f.readline().decode().rstrip()
        if header not in ("PF", "Pf"):
            raise ValueError(f"Not a PFM file: {path}")
        channels = 3 if header == "PF" else 1
        m = re.match(r"^(\d+)\s(\d+)\s*$", f.readline().decode())
        if not m:
            raise ValueError("Malformed PFM header.")
        width, height = map(int, m.groups())
        scale = float(f.readline().decode().rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.frombuffer(f.read(), dtype=endian + "f4")
    shape = (height, width, 3) if channels == 3 else (height, width)
    return np.flipud(data.reshape(shape)).copy(), abs(scale)


def read_middlebury_calib(path: str) -> tuple[float, float, float]:
    """(focal_px, doffs, baseline_mm) from a Middlebury calib.txt."""
    with open(path) as fh:
        lines = fh.readlines()
    focal = float(re.findall(r"\d+\.\d+", lines[0])[0])
    try:
        doffs = float(re.findall(r"\d+\.\d+", lines[2])[0])
    except IndexError:
        doffs = float(re.findall(r"\d+", lines[2])[0])
    baseline = float(re.findall(r"\d+\.\d+", lines[3])[0])
    return focal, doffs, baseline


def process_pfm(scene_dir: str) -> np.ndarray:
    """Convert {scene}/disp0.pfm + calib.txt -> {scene}/depth.png [mm,
    uint16]; returns the depth in mm before rounding."""
    disp, scale = read_pfm(f"{scene_dir}/disp0.pfm")
    disp = disp * scale
    focal, doffs, baseline = read_middlebury_calib(f"{scene_dir}/calib.txt")
    depth = baseline * focal / (disp + doffs)   # [mm]
    write_png(f"{scene_dir}/depth.png", np.round(depth).astype(np.uint16))
    return depth


def process_middlebury(root: str) -> None:
    for scene in glob(f"{root}/*"):
        process_pfm(scene)


if __name__ == "__main__":
    import sys

    process_middlebury(sys.argv[1] if len(sys.argv) > 1 else "./Middlebury2014")
