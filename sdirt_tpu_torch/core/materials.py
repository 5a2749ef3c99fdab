"""Glass catalog and refractive-index evaluation (a copy of
sdirt_tpu/core/materials.py, which is numpy-only; the port keeps its own copy
so that it imports nothing of the JAX package).

Host-side, pure numpy: dispersion is evaluated once per (surface, wavelength)
at lens-build time and handed to the trace as per-surface refraction ratios.

Parity source: /root/reference/deeplens/basics.py:42-158 (tables, public glass
catalog data) and :299-380 (Sellmeier / Schott / Cauchy evaluation, n/V string
parsing).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

# [nD, Abbe V] — used for Cauchy (A, B) fallback
MATERIAL_TABLE = {
    "vacuum": [1.0, math.inf],
    "air": [1.0, math.inf],
    "occluder": [1.0, math.inf],
    "f2": [1.620, 36.37],
    "f5": [1.6034, 38.03],
    "bk1": [1.5101, 63.47],
    "bk7": [1.5168, 64.17],
    "bk10": [1.49780, 66.954],
    "kzfs1": [1.6131, 44.339],
    "laf20": [1.6825, 48.201],
    "lafn7": [1.7495, 34.951],
    "n-baf10": [1.67003, 47.11],
    "n-bk7": [1.51680, 64.17],
    "n-lak34": [1.75500, 52.30],
    "n-pk51": [1.53100, 56.00],
    "n-pk52": [1.49700, 81.63],
    "n-balf4": [1.57960, 53.86],
    "n-ssk2": [1.62229, 53.27],
    "n-sf57": [1.84666, 23.78],
    "n-sf10": [1.72828, 28.53],
    "sf5": [1.67270, 32.21],
    "sf11": [1.87450, 25.68],
    "n-bak4": [1.56883, 55.98],
    "coc": [1.5337, 56.22],
    "pmma": [1.491756, 58.00],
    "ps": [1.5904, 30.87],
    "pc": [1.5855, 29.91],
    "okp4ht": [1.6328, 23.34],
    "okp4": [1.6328, 23.34],
    "apl5014cl": [1.5445, 55.987],
    "d-k59": [1.5175, 63.50],
    "sk1": [1.61030, 56.712],
    "sk16": [1.62040, 60.324],
    "ssk4": [1.61770, 55.116],
    "b270": [1.52290, 58.50],
    "s-nph1": [1.8078, 22.76],
    "hk51": [1.5501, 58.64],
    "d-zk3": [1.5891, 61.15],
    "flint": [1.6200, 36.37],
    "polycarb": [1.58547, 29.91],
    "polystyr": [1.59048, 30.87],
}

# k1, l1, k2, l2, k3, l3
SELLMEIER_TABLE = {
    "vacuum": [0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
    "air": [0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
    "occluder": [0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
    "f2": [1.3453, 9.9774e-3, 2.0907e-1, 4.7045e-2, 9.3736e-1, 1.1188e2],
    "f5": [1.3104, 9.5863e-3, 1.9603e-1, 4.5762e-2, 9.6612e-1, 1.1501e2],
    "bk1": [1.0425, 6.1656e-3, 2.0838e-1, 2.1215e-2, 9.8014e-1, 1.0906e2],
    "bk7": [1.0396, 6.0006e-3, 2.3179e-1, 2.0017e-2, 1.0104, 1.0356e2],
    "sf11": [1.7385, 1.3607e-2, 3.1117e-1, 6.1596e-2, 1.1749, 1.2192e2],
    "kzfs1": [1.3661, 8.7316e-3, 1.8204e-1, 3.8983e-2, 8.6431e-1, 6.2939e1],
    "laf20": [1.6510, 9.7050e-3, 1.1847e-1, 4.2892e-2, 1.1154, 1.1405e2],
    "lafn7": [1.6684, 1.0316e-2, 2.9851e-1, 4.6922e-2, 1.0774, 8.2508e1],
    "n-bk7": [1.0396, 6.0006e-3, 2.3179e-1, 2.0017e-2, 1.0104, 1.0356e2],
    "n-lak34": [1.2666, 5.8928e-3, 6.6592e-1, 1.9751e-2, 1.1247, 78.889],
    "n-pk51": [1.1516, 5.8556e-3, 1.5323e-1, 1.9407e-2, 7.8562e-1, 140.537],
    "n-pk52": [1.0081, 5.0197e-3, 2.0943e-1, 1.6248e-2, 7.8169e-1, 1.5239e2],
    "n-balf4": [1.3100, 7.9659e-3, 1.4208e-1, 3.3067e-2, 9.6493e-1, 1.0919e2],
    "sk16": [1.3431, 7.0468e-3, 2.4114e-1, 2.2900e-2, 9.9432e-1, 9.2751e1],
    "d-k59": [1.1209, 6.5791e-3, 1.5269e-1, 2.3572e-2, 1.0750000, 1.0631e2],
    "hk51": [0.9602, 116.24248, 1.1836896, 0.0118030, 0.1023382, 0.018958],
    "d-zk3": [1.3394, 0.0076061, 0.1486902, 0.0238444, 1.0095403, 89.04198],
}

# a0..a5 (Schott power series in wavelength^2)
SCHOTT_TABLE = {
    "coc": [2.28449, 1.02952e-2, 3.73494e-2, -9.28410e-3, 1.73290e-3, -1.15203e-4],
    "pmma": [2.18646, -2.44753e-4, 1.41558e-2, -4.43298e-4, 7.76643e-5, -2.99364e-6],
    "ps": [2.44598, 2.21429e-5, 2.72989e-2, 3.01211e-4, 8.88934e-5, -1.75708e-6],
    "polystyr": [2.44598, 2.21429e-5, 2.72989e-2, 3.01211e-4, 8.88934e-5, -1.75708e-6],
    "pc": [2.42839, -3.86117e-5, 2.87574e-2, -1.97897e-4, 1.48359e-4, 1.38652e-6],
    "polycarb": [2.42839, -3.86117e-5, 2.87574e-2, -1.97897e-4, 1.48359e-4, 1.38652e-6],
    "okp4ht": [2.55219, 6.51282e-5, 3.57452e-2, 8.49831e-4, 8.47777e-5, 1.58990e-5],
    "okp4": [2.49230, -1.46713e-3, 3.04056e-2, -2.31960e-4, 3.62928e-4, -1.89103e-5],
}

GLASS_NAME = {
    "coc": "COC",
    "pmma": "PMMA",
    "ps": "POLYSTYR",
    "polystyr": "POLYSTYR",
    "pc": "POLYCARB",
    "polycarb": "POLYCARB",
    "okp4": "OKP4",
    "okp4ht": "OKP4HT",
}


def _nv_to_cauchy(n: float, v: float) -> tuple[float, float]:
    """Convert (nD, Abbe V) to Cauchy (A, B) with B in [nm^2] units.

    reference basics.py:354-362 — B uses 1/lambda^2 differences at the F/d/C
    Fraunhofer lines in nanometres.
    """
    lam_c, lam_d, lam_f = 656.3, 589.3, 486.1
    ivs = lambda a: 1.0 / a**2
    b = (n - 1.0) / v / (ivs(lam_f) - ivs(lam_c))
    a = n - b * ivs(lam_d)
    return a, b


@dataclass(frozen=True)
class Material:
    """A named optical material with a dispersion model.

    name may be a catalog key ("n-bk7") or an inline "n/V" pair
    ("1.83481/42.7") as used by the shipped lens prescriptions.
    """

    name: str
    dispersion: str       # 'sellmeier' | 'schott' | 'naive'
    params: tuple         # model coefficients
    n_d: float            # nD for aperture finding (A < 1.0003 == air-like)
    abbe: float

    @staticmethod
    def create(name: str | None) -> "Material":
        name = "vacuum" if name is None else name.lower()
        if name in MATERIAL_TABLE:
            n, v = MATERIAL_TABLE[name]
        else:
            parts = name.split("/")
            n, v = float(parts[0]), float(parts[1])

        if name in SELLMEIER_TABLE:
            return Material(name, "sellmeier", tuple(SELLMEIER_TABLE[name]), n, v)
        if name in SCHOTT_TABLE:
            return Material(name, "schott", tuple(SCHOTT_TABLE[name]), n, v)
        return Material(name, "naive", _nv_to_cauchy(n, v), n, v)

    @property
    def is_air(self) -> bool:
        # reference optics.py:199 uses (Cauchy A) < 1.0003 to detect air
        a = self.params[0] if self.dispersion == "naive" else self.n_d
        return a < 1.0003

    def ior(self, wvln: float) -> float:
        """Refractive index at wavelength (um or nm accepted).

        reference basics.py:316-340.
        """
        wv = wvln if wvln < 10 else wvln * 1e-3
        if self.dispersion == "sellmeier":
            k1, l1, k2, l2, k3, l3 = self.params
            w2 = wv * wv
            n2 = 1 + k1 * w2 / (w2 - l1) + k2 * w2 / (w2 - l2) + k3 * w2 / (w2 - l3)
            return float(np.sqrt(n2))
        if self.dispersion == "schott":
            a0, a1, a2, a3, a4, a5 = self.params
            ws = wv * wv
            n2 = a0 + a1 * ws + (a2 + (a3 + (a4 + a5 / ws) / ws) / ws) / ws
            return float(np.sqrt(n2))
        a, b = self.params
        return float(a + b / (wv * 1e3) ** 2)
