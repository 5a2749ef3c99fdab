"""Lens prescription JSON IO (counterpart of sdirt_tpu/io/lens_json.py).

Surface dicts carry type in {'Aspheric', 'Stop', 'Spheric'}, vertex
position d, clear radius r, curvature c, conic k, even-asphere list ai, and
material names on both sides.
"""

from __future__ import annotations

import json

from ..core.materials import Material
from ..optics.surfaces import KIND_ASPHERIC, KIND_SPHERIC, KIND_STOP, SurfaceStack


def read_lens_json(path: str, device="cpu"):
    """Parse a lens JSON into (SurfaceStack, materials, r_last, d_sensor,
    meta). materials[i] / materials[i+1] are the media before / after
    surface i."""
    with open(path) as f:
        data = json.load(f)

    c, k, ai_lists, d, r, kinds = [], [], [], [], [], []
    mat1_names, mat2_names = [], []
    for s in data["surfaces"]:
        stype = s["type"]
        c.append(float(s.get("c", 0.0)))
        d.append(float(s["d"]))
        r.append(float(s["r"]))
        mat1_names.append(s["mat1"])
        mat2_names.append(s["mat2"])
        if stype == "Aspheric":
            k.append(float(s.get("k", 0.0)))
            ai_lists.append([float(a) for a in s.get("ai", [])])
            kinds.append(KIND_ASPHERIC)
        elif stype in ("Stop", "Spheric"):
            k.append(0.0)
            ai_lists.append([])
            kinds.append(KIND_SPHERIC if stype == "Spheric" else KIND_STOP)
        else:
            raise ValueError(f"Surface type not implemented: {stype}")

    # a surface with c == 0 behaves as a plane, whatever its type
    kinds = [KIND_STOP if ci == 0.0 else kd for ci, kd in zip(c, kinds)]

    stack = SurfaceStack.from_lists(c, k, ai_lists, d, r, kinds, device=device)
    materials = ([Material.create(n) for n in mat1_names]
                 + [Material.create(mat2_names[-1])])
    meta = {key: data.get(key) for key in ("foclen", "fnum", "sensor_size")}
    return stack, materials, float(data["r_last"]), float(data["d_sensor"]), meta


def write_lens_json(lens, path: str) -> None:
    """Serialise a Lens back to the same JSON schema."""
    stack = lens.stack
    c, k, ai, d, r = (a.detach().cpu().numpy() for a in
                      (stack.c, stack.k, stack.ai, stack.d, stack.r))
    kind = stack.kind.cpu().numpy()

    surfaces = []
    n = stack.num_surfaces
    for i in range(n):
        if kind[i] == KIND_STOP:
            sd = {"type": "Stop", "r": float(r[i]), "c": float(c[i]), "d": float(d[i])}
        elif kind[i] == KIND_SPHERIC:
            sd = {"type": "Spheric", "r": float(r[i]), "c": float(c[i]),
                  "roc": float(1.0 / c[i]), "d": float(d[i])}
        else:
            terms = [float(a) for a in ai[i]]
            while terms and terms[-1] == 0.0:
                terms.pop()
            sd = {"type": "Aspheric", "r": float(r[i]), "c": float(c[i]),
                  "roc": float(1.0 / c[i]) if c[i] != 0 else 0.0,
                  "d": float(d[i]), "k": float(k[i]), "ai": terms}
            for j, a in enumerate(terms):
                sd[f"ai{2 * (j + 1)}"] = a
        sd["d_next"] = (float(d[i + 1] - d[i]) if i < n - 1
                        else float(lens.d_sensor - d[i]))
        sd["mat1"] = lens.materials[i].name
        sd["mat2"] = lens.materials[i + 1].name
        surfaces.append(sd)

    data = {"foclen": float(lens.foclen), "fnum": float(lens.fnum),
            "r_last": float(lens.r_last), "d_sensor": float(lens.d_sensor),
            "sensor_size": list(lens.sensor_size), "surfaces": surfaces}
    with open(path, "w") as f:
        json.dump(data, f, indent=4)
