"""Device ms per render batch of the PSF MLP: the program's span
``render.psf_mlp`` (sdirt_tpu_torch/utils/trace.py: CUDA events around
mlp_fast.mlp_psf_tapmajor, basis.basis_coeffs or the scan's pred_psf)
over the profiled steps. None where the program records no such span."""

LOOP, SPAN = "render", "render.psf_mlp"


def read(rec):
    prof = rec.get("profile")
    if rec.get("loop") != LOOP or not prof or not prof.get("steps"):
        return None
    try:
        from sdirt_tpu_torch.utils import trace
    except ImportError:
        return None
    row = trace.snapshot()["spans"].get(SPAN)
    return row["device_ms"] / prof["steps"] if row else None
