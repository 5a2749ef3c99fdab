"""Device ms per render batch of the DP convolution: the program's span
``render.dp_conv`` (sdirt_tpu_torch/utils/trace.py: CUDA events around K2,
fused_conv.fused_dp_conv_tapmajor, or the basis render's bank conv,
K-contraction and normalisation, or the scan's local_dp_conv) over the
profiled steps. None where the program records no such span."""

LOOP, SPAN = "render", "render.dp_conv"


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
