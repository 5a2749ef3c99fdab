"""Host wall ms per training step of the render's preparation: the
program's span ``render.prep`` (dfdp_net._render_batch: the uint8 and f16
quantisation, pinning, the uploads and select_focus_dist; perf_counter)
over the profiled steps. None where the program records no such span."""

LOOP, SPAN = "train", "render.prep"


def read(rec):
    prof = rec.get("profile")
    if rec.get("loop") != LOOP or not prof or not prof.get("steps"):
        return None
    try:
        from sdirt_tpu_torch.utils import trace
    except ImportError:
        return None
    row = trace.snapshot()["spans"].get(SPAN)
    return row["wall_ms"] / prof["steps"] if row else None
