"""Host ms per training step in which the main thread did not run inside
the step's work: wall time less the thread's CPU time (perf_counter less
thread_time) of the program's top-level spans ``render.prep``, ``render``
and ``train_step`` on the main thread (sdirt_tpu_torch/utils/trace.py),
over the profiled steps. None where the program records no such span."""

import threading

LOOP, ROOTS = "train", ("render.prep", "render", "train_step")


def read(rec):
    prof = rec.get("profile")
    if rec.get("loop") != LOOP or not prof or not prof.get("steps"):
        return None
    try:
        from sdirt_tpu_torch.utils import trace
    except ImportError:
        return None
    main = threading.main_thread().ident
    spans = [r for r in trace.snapshot()["records"] if r["parent"] is None
             and r["name"] in ROOTS and r["thread"] == main]
    if not spans:
        return None
    return sum(r["wall_ms"] - r["cpu_ms"] for r in spans) / prof["steps"]
