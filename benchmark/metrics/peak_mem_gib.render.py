"""Peak device memory allocated in the render window
(max_memory_allocated after reset_peak_memory_stats at its start)."""

LOOP = "render"


def read(rec):
    if rec.get("loop") != LOOP or not rec.get("peak_mem_bytes"):
        return None
    return rec["peak_mem_bytes"] / 2 ** 30
