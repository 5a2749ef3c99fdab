"""CPU ms per training step that the DataLoader's workers spent building
batches, all workers together: the program's counter ``loader.work_cpu_s``
(dfdp/datasets.py, thread_time per batch built;
sdirt_tpu_torch/utils/trace.py) over the profiled steps. None where the
program keeps no such counter."""

LOOP, COUNTER = "train", "loader.work_cpu_s"


def read(rec):
    prof = rec.get("profile")
    if rec.get("loop") != LOOP or not prof or not prof.get("steps"):
        return None
    try:
        from sdirt_tpu_torch.utils import trace
    except ImportError:
        return None
    value = trace.snapshot()["counters"].get(COUNTER)
    return 1e3 * value / prof["steps"] if value is not None else None
