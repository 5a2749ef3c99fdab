"""Mean per training step of the host's wait for a batch from the loader
(perf_counter around next()), over the window's steps outside the profiled
ones."""


def read(rec):
    values = rec.get("data_wait_ms")
    if rec.get("loop") != "train" or not values:
        return None
    return sum(values) / len(values)
