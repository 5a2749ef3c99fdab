"""Mean per training step of the training render (CUDA events around
_render_batch), over the window's steps outside the profiled ones."""


def read(rec):
    values = rec.get("render_ms")
    if rec.get("loop") != "train" or not values:
        return None
    return sum(values) / len(values)
