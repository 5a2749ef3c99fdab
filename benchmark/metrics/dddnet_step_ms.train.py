"""Mean per training step of the depth net's step: forward, backward, clip
and AdamW (CUDA events around dfdp_train_step), over the window's steps
outside the profiled ones."""


def read(rec):
    values = rec.get("dddnet_ms")
    if rec.get("loop") != "train" or not values:
        return None
    return sum(values) / len(values)
