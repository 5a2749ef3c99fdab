"""The whole train step's share of the card's peaks: the least time of
its counted work at the peaks of the precisions the configuration states
(least_step_s) over the measured host time per step, the window's
steps outside the profiled ones."""

LOOP = "train"


def read(rec):
    if rec.get("loop") != LOOP or not rec.get("least_step_s"):
        return None
    steps = rec["n_steps"] - (rec["profile"] or {}).get("steps", 0)
    if steps <= 0:
        return None
    per_step = (rec["window_s"] - rec["profiled_wall_s"]) / steps
    return 100.0 * rec["least_step_s"] / per_step
