"""The share of the profiled render steps in which no kernel, copy or
memset ran on the device (the union of their intervals in the Chrome
trace, against the profiled window's length)."""

LOOP = "render"


def read(rec):
    prof = rec.get("profile")
    if rec.get("loop") != LOOP or not prof or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
