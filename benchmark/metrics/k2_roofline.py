"""K2's share of its roofline: the least time of the per-pixel DP
convolution at the batch's shape (counts/k2.py) over K2's device time per
launch in the profiled steps (kernels named ``fused_dp_conv_kernel``)."""

from benchmark.counts import k2

KERNEL = "fused_dp_conv_kernel"


def read(rec):
    prof, shape = rec.get("profile"), rec.get("k2_shape")
    if not prof or not shape:
        return None
    rows = [(n, s) for name, n, s in prof["kernels"] if KERNEL in name]
    launches = sum(n for n, _ in rows)
    if not launches:
        return None
    bound_ms, _ = k2.bound_ms(*shape)
    return 100.0 * bound_ms / (1e3 * sum(s for _, s in rows) / launches)
