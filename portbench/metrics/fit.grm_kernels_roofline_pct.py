"""Kernels B1 and B2's share of their roofline over the window: the
least time of every launch (``portbench/roofline.py`` at the launch's C,
from the operator's products by C, ``Packed2GRM.widths``) over their
device time in the trace (B1's layout kernel counted with B1)."""

from portbench import roofline


def read(ctx):
    c, t = ctx["counters"], ctx["trace"]
    if t is None or not c.get("widths"):
        return None
    M, N = c["grm_markers"], c["n_samples"]
    least = sum(k * (roofline.b1_bound_s(M, N, C) +
                     roofline.b2_bound_s(M, N, C))
                for C, k in c["widths"].items())
    spent = sum(t["kernel_s"].get(name, 0.0) for name in
                roofline.B1_KERNELS + roofline.B2_KERNELS)
    if spent <= 0:
        return None
    return 100.0 * least / spent
