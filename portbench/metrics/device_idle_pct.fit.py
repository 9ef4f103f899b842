"""The device's idle share of the traced window in a fit cell: one
less the union of the device's activity intervals (kernels, copies,
sets) over the window's length, from the profiler's timeline."""


def read(ctx):
    t = ctx["trace"]
    if t is None or ctx["entry"] != "fit_lanes" or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
