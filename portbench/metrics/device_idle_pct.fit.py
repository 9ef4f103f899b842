"""The device's idle share of the traced window in a fit cell: one
less the union of the device's activity intervals (kernels, copies,
sets) over the window's length, from the profiler's timeline, in
every cell whose rate is ``fit_phenotypes_per_min``, whatever its
driver."""


def read(ctx):
    t = ctx["trace"]
    if t is None or t["window_s"] <= 0 or \
            ctx["mix"]["rate_metric"] != "fit_phenotypes_per_min":
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
