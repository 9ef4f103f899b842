"""The device's idle share of the traced window in a scan cell: one
less the union of the device's activity intervals (kernels, copies,
sets) over the window's length, from the profiler's timeline, in
every cell whose rate is ``scan_tests_per_s``, whatever its driver."""


def read(ctx):
    t = ctx["trace"]
    if t is None or t["window_s"] <= 0 or \
            ctx["mix"]["rate_metric"] != "scan_tests_per_s":
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
