"""Host milliseconds per scan call of its preparation (the GDS opened,
the samples aligned, each model's scan state made and laid out): the
program's spans ``scan.prepare`` over its ``scan.call`` spans."""

from portbench.program_spans import recorded


def read(ctx):
    r = recorded(ctx)
    if r is None or not r.n("scan.call"):
        return None
    return 1e3 * r.host_s("scan.prepare") / r.n("scan.call")
