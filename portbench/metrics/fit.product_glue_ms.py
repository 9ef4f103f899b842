"""Device milliseconds per GRM product of the work around kernels B1 and
B2: the slice decompositions and the f64 recombinations, the program's
device spans ``grm.slice`` and ``grm.combine`` over its ``grm.product``
spans."""

from portbench.program_spans import recorded


def read(ctx):
    r = recorded(ctx)
    if r is None or not r.n("grm.product"):
        return None
    return 1e3 * r.device_s("grm.slice", "grm.combine") / \
        r.n("grm.product")
