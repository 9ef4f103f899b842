"""Device milliseconds per GRM product of its missing-pair corrections
(``MissingPairs.per_variant`` and ``.per_sample``): the program's device
spans ``grm.corrections`` over its ``grm.product`` spans."""

from portbench.program_spans import recorded


def read(ctx):
    r = recorded(ctx)
    if r is None or not r.n("grm.product"):
        return None
    return 1e3 * r.device_s("grm.corrections") / r.n("grm.product")
