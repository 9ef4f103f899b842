"""Host milliseconds per scan block of the dense route's width check
(``assoc/single.py`` ``_shrink_f32``, on the pack thread): the program's
spans ``scan.shrink`` over its counter ``scan.blocks``."""

from portbench.program_spans import recorded


def read(ctx):
    r = recorded(ctx)
    if r is None or not r.n("scan.shrink") or not r.counts.get("scan.blocks"):
        return None
    return 1e3 * r.host_s("scan.shrink") / r.counts["scan.blocks"]
