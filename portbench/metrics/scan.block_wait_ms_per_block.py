"""Milliseconds per scan block that the scan's main thread, which feeds
the card, waits for the next uploaded block: the program's span
``scan.wait_block`` over the window over its counter ``scan.blocks``."""

from portbench.program_spans import recorded


def read(ctx):
    r = recorded(ctx)
    if r is None or not r.counts.get("scan.blocks"):
        return None
    return 1e3 * r.host_s("scan.wait_block") / r.counts["scan.blocks"]
