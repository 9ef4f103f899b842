"""Milliseconds of the scan's main thread per variant-model row refined
in phase 2 (SPA): the program's span ``scan.spa.refine`` (each batch's
launches, its work on the card and its readback) over its counter
``scan.spa_rows``.  A wall time: in a scan the host sets the pace, so
the card's own time for these rows is smaller, and is read from the
device trace, not here."""

from portbench.program_spans import recorded


def read(ctx):
    r = recorded(ctx)
    if r is None or not r.counts.get("scan.spa_rows"):
        return None
    return 1e3 * r.host_s("scan.spa.refine") / r.counts["scan.spa_rows"]
