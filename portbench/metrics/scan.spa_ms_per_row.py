"""Milliseconds of the scan's phase 2 (SPA) per variant-model row it
refined: the scan's ``instrument=`` ``spa_s`` over ``spa_n``."""


def read(ctx):
    inst = ctx["counters"].get("instrument") or {}
    if not inst.get("spa_n"):
        return None
    return 1e3 * inst["spa_s"] / inst["spa_n"]
