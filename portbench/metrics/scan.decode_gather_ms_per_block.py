"""Host milliseconds per scan block of the GDS decode and the gather to
the model's samples: the scan's ``instrument=`` stage walls
(``decode_s`` + ``gather_s``) over the blocks of the window's calls."""


def read(ctx):
    inst = ctx["counters"].get("instrument") or {}
    dec = inst.get("decode_s") or []
    if not dec:
        return None
    return 1e3 * (sum(dec) + sum(inst.get("gather_s") or [])) / len(dec)
