"""The scan's dense phase 1 against its roofline: the least time of
every block (``portbench/roofline_dense.py`` at the block's rows, its
payload's bytes and the call's models) over the device seconds of the
program's device spans ``scan.dense_score``, one a block.  A call scans
the mix's ``variants`` in blocks of ``block_size``; the payload's bytes
a row are the counter ``scan.dense_bytes`` over the rows shipped
(``scan.dense_rows_f32`` + ``scan.dense_rows_f64``).  None where the
program records no such span, or where its blocks are not the calls'."""

from portbench.program_spans import recorded
from portbench.roofline_dense import dense_bound_s


def read(ctx):
    r = recorded(ctx)
    if r is None:
        return None
    spans = [d.seconds for d in r.device if d.name == "scan.dense_score"]
    c = r.counts
    rows = c.get("scan.dense_rows_f32", 0) + c.get("scan.dense_rows_f64", 0)
    mix, cfg = ctx["mix"], ctx["config"]
    V, B = mix["variants"], mix["block_size"]
    blocks = [min(B, V - s) for s in range(0, V, B)] * len(ctx["calls"])
    if not spans or sum(spans) <= 0 or len(spans) != len(blocks) or \
            sum(blocks) != rows:
        return None
    per_row = c["scan.dense_bytes"] / rows
    P, K = len(mix["models_case_pct"]), cfg["covariates"] + 1
    least = sum(dense_bound_s(b, cfg["n_samples"], P, K, b * per_row)
                for b in blocks)
    return 100.0 * least / sum(spans)
