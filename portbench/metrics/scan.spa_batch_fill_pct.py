"""How full the scan's SPA batches run: the rows refined (the program's
counter ``scan.spa_rows``) over the batches launched (``scan.spa_batches``)
times the batch's size (``assoc/single.py`` ``SPA_BATCH``)."""

from portbench.program_spans import recorded


def read(ctx):
    r = recorded(ctx)
    if r is None or not r.counts.get("scan.spa_batches"):
        return None
    from saigegds_tpu_torch.assoc.single import SPA_BATCH
    return 100.0 * r.counts.get("scan.spa_rows", 0) / (
        r.counts["scan.spa_batches"] * SPA_BATCH)
