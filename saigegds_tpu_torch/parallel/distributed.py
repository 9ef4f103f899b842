"""Several processes for one scan: process-group set-up, variant-range
shards and their merge; the counterpart of
``saigegds_tpu/parallel/distributed.py``.

The reference scales across machines by running independent jobs on
variant ranges and row-binding their result files (``seqSAIGE_LoadPval``,
R/saige_main.r:205-213).  So does this module: each process (or cluster
job, given its ``process_id`` and ``process_count``) scans one contiguous
variant range and writes one shard file, and any process merges them.
Nothing here sends tensors between processes.
"""

from __future__ import annotations

import datetime
import glob
from typing import Optional, Tuple

import numpy as np
import torch


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     device="cuda",
                     timeout_s: float = 1800.0) -> Tuple[int, int]:
    """Join the ``torch.distributed`` process group of a multi-process run
    and return ``(rank, world_size)``.

    ``coordinator_address`` is the group's ``init_method``: a URL
    (``tcp://host:port``, ``file:///shared/path``) or ``host:port``, taken
    as ``tcp://``.  The backend follows ``device``: gloo for the CPU, nccl
    for a card.  With nothing given in a single process this is a no-op
    that returns ``(0, 1)``; an explicit multi-process set-up that fails
    raises, as in the JAX package.  Already in a group: its rank and size.
    """
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if coordinator_address is None and (num_processes or 1) <= 1:
        return 0, 1
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("a multi-process run needs coordinator_address, "
                         "num_processes and process_id")
    if not dist.is_available():
        raise RuntimeError("torch.distributed is not available")
    init = coordinator_address if "://" in coordinator_address \
        else f"tcp://{coordinator_address}"
    backend = "gloo" if torch.device(device).type == "cpu" else "nccl"
    dist.init_process_group(backend, init_method=init,
                            world_size=int(num_processes),
                            rank=int(process_id),
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dist.get_rank(), dist.get_world_size()


def _rank_and_size() -> Tuple[int, int]:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def host_variant_range(n_variants: int,
                       process_id: Optional[int] = None,
                       process_count: Optional[int] = None
                       ) -> Tuple[int, int]:
    """The contiguous [start, stop) variant range of process
    ``process_id`` of ``process_count`` (by default this process's rank and
    the group's size, or (0, 1) outside a process group)."""
    rank, size = _rank_and_size()
    pid = rank if process_id is None else process_id
    cnt = size if process_count is None else process_count
    per = -(-n_variants // cnt)
    start = min(pid * per, n_variants)
    return start, min(start + per, n_variants)


def shard_path(out_prefix: str, process_id: int) -> str:
    """The shard file of process ``process_id``: ``{prefix}.part{id:04d}``
    with the ``.rds`` extension, a format that ``save_assoc`` writes and
    ``load_pval`` reads (the JAX package writes ``.parquet``, which the
    port refuses: it needs pandas and pyarrow)."""
    return f"{out_prefix}.part{process_id:04d}.rds"


def assoc_spa_sharded(gdsfile, modobj, out_prefix: str, config=None,
                      process_id: Optional[int] = None,
                      process_count: Optional[int] = None, mesh=None, *,
                      device) -> str:
    """Scan this process's variant range (:func:`host_variant_range`) with
    ``assoc_spa`` on ``device`` (and ``mesh``) and write its shard
    (:func:`shard_path`); returns the path.  Run it in every process, or as
    independent jobs with explicit ``process_id``/``process_count``, then
    merge with :func:`merge_shards`."""
    from ..assoc.single import assoc_spa, save_assoc
    from ..config import ScanConfig
    from ..io.seqarray import SeqData

    seq = gdsfile if isinstance(gdsfile, SeqData) else SeqData(gdsfile)
    start, stop = host_variant_range(seq.n_variants, process_id,
                                     process_count)
    mask = np.zeros(seq.n_variants, dtype=bool)
    mask[start:stop] = True
    tab = assoc_spa(seq, modobj, config or ScanConfig(), variant_mask=mask,
                    device=device, mesh=mesh)
    pid = _rank_and_size()[0] if process_id is None else process_id
    path = shard_path(out_prefix, pid)
    save_assoc(tab, path)
    return path


def merge_shards(out_prefix: str, columns=None) -> dict:
    """Row-bind every shard ``{out_prefix}.part*`` in name order (the
    ``seqSAIGE_LoadPval`` merge); raises FileNotFoundError when there is
    none."""
    from ..utils.stats import load_pval
    paths = sorted(glob.glob(f"{out_prefix}.part*"))
    if not paths:
        raise FileNotFoundError(f"no shards matching {out_prefix}.part*")
    return load_pval(paths, columns=columns)
