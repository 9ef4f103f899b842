"""Several processes for one job: the counterpart of
``saigegds_tpu/parallel/distributed.py``.

* **The fit.**  :func:`init_distributed` joins a ``torch.distributed``
  process group; ``parallel/mesh.make_mesh`` then spans every rank's
  devices, as ``jax.devices()`` does after ``jax.distributed.initialize``,
  and ``fit_null_glmm(mesh=)`` keeps each rank's sample ranges of the GRM
  store on that rank.  Rank 0 (the lead) runs the fit; the other ranks
  serve GRM products.  :class:`Wire` carries a product's messages: the
  slices out to each rank, one sum of the B1 partials and the rows of
  B2 back to the lead, and the B2 operand out to every rank.  Only exact
  integers travel, so the product equals the one-store product bit for
  bit whatever the number of ranks.
* **The scan.**  The reference scales across machines by running
  independent jobs on variant ranges and row-binding their result files
  (``seqSAIGE_LoadPval``, R/saige_main.r:205-213).  So does this module:
  each process (or cluster job, given its ``process_id`` and
  ``process_count``) scans one contiguous variant range and writes one
  shard file, and any process merges them.
"""

from __future__ import annotations

import datetime
import glob
import time
import warnings
from typing import Optional, Tuple

import numpy as np
import torch


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     device="cuda", backend: Optional[str] = None,
                     timeout_s: float = 1800.0) -> Tuple[int, int]:
    """Join the ``torch.distributed`` process group of a multi-process run
    and return ``(rank, world_size)``.

    ``coordinator_address`` is the group's ``init_method``: a URL
    (``tcp://host:port``, ``file:///shared/path``) or ``host:port``, taken
    as ``tcp://``.  ``backend`` defaults to gloo for the CPU and nccl for a
    card (``device``); NCCL needs one card per rank, so ranks that share a
    card name gloo, whose messages are staged through host memory.  Nothing
    switches the backend on failure.  Under nccl a card with an index
    becomes this process's current device.  Every collective of the group
    gives up after ``timeout_s``.  With nothing given in a single process
    this is a no-op that returns ``(0, 1)``; an explicit multi-process
    set-up that fails raises, as in the JAX package.  Already in a group:
    its rank and size.
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
    dev = torch.device(device)
    if backend is None:
        backend = "gloo" if dev.type == "cpu" else "nccl"
    if backend == "nccl" and dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
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


# the lead's headers: a product of R columns, the end of serving, a failure
PRODUCT, STOP, ABORT = 1, 2, 3


def staging_device(device) -> torch.device:
    """Where the group's messages travel from ``device``: the card itself
    under nccl; host memory under gloo, which takes host tensors."""
    import torch.distributed as dist
    return torch.device("cpu") if dist.get_backend() == "gloo" \
        else torch.device(device)


def send_header(op: int, device, arg: int = 0):
    """On the lead: broadcast the header ``(op, arg)`` (:data:`PRODUCT`
    with R, :data:`STOP` or :data:`ABORT`) to every rank."""
    import torch.distributed as dist
    dist.broadcast(torch.tensor([op, arg], dtype=torch.int64,
                                device=staging_device(device)), src=0)


def recv_header(device) -> Tuple[int, int]:
    """On a rank other than the lead: the next header ``(op, arg)``."""
    import torch.distributed as dist
    h = torch.zeros(2, dtype=torch.int64, device=staging_device(device))
    dist.broadcast(h, src=0)
    return int(h[0]), int(h[1])


def abort_group(device):
    """On the lead, after a failure: tell every rank to raise rather than
    wait.  A rank that waits in another collective (the failure came in
    the middle of a product) raises at the group's timeout instead; a
    failure to send warns, so that the caller's own error goes on."""
    try:
        send_header(ABORT, device)
    except RuntimeError as e:
        warnings.warn(f"could not send the abort to the other ranks: {e}")


def share(obj, device):
    """Broadcast ``obj`` (any picklable object) from the lead; every rank
    returns the lead's."""
    import torch.distributed as dist
    box = [obj]
    dist.broadcast_object_list(box, src=0, device=staging_device(device))
    return box[0]


class Wire:
    """The messages of GRM products between the lead (rank 0 of the
    default process group) and the other ranks, each of which holds the
    stores of one contiguous block of samples
    (``ops/packed_grm.sharded_product`` and ``rank_product``).

    One product of R columns (RS = 8 R slice columns): the lead broadcasts
    the header ``(PRODUCT, R)`` and sends each rank its samples' int8
    slice rows [n, RS]; the ranks' B1 partials [M, RS] come back as one
    int32 sum (exact: |partial| <= 2 * 127 * N < 2^31 for N < 8.4M); the
    int8 B2 operand [M, RS] goes out to every rank by broadcast, and each
    rank's B2 rows [n, RS] come back as int32 (|row| <= 2 * 127 * M <
    2^31 up to M = 1M).  The lead turns them into f64 before any sum, so
    the product equals the one-store product bit for bit; int32 halves the
    bytes of f64, and only the live RS columns travel, not the kernels'
    padded C.  The lead posts its sends before it launches its own
    kernels, so the other ranks' kernels run while the lead's do.

    ``device`` is this rank's device; ``blocks`` lists ``(rank, lo, hi)``:
    on the lead every other rank's block, on another rank its own.  Under
    nccl the tensors travel on the card; under gloo they are staged
    through host tensors, which that backend requires.  ``seconds`` and
    ``bytes`` count the lead's wall time in these collectives (staging and
    the wait for the other ranks included) and the bytes of its messages:
    each rank's slices, operand and rows, the summed partials and the
    headers."""

    def __init__(self, device, blocks):
        import torch.distributed as dist
        self._dist = dist
        self.device = torch.device(device)
        self.staging = staging_device(device)
        self.blocks = [(int(r), int(lo), int(hi)) for r, lo, hi in blocks]
        self.seconds = 0.0
        self.bytes = 0

    def _count(self, t0: float, nbytes: int):
        self.seconds += time.perf_counter() - t0
        self.bytes += int(nbytes)

    # the lead

    def post_slices(self, R: int, d: torch.Tensor) -> list:
        """Header ``(PRODUCT, R)``, then each rank's rows of the slices
        ``d`` int8 [N, RS] sent without waiting; returns what
        :meth:`sum_partials` waits for."""
        t0 = time.perf_counter()
        send_header(PRODUCT, self.device, R)
        sent = []
        for r, lo, hi in self.blocks:
            rows = d[lo:hi].to(self.staging)
            sent.append((self._dist.isend(rows, dst=r), rows))
        self._count(t0, 16 * len(self.blocks)
                    + sum(t.nbytes for _w, t in sent))
        return sent

    def sum_partials(self, sent: list, M: int, RS: int) -> torch.Tensor:
        """The other ranks' B1 partials, summed: int32 [M, RS]."""
        t0 = time.perf_counter()
        for w, _t in sent:
            w.wait()
        acc = torch.zeros(M, RS, dtype=torch.int32, device=self.staging)
        self._dist.reduce(acc, dst=0, op=self._dist.ReduceOp.SUM)
        self._count(t0, acc.nbytes)
        return acc

    def post_operand(self, dm: torch.Tensor) -> tuple:
        """Broadcast the B2 operand ``dm`` int8 [M, RS] without waiting;
        returns what :meth:`gather_rows` waits for."""
        t0 = time.perf_counter()
        dm = dm.to(self.staging)
        work = self._dist.broadcast(dm, src=0, async_op=True)
        self._count(t0, dm.nbytes * len(self.blocks))
        return work, dm

    def gather_rows(self, sent: tuple, RS: int) -> list:
        """Each rank's B2 rows, int32 [n, RS], in rank order."""
        t0 = time.perf_counter()
        bufs = [torch.empty(hi - lo, RS, dtype=torch.int32,
                            device=self.staging)
                for _r, lo, hi in self.blocks]
        works = [self._dist.irecv(buf, src=r)
                 for buf, (r, _lo, _hi) in zip(bufs, self.blocks)]
        sent[0].wait()
        for w in works:
            w.wait()
        self._count(t0, sum(b.nbytes for b in bufs))
        return bufs

    def stop(self):
        """End every rank's :meth:`~..mesh.ShardedGrmHandle.serve`."""
        send_header(STOP, self.device)

    # a rank other than the lead

    def next(self) -> Tuple[int, int]:
        """The lead's next header ``(op, arg)``."""
        return recv_header(self.device)

    def recv_slices(self, RS: int) -> torch.Tensor:
        (_r, lo, hi), = self.blocks
        d = torch.empty(hi - lo, RS, dtype=torch.int8, device=self.staging)
        self._dist.recv(d, src=0)
        return d

    def reduce_partials(self, part: torch.Tensor):
        self._dist.reduce(part.to(self.staging), dst=0,
                          op=self._dist.ReduceOp.SUM)

    def recv_operand(self, M: int, RS: int) -> torch.Tensor:
        dm = torch.empty(M, RS, dtype=torch.int8, device=self.staging)
        self._dist.broadcast(dm, src=0)
        return dm

    def send_rows(self, rows: torch.Tensor):
        self._dist.send(rows.to(self.staging).contiguous(), dst=0)


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
