"""Device meshes for the two scale axes of the problem: the counterpart of
``saigegds_tpu/parallel/mesh.py``.

* **Samples** for the null fit.  The GRM store is what outgrows one card
  (the reference's 1M-SNP cap at N = 430,000 is a 107.5 GB 2-bit store),
  so :class:`ShardedGrmHandle` keeps it as contiguous sample ranges, one
  store per device, while every vector stays whole on the lead device.
  Each product runs kernels B1 and B2 once per range; the lead sums the
  ranges' exact integer partials, so the product equals the one-store
  product bit for bit (``ops/packed_grm.sharded_product``).  After
  ``init_distributed`` a mesh spans every rank's devices: each rank keeps
  its own ranges' stores, the lead (rank 0) fits, and the other ranks
  serve its products (:meth:`ShardedGrmHandle.serve`) over the group
  (``distributed.Wire``).  The fit stays the lead's, not an SPMD fit that
  all-reduces inner products: that would reorder f64 sums, and the
  products and the fit would no longer equal the one-store ones bit for
  bit.
* **Variants** for the scan: each block's rows are split into contiguous
  parts, one per device, against a copy of the model on each device
  (:func:`shard_variant_batch`, :func:`replicate`); the tables merge on
  the host by row.

The JAX package places arrays with ``NamedSharding``, which needs the
sharded axis to divide the mesh, hence its ``pad_dim``, ``shard_grm`` and
``shard_vectors``; here the parts are plain tensors of any size and those
helpers have no counterpart.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..ops._cuda import check_device
from ..ops.grm import GRMOperator
from ..ops.packed_grm import (MissingPairs, Packed2GRM, _pack2_zeroed,
                              kernel_cols, place_rows, rank_product,
                              sharded_product, store_width, stream_moments)

_REPACK_ROWS = 1024      # store rows resharded per step (device temporaries
#                          of 4 x 8 x that many bytes per sample column)


class Mesh:
    """An ordered list of devices; the first is the lead, which holds
    every vector and does every step that spans all samples.

    A mesh that spans a process group (:func:`make_mesh` after
    ``init_distributed``) lists every rank's devices in rank order:
    ``ranks`` holds the rank of each device and ``rank`` this process's;
    a device is used only by its own rank.  The lead is rank 0's first
    device."""

    def __init__(self, devices: Sequence, ranks: Optional[Sequence] = None,
                 rank: int = 0):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.ranks = (0,) * len(self.devices) if ranks is None \
            else tuple(int(r) for r in ranks)
        if len(self.ranks) != len(self.devices) or self.ranks[0] != 0 \
                or list(self.ranks) != sorted(self.ranks) \
                or rank not in self.ranks:
            raise ValueError(f"ranks {self.ranks} of {len(self.devices)} "
                             f"devices must be in rank order from 0 and "
                             f"hold rank {rank}")
        self.rank = int(rank)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def lead(self) -> torch.device:
        return self.devices[0]

    @property
    def spans(self) -> bool:
        """Whether the mesh spans more than one process."""
        return self.ranks[0] != self.ranks[-1]

    @property
    def is_lead(self) -> bool:
        return self.rank == self.ranks[0]

    def local(self) -> list:
        """This process's parts (indices into ``devices``): consecutive."""
        return [k for k, r in enumerate(self.ranks) if r == self.rank]

    @property
    def home(self) -> torch.device:
        """The device this process computes on: the lead on the lead's
        rank, else this rank's first device."""
        return self.devices[self.local()[0]]

    def distinct(self) -> list:
        """This process's devices, each once, in mesh order."""
        return list(dict.fromkeys(self.devices[k] for k in self.local()))

    def __repr__(self) -> str:
        devs = [str(d) for d in self.devices]
        if not self.spans:
            return f"Mesh({devs})"
        return f"Mesh({devs}, ranks={list(self.ranks)}, rank={self.rank})"


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of the first ``n_devices`` CUDA devices (all of them by
    default), or of the explicit ``devices`` list.

    A device may repeat in ``devices``: ``["cpu"] * 3`` shards over three
    parts on the host, ``["cuda:0"] * 2`` over two parts on one card.  This
    stands in for the JAX package's virtual host devices (XLA's
    ``--xla_force_host_platform_device_count``): the sharded code paths run
    on a machine with fewer devices than parts.  Without a card,
    ``make_mesh(n)`` raises; nothing falls back to the CPU.

    In a process group of more than one process (``init_distributed``)
    every rank calls it, and the devices named (or counted) are this
    process's own; the mesh lists every rank's, in rank order, as
    ``jax.devices()`` does after ``jax.distributed.initialize`` (one
    ``all_gather_object``)."""
    from .distributed import _rank_and_size
    if devices is not None:
        if n_devices is not None:
            raise ValueError("give n_devices or devices, not both")
        devs = [check_device(d) for d in devices]
        for d in devs:
            if d.type == "cuda" and d.index is not None \
                    and d.index >= torch.cuda.device_count():
                raise ValueError(f"device {d} requested but only "
                                 f"{torch.cuda.device_count()} available")
        devs = [torch.device("cuda", torch.cuda.current_device())
                if d.type == "cuda" and d.index is None else d
                for d in devs]
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: CUDA is not available (pass "
                               "devices=['cpu', ...] to shard over the "
                               "host)")
        count = torch.cuda.device_count()
        n = count if n_devices is None else int(n_devices)
        if n < 1:
            raise ValueError(f"a mesh needs at least one device, got {n}")
        if n > count:
            raise ValueError(f"requested {n} devices but only {count} "
                             f"available")
        devs = [torch.device("cuda", i) for i in range(n)]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    rank, size = _rank_and_size()
    if size == 1:
        return Mesh(devs)
    import torch.distributed as dist
    lists = [None] * size
    dist.all_gather_object(lists, [str(d) for d in devs])
    return Mesh([d for part in lists for d in part],
                ranks=[r for r, part in enumerate(lists) for _ in part],
                rank=rank)


def _same_device(a: torch.device, b: torch.device) -> bool:
    idx = lambda d: (torch.cuda.current_device() if d.index is None
                     else d.index) if d.type == "cuda" else d.index
    return a.type == b.type and idx(a) == idx(b)


def check_lead(mesh: Mesh, device) -> torch.device:
    """The device this process computes on for ``mesh``
    (:attr:`Mesh.home`), which must be ``device``: the mesh's lead device,
    or on another rank of a mesh that spans processes, that rank's own
    first device."""
    dev = check_device(device)
    if not _same_device(mesh.home, dev):
        what = "the mesh's lead device" if mesh.is_lead \
            else f"rank {mesh.rank}'s first device of the mesh"
        raise ValueError(f"device={dev} but {what} is {mesh.home}: they "
                         f"must agree")
    return mesh.home


def sample_ranges(n_samples: int, n_parts: int) -> list:
    """Contiguous [lo, hi) sample ranges, one per part, whose sizes differ
    by at most one."""
    if n_samples < n_parts:
        raise ValueError(f"{n_samples} samples cannot fill {n_parts} "
                         f"shards")
    bounds = [k * n_samples // n_parts for k in range(n_parts + 1)]
    return list(zip(bounds[:-1], bounds[1:]))


def variant_ranges(n_rows: int, mesh: Mesh) -> list:
    """Contiguous [lo, hi, device) parts of a block's ``n_rows`` rows, one
    per device of the mesh; uneven parts are fine, empty ones are left
    out."""
    bounds = [k * n_rows // mesh.size for k in range(mesh.size + 1)]
    return [(lo, hi, d) for lo, hi, d in zip(bounds[:-1], bounds[1:],
                                             mesh.devices) if hi > lo]


def shard_variant_batch(mesh: Mesh, G: np.ndarray) -> list:
    """Split a host block ``G`` [B, ...] by variant rows into
    :func:`variant_ranges` parts, each uploaded to its device:
    ``[(rows, tensor)]``, rows the part's row indices into the block."""
    from ..assoc.single import _to_device
    return [(np.arange(lo, hi), _to_device(np.ascontiguousarray(G[lo:hi]),
                                           d))
            for lo, hi, d in variant_ranges(len(G), mesh)]


def replicate(mesh: Mesh, x) -> dict:
    """A copy of ``x`` (a tensor, or a NamedTuple / tuple / list / dict of
    them; other leaves are shared) on each distinct device of the mesh:
    ``{device: copy}``.  The lead's copy holds the tensors already there
    as they are."""
    def to(v, d):
        if isinstance(v, torch.Tensor):
            return v.to(d)
        if isinstance(v, tuple) and hasattr(v, "_fields"):
            return type(v)(*(to(f, d) for f in v))
        if isinstance(v, (tuple, list)):
            return type(v)(to(f, d) for f in v)
        if isinstance(v, dict):
            return {k: to(f, d) for k, f in v.items()}
        return v
    return {d: to(x, d) for d in mesh.distinct()}


def _repack(packed: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Rows of a GRM store [b, N4] (planar 2-bit) -> the store of samples
    lo .. hi - 1 alone, [b, store_width(hi - lo)], on the same device."""
    b, N4 = packed.shape
    codes = torch.stack([(packed >> (2 * p)) & 3 for p in range(4)],
                        dim=1).reshape(b, 4 * N4)[:, lo:hi]
    W = store_width(hi - lo)
    c = packed.new_zeros(b, 4 * W)
    c[:, :hi - lo] = codes
    pl = c.view(b, 4, W)
    return pl[:, 0] | (pl[:, 1] << 2) | (pl[:, 2] << 4) | (pl[:, 3] << 6)


class ShardedGrmHandle:
    """A GRM operator whose genotypes are split into contiguous sample
    ranges, one per device of the mesh; it wraps a
    :class:`~..ops.packed_grm.Packed2GRM` or the dense oracle
    :class:`~..ops.grm.GRMOperator`, as the JAX handle wraps both.

    A 2-bit range is a ``[M, store_width(N_s)]`` planar store of its own:
    the planar layout interleaves samples across byte columns, so a slice
    of the whole store's columns is not a sample range.  ``af``, ``inv``,
    ``diag`` and the missing pairs stay whole on the lead device, with
    every vector; only the genotypes are sharded.  The handle presents
    the operator interface the fitter uses (``matvec``, ``diag``,
    ``n_samples``, ``n_variants``, ``device`` = the lead, ``matvecs``,
    ``widths``), so the fit, PCG and the variance ratios run unchanged.
    A 2-bit product equals the wrapped operator's bit for bit; a dense
    one sums f64 partials over the ranges, which reassociates.

    Over a mesh that spans processes every rank builds a handle of the
    same operator (the same arguments in every process): it keeps only
    its own ranges' stores, and only the lead keeps ``af``, ``inv``,
    ``diag`` and the pairs (``None`` elsewhere).  The lead takes the
    products (``matvec``, over ``wire``, a ``distributed.Wire``); every
    other rank runs :meth:`serve` until the lead stops it.  The dense
    oracle does not span processes: it is an f64 test oracle for small N.

    ``ranges`` lists every shard's [lo, hi) samples and ``devices`` its
    device; ``stores`` and ``store_bytes`` hold this process's shards',
    those of ``mesh.local()``."""

    def __init__(self, op, mesh: Mesh):
        if isinstance(op, GRMOperator) and mesh.spans:
            raise NotImplementedError(
                "the dense GRM oracle does not span processes: it is an f64 "
                "test oracle for small N; use the 2-bit store")
        if not _same_device(op.device, mesh.home):
            what = "lead device" if mesh.is_lead else "device on this rank"
            raise ValueError(f"the operator lies on {op.device}, the mesh's "
                             f"{what} is {mesh.home}")
        self._common(mesh, op.n_samples, op.n_variants)
        if isinstance(op, Packed2GRM):
            if mesh.is_lead:
                self.af, self.inv, self.miss = op.af, op.inv, op.miss
                self.diag = op.diag
            mine = [(self.ranges[k], self.devices[k]) for k in self.parts]
            self.stores = [[] for _ in mine]
            for r0 in range(0, op.n_variants, _REPACK_ROWS):
                rows = op.packed[r0:r0 + _REPACK_ROWS]
                for k, ((lo, hi), d) in enumerate(mine):
                    self.stores[k].append(_repack(rows, lo, hi).to(d))
            self.stores = [torch.cat(s) if len(s) > 1 else s[0]
                           for s in self.stores]
            self.dense = False
        elif isinstance(op, GRMOperator):
            self.diag = op.diag
            self.stores = [op.std_geno[:, lo:hi].to(d).contiguous()
                           for (lo, hi), d in zip(self.ranges,
                                                  self.devices)]
            self.dense = True
        else:
            raise TypeError(f"cannot shard {type(op).__name__}")

    def _common(self, mesh: Mesh, n_samples: int, n_variants: int):
        self.mesh = mesh
        self.device = mesh.home
        self.devices = list(mesh.devices)
        self.ranges = sample_ranges(n_samples, mesh.size)
        self.parts = mesh.local()
        self.n_samples = int(n_samples)
        self.n_variants = int(n_variants)
        self.af = self.inv = self.miss = self.diag = None
        self.matvecs = 0
        self.widths = {}
        self.wire = None
        if mesh.spans:
            self.wire = self._connect()

    def _connect(self):
        """The group's :class:`~.distributed.Wire` for this handle, once
        every rank has agreed on the operator's shape."""
        import torch.distributed as dist
        from .distributed import Wire
        shapes = [None] * dist.get_world_size()
        dist.all_gather_object(shapes, (self.n_samples, self.n_variants))
        if len(set(shapes)) != 1:
            raise ValueError(f"the ranks built GRMs of different shapes "
                             f"(samples, variants) {shapes}: every rank "
                             f"must fit the same data")
        blocks = {}
        for (lo, hi), r in zip(self.ranges, self.mesh.ranks):
            blo, _ = blocks.get(r, (lo, hi))
            blocks[r] = (blo, hi)
        if self.mesh.is_lead:
            want = [r for r in blocks if r != self.mesh.rank]
        else:
            want = [self.mesh.rank]
        return Wire(self.device, [(r, *blocks[r]) for r in want])

    @classmethod
    def from_streamed_blocks(cls, block_iter, n_samples: int,
                             n_variants: int,
                             mesh: Mesh) -> "ShardedGrmHandle":
        """Build the sample-sharded 2-bit operator straight from streamed
        ``(idx, int8 codes [b, N])`` blocks, as the JAX package's
        ``from_streamed_blocks`` does: the whole store never exists on
        one device.  Each block's moments and missing pairs are taken
        over all samples once (``af``, ``inv``, ``diag`` and the pairs are
        global); then the block is packed per sample range on the host and
        copied into each shard's store.  Equals wrapping
        ``build_packed2_grm_streamed`` of the same blocks bit for bit.
        Over a mesh that spans processes every rank reads every block and
        stores its own ranges; only the lead takes the moments."""
        self = cls.__new__(cls)
        self.dense = False
        ranges = sample_ranges(n_samples, mesh.size)
        mine = [(ranges[k], mesh.devices[k]) for k in mesh.local()]
        self.stores = [torch.empty((n_variants, store_width(hi - lo)),
                                   dtype=torch.uint8, device=d)
                       for (lo, hi), d in mine]

        def store_rows(row0, codes):
            for ((lo, hi), _d), store in zip(mine, self.stores):
                store[row0:row0 + codes.shape[0]].copy_(torch.from_numpy(
                    _pack2_zeroed(codes[:, lo:hi])))

        if not mesh.is_lead:
            for _codes in place_rows(block_iter, n_variants, store_rows):
                pass
            self._common(mesh, n_samples, n_variants)
            return self
        af, inv, diag, mv, ms = stream_moments(block_iter, n_samples,
                                               n_variants, store_rows)
        f64 = lambda a: torch.as_tensor(a, dtype=torch.float64,
                                        device=mesh.lead)
        self._common(mesh, n_samples, n_variants)
        self.af, self.inv, self.diag = f64(af), f64(inv), f64(diag)
        self.miss = MissingPairs(torch.as_tensor(mv, device=mesh.lead),
                                 torch.as_tensor(ms, device=mesh.lead),
                                 n_variants, n_samples)
        return self

    @property
    def store_bytes(self) -> list:
        return [s.numel() * s.element_size() for s in self.stores]

    def _local_stores(self) -> list:
        return [(s, self.ranges[k][1] - self.ranges[k][0])
                for s, k in zip(self.stores, self.parts)]

    def _count(self, R: int):
        self.matvecs += 1
        C = kernel_cols(R)
        self.widths[C] = self.widths.get(C, 0) + 1

    def matvec(self, b: torch.Tensor) -> torch.Tensor:
        """GRM @ b for b [N] or [N, R] f64 on the lead device; over a mesh
        that spans processes, on the lead's rank only."""
        if not self.mesh.is_lead:
            raise RuntimeError("only the lead rank takes GRM products; the "
                               "other ranks serve() them")
        if self.dense:
            self.matvecs += 1
            return self._dense_matvec(b)
        self._count(1 if b.dim() == 1 else b.shape[1])
        return sharded_product(self._local_stores(), self.af, self.inv,
                               self.miss, b, wire=self.wire)

    def serve(self) -> int:
        """On a rank other than the lead of a mesh that spans processes:
        take the lead's products, B1 and B2 once per local range each
        (``ops/packed_grm.rank_product``), until the lead sends stop; then
        return the products served.  Raises RuntimeError when the lead
        aborts, and the group's error when a collective fails or times
        out (``init_distributed``'s ``timeout_s``)."""
        from .distributed import ABORT, PRODUCT, STOP
        if self.wire is None or self.mesh.is_lead:
            raise RuntimeError("serve() runs on a rank other than the lead "
                               "of a mesh that spans processes")
        served = 0
        while True:
            op, R = self.wire.next()
            if op == STOP:
                return served
            if op == ABORT:
                raise RuntimeError(f"rank {self.mesh.rank}: the lead rank "
                                   f"aborted the fit")
            if op != PRODUCT:
                raise RuntimeError(f"unknown header {op} from the lead")
            self._count(R)
            rank_product(self._local_stores(), self.wire, R,
                         self.n_variants)
            served += 1

    def _dense_matvec(self, b: torch.Tensor) -> torch.Tensor:
        lead = self.device
        parts = [std @ b[lo:hi].to(std.device)
                 for std, (lo, hi) in zip(self.stores, self.ranges)]
        cv = parts[0].to(lead)
        for p in parts[1:]:
            cv = cv + p.to(lead)
        outs = [std.T @ cv.to(std.device) for std in self.stores]
        return torch.cat([o.to(lead) for o in outs]) / self.n_variants
