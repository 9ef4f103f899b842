"""Device meshes for the two scale axes of the problem: the counterpart of
``saigegds_tpu/parallel/mesh.py``.

* **Samples** for the null fit.  The GRM store is what outgrows one card
  (the reference's 1M-SNP cap at N = 430,000 is a 107.5 GB 2-bit store),
  so :class:`ShardedGrmHandle` keeps it as contiguous sample ranges, one
  store per device, while every vector stays whole on the lead device.
  Each product runs kernels B1 and B2 once per range; the lead sums the
  ranges' exact integer partials, so the product equals the one-store
  product bit for bit (``ops/packed_grm.sharded_product``).
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
                              kernel_cols, sharded_product, store_width,
                              stream_moments)

_REPACK_ROWS = 1024      # store rows resharded per step (device temporaries
#                          of 4 x 8 x that many bytes per sample column)


class Mesh:
    """An ordered list of devices; the first is the lead, which holds
    every vector and does every step that spans all samples."""

    def __init__(self, devices: Sequence):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def lead(self) -> torch.device:
        return self.devices[0]

    def distinct(self) -> list:
        """The mesh's devices, each once, in mesh order."""
        return list(dict.fromkeys(self.devices))

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of the first ``n_devices`` CUDA devices (all of them by
    default), or of the explicit ``devices`` list.

    A device may repeat in ``devices``: ``["cpu"] * 3`` shards over three
    parts on the host, ``["cuda:0"] * 2`` over two parts on one card.  This
    stands in for the JAX package's virtual host devices (XLA's
    ``--xla_force_host_platform_device_count``): the sharded code paths run
    on a machine with fewer devices than parts.  Without a card,
    ``make_mesh(n)`` raises; nothing falls back to the CPU."""
    if devices is not None:
        if n_devices is not None:
            raise ValueError("give n_devices or devices, not both")
        devs = [check_device(d) for d in devices]
        for d in devs:
            if d.type == "cuda" and d.index is not None \
                    and d.index >= torch.cuda.device_count():
                raise ValueError(f"device {d} requested but only "
                                 f"{torch.cuda.device_count()} available")
        return Mesh([torch.device("cuda", torch.cuda.current_device())
                     if d.type == "cuda" and d.index is None else d
                     for d in devs])
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh: CUDA is not available (pass devices="
                           "['cpu', ...] to shard over the host)")
    count = torch.cuda.device_count()
    n = count if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"a mesh needs at least one device, got {n}")
    if n > count:
        raise ValueError(f"requested {n} devices but only {count} available")
    return Mesh([torch.device("cuda", i) for i in range(n)])


def _same_device(a: torch.device, b: torch.device) -> bool:
    idx = lambda d: (torch.cuda.current_device() if d.index is None
                     else d.index) if d.type == "cuda" else d.index
    return a.type == b.type and idx(a) == idx(b)


def check_lead(mesh: Mesh, device) -> torch.device:
    """The mesh's lead device, which must be ``device``."""
    dev = check_device(device)
    if not _same_device(mesh.lead, dev):
        raise ValueError(f"device={dev} but the mesh's lead device is "
                         f"{mesh.lead}: they must agree")
    return mesh.lead


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

    ``ranges`` lists each shard's [lo, hi) samples, ``devices`` its
    device, ``store_bytes`` its store's bytes."""

    def __init__(self, op, mesh: Mesh):
        lead = mesh.lead
        if not _same_device(op.device, lead):
            raise ValueError(f"the operator lies on {op.device}, the mesh's "
                             f"lead device is {lead}")
        self._common(mesh, op.n_samples, op.n_variants, op.diag)
        if isinstance(op, Packed2GRM):
            self.af, self.inv, self.miss = op.af, op.inv, op.miss
            self.stores = [[] for _ in self.ranges]
            for r0 in range(0, op.n_variants, _REPACK_ROWS):
                rows = op.packed[r0:r0 + _REPACK_ROWS]
                for k, (lo, hi) in enumerate(self.ranges):
                    self.stores[k].append(_repack(rows, lo, hi)
                                          .to(self.devices[k]))
            self.stores = [torch.cat(s) if len(s) > 1 else s[0]
                           for s in self.stores]
            self.dense = False
        elif isinstance(op, GRMOperator):
            self.stores = [op.std_geno[:, lo:hi].to(d).contiguous()
                           for (lo, hi), d in zip(self.ranges,
                                                  self.devices)]
            self.dense = True
        else:
            raise TypeError(f"cannot shard {type(op).__name__}")

    def _common(self, mesh: Mesh, n_samples: int, n_variants: int, diag):
        self.mesh = mesh
        self.device = mesh.lead
        self.devices = list(mesh.devices)
        self.ranges = sample_ranges(n_samples, mesh.size)
        self.n_samples = int(n_samples)
        self.n_variants = int(n_variants)
        self.diag = diag
        self.matvecs = 0
        self.widths = {}

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
        ``build_packed2_grm_streamed`` of the same blocks bit for bit."""
        self = cls.__new__(cls)
        self.dense = False
        ranges = sample_ranges(n_samples, mesh.size)
        self.stores = [torch.empty((n_variants, store_width(hi - lo)),
                                   dtype=torch.uint8, device=d)
                       for (lo, hi), d in zip(ranges, mesh.devices)]

        def store_rows(row0, codes):
            for (lo, hi), store in zip(ranges, self.stores):
                store[row0:row0 + codes.shape[0]].copy_(torch.from_numpy(
                    _pack2_zeroed(codes[:, lo:hi])))

        af, inv, diag, mv, ms = stream_moments(block_iter, n_samples,
                                               n_variants, store_rows)
        f64 = lambda a: torch.as_tensor(a, dtype=torch.float64,
                                        device=mesh.lead)
        self._common(mesh, n_samples, n_variants, f64(diag))
        self.af, self.inv = f64(af), f64(inv)
        self.miss = MissingPairs(torch.as_tensor(mv, device=mesh.lead),
                                 torch.as_tensor(ms, device=mesh.lead),
                                 n_variants, n_samples)
        return self

    @property
    def store_bytes(self) -> list:
        return [s.numel() * s.element_size() for s in self.stores]

    def matvec(self, b: torch.Tensor) -> torch.Tensor:
        """GRM @ b for b [N] or [N, R] f64 on the lead device."""
        self.matvecs += 1
        if self.dense:
            return self._dense_matvec(b)
        C = kernel_cols(1 if b.dim() == 1 else b.shape[1])
        self.widths[C] = self.widths.get(C, 0) + 1
        return sharded_product(
            [(s, hi - lo) for s, (lo, hi) in zip(self.stores, self.ranges)],
            self.af, self.inv, self.miss, b)

    def _dense_matvec(self, b: torch.Tensor) -> torch.Tensor:
        lead = self.device
        parts = [std @ b[lo:hi].to(std.device)
                 for std, (lo, hi) in zip(self.stores, self.ranges)]
        cv = parts[0].to(lead)
        for p in parts[1:]:
            cv = cv + p.to(lead)
        outs = [std.T @ cv.to(std.device) for std in self.stores]
        return torch.cat([o.to(lead) for o in outs]) / self.n_variants
