"""The 2-bit GRM operator of ``saigegds_tpu/ops/packed_grm.py``: the
signed-7-bit slice decomposition of f64 vectors, the planar 2-bit code
pack, and :class:`Packed2GRM`, whose matvec runs kernels B1 and B2.

A float64 matrix decomposes into S signed-7-bit integer slices
``v ~= scale * sum_s d_s / (64 * 128^s)`` with ``|d_s| <= 64``; a product of
small integer genotype codes with the slices is an exact integer
contraction, and the slices recombine in f64 to ~2^-53 relative.

The GRM is ``G_std' G_std / M`` with ``s(c) = (c - 2 af) * inv`` for codes
``c`` in {0, 1, 2} and ``s(missing) = 0``.  The store keeps the codes 2-bit
planar-packed with missing zeroed (0.25 B/genotype, the reference's
footprint) as one contiguous ``[M, N4]`` uint8 tensor, N4 =
:func:`store_width` (ceil(N/4) rounded up to a multiple of 16, so that
every row starts 16-byte aligned for kernels B1 and B2; the extra byte
columns are padding samples of code 0), so

    G_std @ v = diag(inv) @ (Cm @ v - 2 af * (mask @ v))

where the missing entries' share of ``mask @ v`` (and of the transpose's
centering term) is corrected from the sparse (variant, sample) pair lists
(:class:`MissingPairs`).  A product also runs over a store kept as sample
ranges, one per device (:func:`sharded_product`, ``parallel/mesh.py``).
The JAX package's tile/leaf split of the store existed for its compiler
and is not ported.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import grm_kernel
from .grm_kernel import N_SLICES
from ..utils import profiling


def _slice_i8(x: torch.Tensor, n_slices: int):
    """Decompose f64 [N, R] into signed-7-bit slices -> int8 [N, R, S],
    f64 scales [R].

    x[:, r] ~= scale[r] * sum_s d[:, r, s] / (64 * 128**s), |d| <= 64,
    residual <= scale * 2**(-7*n_slices).  A CUDA tensor goes through the
    slice kernels (``grm_kernel.slice_i8``, S = N_SLICES, or raises), a
    CPU tensor through :func:`_slice_i8_plain`; both give the same bytes."""
    if x.device.type == "cuda":
        if n_slices != N_SLICES:
            raise ValueError(f"the slice kernels make {N_SLICES} slices, "
                             f"not {n_slices}")
        return grm_kernel.slice_i8(x)
    return _slice_i8_plain(x, n_slices)


def _slice_i8_plain(x: torch.Tensor, n_slices: int):
    """Plain PyTorch version of :func:`_slice_i8`.  ``torch.round`` rounds
    half to even like ``jnp.round``, so the slices are bit-identical to the
    JAX package's.
    """
    amax = torch.amax(torch.abs(x), dim=0)
    scale = torch.where(amax > 0, amax, torch.ones_like(amax))
    rem = x / scale
    ds = []
    for _ in range(n_slices):
        d = torch.round(rem * 64.0)
        ds.append(d.to(torch.int8))
        rem = (rem - d / 64.0) * 128.0
    return torch.stack(ds, dim=-1), scale          # [N, R, S], [R]


def pack_codes_2bit(codes: np.ndarray) -> np.ndarray:
    """Planar 2-bit pack: int8/uint8 [M, N] values 0..3 -> uint8 [M, N4].

    Byte column ``j`` holds samples ``j, N4+j, 2*N4+j, 3*N4+j`` in bit
    pairs 0/2/4/6 (N4 = ceil(N/4); the tail pads with 0), so the decode
    ``(packed >> 2p) & 3`` yields contiguous natural-order sample planes.
    """
    codes = np.asarray(codes)
    M, N = codes.shape
    N4 = -(-N // 4)
    c = np.zeros((M, 4 * N4), np.uint8)
    c[:, :N] = codes
    pl = c.reshape(M, 4, N4)
    return pl[:, 0] | (pl[:, 1] << 2) | (pl[:, 2] << 4) | (pl[:, 3] << 6)


def store_width(n_samples: int) -> int:
    """Byte columns N4 of the GRM store for ``n_samples``: ceil(N/4)
    rounded up to a multiple of 16 (at most 15 more than the scan's
    ``pack_codes_2bit``), so that every packed row starts 16-byte aligned,
    as the TMA tensor map through which kernels B1 and B2 read the store
    requires."""
    return 16 * -(-int(n_samples) // 64)


def unpack_codes_2bit(packed: np.ndarray, n_samples: int) -> np.ndarray:
    """Inverse of :func:`pack_codes_2bit` (host-side, for tests/tools)."""
    M, N4 = packed.shape
    planes = np.stack([(packed >> (2 * p)) & 3 for p in range(4)], axis=1)
    return planes.reshape(M, 4 * N4)[:, :n_samples].astype(np.int8)


# ---------------------------------------------------------------------------
# host-side build (numpy; the same moments as the JAX package's)


def _variant_moments(codes: np.ndarray):
    """Per-variant af / inv std / diag partials / missing pairs from int8
    codes [b, N] (>= 3 missing).

    The native threaded one-pass kernel when it builds
    (``saigegds_tpu/native/fastio.cpp`` ``sg_variant_moments``); blockwise
    numpy otherwise."""
    codes = np.ascontiguousarray(codes, dtype=np.int8)
    from ..io import native
    r = native.variant_moments(codes)
    if r is not None:
        return r
    M, N = codes.shape
    af = np.empty(M)
    inv = np.empty(M)
    diag = np.zeros(N)
    mvs, mss = [], []
    B = max(1, min(M, (1 << 28) // max(8 * N, 1)))   # ~256 MB f64 temps
    for i in range(0, M, B):
        c = codes[i:i + B]
        valid = c < 3
        n_valid = valid.sum(axis=1)
        s = np.where(valid, c, 0).sum(axis=1, dtype=np.int64)
        with np.errstate(divide="ignore", invalid="ignore"):
            a = s / (2.0 * n_valid)
            iv = 1.0 / np.sqrt(2.0 * a * (1.0 - a))
        bad = ~np.isfinite(a) | ~np.isfinite(iv)
        a = np.where(bad, 0.0, a)
        iv = np.where(bad, 0.0, iv)
        std = np.where(valid, (c - 2.0 * a[:, None]) * iv[:, None], 0.0)
        diag += (std * std).sum(axis=0)
        mv, ms = np.nonzero(~valid)
        mvs.append((mv + i).astype(np.int32))
        mss.append(ms.astype(np.int32))
        af[i:i + B] = a
        inv[i:i + B] = iv
    mv = np.concatenate(mvs) if mvs else np.empty(0, np.int32)
    ms = np.concatenate(mss) if mss else np.empty(0, np.int32)
    return af, inv, diag, mv, ms


def _pack2_zeroed(codes: np.ndarray) -> np.ndarray:
    """The GRM store's rows of int8 codes [M, N]: planar 2-bit pack with
    missing zeroed (native kernel or numpy), [M, store_width(N)]; the
    padding samples are code 0."""
    from ..io import native
    N = codes.shape[1]
    if 4 * store_width(N) != N:
        codes = np.pad(codes, ((0, 0), (0, 4 * store_width(N) - N)))
    out = native.pack2_zeroed(codes)
    if out is not None:
        return out
    return pack_codes_2bit(np.where(codes < 3, codes, 0))




# ---------------------------------------------------------------------------
# the missing pairs


def _first_index(sorted_idx: torch.Tensor, n: int) -> torch.Tensor:
    """For i < n, the position of the first entry >= i of ``sorted_idx``:
    where segment i of a sorted pair list starts."""
    return torch.searchsorted(sorted_idx.contiguous(), torch.arange(
        n, dtype=sorted_idx.dtype, device=sorted_idx.device))


def _segment_sums(idx: torch.Tensor, start: torch.Tensor,
                  src: torch.Tensor) -> torch.Tensor:
    """Row k: the sum of ``src[idx[j]]`` over the pairs j of segment k
    (``start[k]`` up to the next segment's start), added one after another
    from zero -- ``embedding_bag``'s sum, whose kernel on a card and loop on
    the CPU both keep that order."""
    if idx.numel() == 0:
        return src.new_zeros(start.numel(), src.shape[1])
    if idx.dtype == torch.int32 and src.numel() >= 1 << 31:
        idx, start = idx.long(), start.long()
    return F.embedding_bag(idx, src, start, mode="sum")


class MissingPairs:
    """The missing (variant, sample) pairs of a GRM store, sorted once when
    the store is built, so that each of the product's two corrections is a
    segment sum in a fixed order.

    ``samp`` holds the pairs' samples sorted by variant and ``var_start``
    [M] where each variant's pairs start; ``var`` holds their variants
    sorted by sample and ``samp_start`` [N] where each sample's pairs
    start (both sorts stable, so each segment keeps the order of the lists
    given: (variant, sample) order from the builds).  The lists are int32
    while they hold fewer than 2^31 pairs: 8 B per pair, beside (M + N)
    starts.  A segment's rows add in list order from zero, on a card as on
    the CPU, so a product does not depend on thread timing, and on the CPU
    the sums equal ``index_add_`` over the same lists bit for bit."""

    def __init__(self, miss_var, miss_samp, n_variants: int,
                 n_samples: int):
        mv = torch.as_tensor(miss_var).to(torch.int64)
        ms = torch.as_tensor(miss_samp).to(mv.device, torch.int64)
        dt = torch.int32 if mv.numel() < 1 << 31 else torch.int64
        self.n_variants, self.n_samples = int(n_variants), int(n_samples)
        ms_sorted, order = torch.sort(ms, stable=True)
        self.var = mv[order].to(dt)
        self.samp_start = _first_index(ms_sorted, self.n_samples).to(dt)
        del ms_sorted, order
        if mv.numel() > 1 and not bool((mv[1:] >= mv[:-1]).all()):
            order = torch.sort(mv, stable=True).indices
            mv, ms = mv[order], ms[order]
        self.samp = ms.to(dt)
        self.var_start = _first_index(mv, self.n_variants).to(dt)

    def __len__(self) -> int:
        return self.samp.numel()

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in
                   (self.samp, self.var_start, self.var, self.samp_start))

    def variants(self) -> torch.Tensor:
        """The pairs' variants, in the order of ``samp``."""
        ends = torch.cat([self.var_start[1:], self.var_start.new_tensor(
            [len(self)])])
        return torch.repeat_interleave(
            torch.arange(self.n_variants, dtype=self.samp.dtype,
                         device=self.samp.device), ends - self.var_start)

    def per_variant(self, B: torch.Tensor) -> torch.Tensor:
        """[M, R]: each variant's sum of ``B`` [N, R] over its missing
        samples."""
        return _segment_sums(self.samp, self.var_start, B)

    def per_sample(self, W: torch.Tensor) -> torch.Tensor:
        """[N, R]: each sample's sum of ``W`` [M, R] over the variants it
        misses."""
        return _segment_sums(self.var, self.samp_start, W)


# ---------------------------------------------------------------------------
# the operator


class Packed2GRM:
    """GRM operator over 2-bit planar-packed genotypes resident on a device.

    ``packed`` uint8 [M, N4] (missing zeroed), ``af``/``inv`` f64 [M],
    ``diag`` f64 [N] = diag(GRM), and the missing entries, given as two
    index lists ``miss_var``/``miss_samp`` of equal length and kept as
    :class:`MissingPairs` (``miss``), all on one device.  ``matvecs``
    counts the products taken, and ``widths`` the products by the column
    count C that kernels B1 and B2 ran at (:func:`kernel_cols`)."""

    def __init__(self, packed, af, inv, diag, miss_var, miss_samp,
                 n_samples: int):
        self.packed = packed
        self.af = af
        self.inv = inv
        self.diag = diag
        self.n_variants = packed.shape[0]
        self.n_samples = int(n_samples)
        self.miss = MissingPairs(miss_var, miss_samp, self.n_variants,
                                 self.n_samples)
        self.device = packed.device
        self.matvecs = 0
        self.widths = {}

    @property
    def miss_var(self) -> torch.Tensor:
        return self.miss.variants()

    @property
    def miss_samp(self) -> torch.Tensor:
        return self.miss.samp

    @profiling.entry()
    def matvec(self, b: torch.Tensor) -> torch.Tensor:
        """GRM @ b for b [N] or [N, R] f64 on this operator's device."""
        self.matvecs += 1
        C = kernel_cols(1 if b.dim() == 1 else b.shape[1])
        self.widths[C] = self.widths.get(C, 0) + 1
        return sharded_product([(self.packed, self.n_samples)], self.af,
                               self.inv, self.miss, b)

    @classmethod
    def from_arrays(cls, packed, af, inv, diag, miss_var, miss_samp,
                    miss_pad=None, *, n_samples: int,
                    device) -> "Packed2GRM":
        """Carry an operator across as numpy arrays: ``packed`` [M, N4]
        (the JAX store's leaves and tiles concatenated back; a store of
        another width than :func:`store_width` is packed again to it),
        ``af``, ``inv``, ``diag`` and the missing-pair lists.
        ``miss_pad`` (the JAX package's 1.0/0.0 marks of its padded lists)
        drops the padding entries."""
        packed = np.asarray(packed, np.uint8)
        if packed.shape[1] != store_width(n_samples):
            packed = _pack2_zeroed(unpack_codes_2bit(packed, n_samples))
        mv = np.asarray(miss_var, np.int64)
        ms = np.asarray(miss_samp, np.int64)
        if miss_pad is not None:
            real = np.asarray(miss_pad) > 0
            mv, ms = mv[real], ms[real]
        f64 = lambda a: torch.tensor(np.asarray(a, np.float64),
                                     device=device)
        return cls(torch.tensor(packed, device=device),
                   f64(af), f64(inv), f64(diag),
                   torch.tensor(mv, device=device),
                   torch.tensor(ms, device=device), n_samples)


def build_packed2_grm(codes: np.ndarray, *, device) -> Packed2GRM:
    """Build the operator on ``device`` from int8 codes [M, N] (3 =
    missing)."""
    codes = np.ascontiguousarray(codes, dtype=np.int8)
    M, N = codes.shape
    af, inv, diag, mv, ms = _variant_moments(codes)
    return Packed2GRM.from_arrays(_pack2_zeroed(codes), af, inv, diag / M,
                                  mv, ms, n_samples=N, device=device)


def place_rows(block_iter, n_variants: int, store_rows):
    """Feed ``(idx, int8 codes [b, N])`` blocks to ``store_rows(row0,
    codes)``, which places them in the store(s), and yield ``codes`` of
    each block after it; raises unless the blocks hold ``n_variants`` rows
    in all."""
    row0 = 0
    for _idx, codes in block_iter:
        codes = np.ascontiguousarray(codes, dtype=np.int8)
        b = codes.shape[0]
        if row0 + b > n_variants:
            raise ValueError(f"block iterator yielded more than "
                             f"n_variants={n_variants} rows")
        store_rows(row0, codes)
        yield codes
        row0 += b
    if row0 != n_variants:
        raise ValueError(f"block iterator yielded {row0} rows, "
                         f"n_variants={n_variants}")


def stream_moments(block_iter, n_samples: int, n_variants: int, store_rows):
    """The host half of a streamed build: ``_variant_moments`` of each
    ``(idx, int8 codes [b, N])`` block over all samples, while
    ``store_rows(row0, codes)`` places the block's rows in the store(s)
    (:func:`place_rows`).  Returns f64 af, inv, diag / M and the int64
    missing-pair lists, all numpy; raises unless the blocks hold
    ``n_variants`` rows."""
    af_parts, inv_parts, miss_v, miss_s = [], [], [], []
    diag = np.zeros(n_samples, np.float64)
    row0 = 0
    for codes in place_rows(block_iter, n_variants, store_rows):
        af, inv, diag_part, mv, ms = _variant_moments(codes)
        diag += diag_part
        miss_v.append(mv.astype(np.int64) + row0)
        miss_s.append(ms.astype(np.int64))
        af_parts.append(af)
        inv_parts.append(inv)
        row0 += codes.shape[0]
    cat = lambda parts, dt: np.concatenate(parts) if parts else \
        np.empty(0, dt)
    return (cat(af_parts, np.float64), cat(inv_parts, np.float64),
            diag / n_variants, cat(miss_v, np.int64), cat(miss_s, np.int64))


def build_packed2_grm_streamed(block_iter, n_samples: int, n_variants: int,
                               *, device) -> Packed2GRM:
    """Streamed build from ``(idx, int8 codes [b, N])`` blocks that hold
    ``n_variants`` rows in all: host peak memory is one block; the store is
    allocated once on ``device`` (device peak: the store) and each block is
    packed on the host and copied into it at once.

    Equals :func:`build_packed2_grm` on the concatenated codes exactly,
    except ``diag``: its per-block partial sums reassociate, so it agrees
    to a few ulps (as in the JAX package)."""
    store = torch.empty((n_variants, store_width(n_samples)),
                        dtype=torch.uint8, device=device)

    def store_rows(row0, codes):
        store[row0:row0 + codes.shape[0]].copy_(
            torch.from_numpy(_pack2_zeroed(codes)))

    af, inv, diag, mv, ms = stream_moments(block_iter, n_samples,
                                           n_variants, store_rows)
    f64 = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)
    return Packed2GRM(store, f64(af), f64(inv), f64(diag),
                      torch.as_tensor(mv, device=device),
                      torch.as_tensor(ms, device=device), n_samples)


def kernel_cols(R: int) -> int:
    """Columns C of kernels B1 and B2 in a product of R right-hand sides:
    their N_SLICES slices each, padded to a column count the kernels run
    (``grm_kernel.padded_cols``)."""
    return grm_kernel.padded_cols(R * N_SLICES)


def _slice_weights(scale: torch.Tensor, S: int) -> torch.Tensor:
    """[1, R, S] weights that recombine S slices: scale / 64 / 128^s."""
    return scale[None, :, None] / 64.0 * (1.0 / 128.0) ** torch.arange(
        S, dtype=torch.float64, device=scale.device)[None, None, :]


def _pad_cols(x: torch.Tensor, C: int) -> torch.Tensor:
    """Zero-pad the last axis of int8 ``x`` to ``C`` columns."""
    if x.shape[-1] == C:
        return x.contiguous()
    out = x.new_zeros(*x.shape[:-1], C)
    out[..., :x.shape[-1]] = x
    return out


def t_rows(out4: torch.Tensor, n: int) -> torch.Tensor:
    """One store's pass-2 result of kernel B2, f64 [4, N4, C] in planar
    order, as its first ``n`` samples' rows [n, C] in natural order (a
    view: plane p holds samples p N4 .. p N4 + N4 - 1)."""
    return out4.view(-1, out4.shape[-1])[:n]


def ranges_fwd(stores, d_rows: torch.Tensor, C: int,
               out: torch.device) -> torch.Tensor:
    """Pass 1 over consecutive sample ranges: kernel B1 of each ``(store,
    n)`` of ``stores`` against its rows of ``d_rows`` int8 [sum n, RS],
    every range launched before any result is read back; the sum of their
    exact integer partials, f64 [M, C] on ``out`` (exact: integers below
    2^53)."""
    parts, n0 = [], 0
    for packed, n in stores:
        parts.append(grm_kernel.plane_dot_fwd_rows(packed, d_rows[n0:n0 + n],
                                                    C))
        n0 += n
    acc = parts[0].to(out)
    for p in parts[1:]:
        acc = acc + p.to(out)
    return acc


def ranges_t(stores, dm: torch.Tensor, out: torch.device) -> torch.Tensor:
    """Pass 2 over consecutive sample ranges: kernel B2 of each store
    against ``dm`` int8 [M, C], every range launched before any result is
    read back; their samples' rows, f64 [sum n, C] in sample order on
    ``out``."""
    parts = [grm_kernel.plane_dot_t(packed, dm.to(packed.device))
             for packed, _n in stores]
    rows = [t_rows(p, n).to(out) for p, (_s, n) in zip(parts, stores)]
    return rows[0] if len(rows) == 1 else torch.cat(rows)


@profiling.spanned("grm.product")
def sharded_product(stores, af, inv, miss: MissingPairs,
                    b: torch.Tensor, wire=None) -> torch.Tensor:
    """GRM @ b over a store kept as contiguous sample ranges: the lead's
    part of the product.

    ``stores`` lists ``(uint8 [M, store_width(n)] store, n)`` per range, in
    sample order, each on its own device; ``af``, ``inv``, ``miss`` and
    ``b`` (f64 [N] or [N, R]) lie on the lead device, which takes every
    step that spans all samples: the slices of ``b`` (one scale over all
    N), the sum of the ranges' B1 partials, the f64 recombinations and the
    missing-pair corrections.  Kernels B1 and B2 run once per range on its
    device (:func:`ranges_fwd`, :func:`ranges_t`).  With ``wire``
    (``parallel/distributed.Wire``) the ranges of ``stores`` are the
    first samples, and the other ranks of a process group hold the rest:
    they get their slice rows and the B2 operand and return their B1
    partials and B2 rows (:func:`rank_product`), their kernels running
    while the lead's do.  The integers are exactly those of one store, so
    the product does not depend on the split, bit for bit.  One range is
    the operator's own product.

    The algebra of the JAX package's ``_packed2_grm_matvec`` with
    ``impl="pallas"``: kernel B1 takes the slices of ``b``, kernel B2 the
    slices of the weighted per-variant vectors; both results are exact
    integers, recombined with the slice weights in f64.  The missing-pair
    corrections are segment sums over the pair lists sorted at build time
    (:class:`MissingPairs`): deterministic on a card, and equal to the
    ``index_add_`` form on the CPU bit for bit.

    Under a profiler the product is the span ``grm.product``, and
    consecutive device spans of four names split its work on the lead's
    stream: ``grm.slice`` (the two slice decompositions), ``grm.kernels``
    (B1, its layout kernel and B2, with the exchanges of ``wire``),
    ``grm.corrections`` (the two missing-pair sums) and ``grm.combine``
    (the f64 recombinations)."""
    squeeze = b.dim() == 1
    B = (b[:, None] if squeeze else b).to(torch.float64)
    lead = B.device
    M = af.shape[0]
    N, R = B.shape
    S = N_SLICES
    RS = R * S
    Cpad = kernel_cols(R)
    part = profiling.device_parts(lead)

    # pass 1: cv = Cm @ b (padded samples meet zero slice rows)
    with part("grm.slice"):
        d, scale = _slice_i8(B, S)                    # [N, R, S]
        d = d.reshape(N, RS)
    n_here = sum(n for _s, n in stores)
    with part("grm.kernels"):
        sent = wire.post_slices(R, d) if wire is not None else None
        acc = ranges_fwd(stores, d[:n_here], Cpad, lead)[:, :RS]
        if wire is not None:
            acc = acc + wire.sum_partials(sent, M, RS).to(lead,
                                                          torch.float64)
    with part("grm.combine"):
        cv = torch.sum(acc.reshape(M, R, S) * _slice_weights(scale, S),
                       dim=-1)
    with part("grm.corrections"):
        corr1 = miss.per_variant(B)
    with part("grm.combine"):
        mv = torch.sum(B, dim=0)[None, :] - corr1
        gv = inv[:, None] * (cv - 2.0 * af[:, None] * mv)   # [M, R]
        # pass 2: out = Cm' w1 - (sum(w2) - corr2), natural sample order
        w1 = inv[:, None] * gv
        w2 = 2.0 * af[:, None] * inv[:, None] * gv
    with part("grm.slice"):
        d2, scale2 = _slice_i8(w1, S)                  # [M, R, S]
        dm = d2.reshape(M, RS)
    with part("grm.kernels"):
        sent = wire.post_operand(dm) if wire is not None else None
        rows = ranges_t(stores, _pad_cols(dm, Cpad), lead)[:, :RS]
        if wire is not None:
            rows = torch.cat([rows] + [r.to(lead, torch.float64)
                                       for r in wire.gather_rows(sent, RS)])
    with part("grm.combine"):
        out = torch.sum(rows.reshape(N, R, S) * _slice_weights(scale2, S),
                        dim=-1)
    with part("grm.corrections"):
        corr2 = miss.per_sample(w2)
    with part("grm.combine"):
        out = (out - (torch.sum(w2, dim=0)[None, :] - corr2)) / M
        return out[:, 0] if squeeze else out


def rank_product(stores, wire, R: int, M: int):
    """A rank's part of :func:`sharded_product` over a process group: its
    consecutive ranges ``stores`` (as there) against the slice rows that
    ``wire`` brings, B1 once per range, the partials' sum sent back as
    int32 [M, R * 8]; then B2 once per range against the operand, the
    rows sent back as int32 [n, R * 8].  Only the live R * 8 columns
    travel, not the kernels' padded C; the integers are exact in int32
    (``parallel/distributed.Wire``)."""
    RS, C = R * N_SLICES, kernel_cols(R)
    dev = stores[0][0].device
    d = wire.recv_slices(RS).to(dev)
    wire.reduce_partials(ranges_fwd(stores, d, C, dev)[:, :RS]
                         .to(torch.int32))
    dm = _pad_cols(wire.recv_operand(M, RS).to(dev), C)
    wire.send_rows(ranges_t(stores, dm, dev)[:, :RS].to(torch.int32))


def packed2_grm_matvec(packed, af, inv, miss_var, miss_samp,
                       b: torch.Tensor) -> torch.Tensor:
    """GRM @ b from one 2-bit store and its missing-pair lists (any order);
    b [N] or [N, R] f64.  Sorts the lists for this one product
    (:class:`MissingPairs`); an operator sorts them once
    (:class:`Packed2GRM`).  See :func:`sharded_product`."""
    N = b.shape[0]
    return sharded_product([(packed, N)], af, inv,
                           MissingPairs(miss_var, miss_samp,
                                        packed.shape[0], N), b)
