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
:func:`store_width` (ceil(N/4) rounded up to a multiple of 4, so that every
row starts 4-byte aligned for kernels B1 and B2; the extra byte columns
are padding samples of code 0), so

    G_std @ v = diag(inv) @ (Cm @ v - 2 af * (mask @ v))

where the missing entries' share of ``mask @ v`` (and of the transpose's
centering term) is corrected from the sparse (variant, sample) pair lists.
The JAX package's tile/leaf split of the store existed for its compiler
and is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from . import grm_kernel

N_SLICES = 8   # 7 bits/slice -> ~56-bit effective mantissa (full f64)


def _slice_i8(x: torch.Tensor, n_slices: int):
    """Decompose f64 [N, R] into signed-7-bit slices.

    x[:, r] ~= scale[r] * sum_s d[:, r, s] / (64 * 128**s), |d| <= 64,
    residual <= scale * 2**(-7*n_slices).  ``torch.round`` rounds half to
    even like ``jnp.round``, so the slices are bit-identical to the JAX
    package's.
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
    rounded up to a multiple of 4 (at most 3 more than the scan's
    ``pack_codes_2bit``), so that every packed row starts 4-byte aligned
    and kernels B1 and B2 load four byte columns of a row as one word."""
    return 4 * -(-int(n_samples) // 16)


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
# the operator


class Packed2GRM:
    """GRM operator over 2-bit planar-packed genotypes resident on a device.

    ``packed`` uint8 [M, N4] (missing zeroed), ``af``/``inv`` f64 [M],
    ``diag`` f64 [N] = diag(GRM), and the missing entries as two int64
    index lists ``miss_var``/``miss_samp`` of equal length, all on one
    device.  ``matvecs`` counts the products taken, and ``widths`` the
    products by the column count C that kernels B1 and B2 ran at
    (:func:`kernel_cols`)."""

    def __init__(self, packed, af, inv, diag, miss_var, miss_samp,
                 n_samples: int):
        self.packed = packed
        self.af = af
        self.inv = inv
        self.diag = diag
        self.miss_var = miss_var
        self.miss_samp = miss_samp
        self.n_variants = packed.shape[0]
        self.n_samples = int(n_samples)
        self.device = packed.device
        self.matvecs = 0
        self.widths = {}

    def matvec(self, b: torch.Tensor) -> torch.Tensor:
        """GRM @ b for b [N] or [N, R] f64 on this operator's device."""
        self.matvecs += 1
        C = kernel_cols(1 if b.dim() == 1 else b.shape[1])
        self.widths[C] = self.widths.get(C, 0) + 1
        return packed2_grm_matvec(self.packed, self.af, self.inv,
                                  self.miss_var, self.miss_samp, b)

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


def build_packed2_grm_streamed(block_iter, n_samples: int, n_variants: int,
                               *, device) -> Packed2GRM:
    """Streamed build from ``(idx, int8 codes [b, N])`` blocks that hold
    ``n_variants`` rows in all: host peak memory is one block; the store is
    allocated once on ``device`` (device peak: the store) and each block is
    packed on the host and copied into it at once.

    Equals :func:`build_packed2_grm` on the concatenated codes exactly,
    except ``diag``: its per-block partial sums reassociate, so it agrees
    to a few ulps (as in the JAX package)."""
    af_parts, inv_parts, miss_v, miss_s = [], [], [], []
    diag = np.zeros(n_samples, np.float64)
    store = torch.empty((n_variants, store_width(n_samples)),
                        dtype=torch.uint8, device=device)
    row0 = 0
    for _idx, codes in block_iter:
        codes = np.ascontiguousarray(codes, dtype=np.int8)
        b = codes.shape[0]
        if row0 + b > n_variants:
            raise ValueError(f"block iterator yielded more than "
                             f"n_variants={n_variants} rows")
        af, inv, diag_part, mv, ms = _variant_moments(codes)
        diag += diag_part
        miss_v.append(mv.astype(np.int64) + row0)
        miss_s.append(ms.astype(np.int64))
        af_parts.append(af)
        inv_parts.append(inv)
        store[row0:row0 + b].copy_(torch.from_numpy(_pack2_zeroed(codes)))
        row0 += b
    M = row0
    if M != n_variants:
        raise ValueError(f"block iterator yielded {M} rows, "
                         f"n_variants={n_variants}")
    cat = lambda parts, dt: np.concatenate(parts) if parts else \
        np.empty(0, dt)
    f64 = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)
    return Packed2GRM(store, f64(cat(af_parts, np.float64)),
                      f64(cat(inv_parts, np.float64)), f64(diag / M),
                      torch.as_tensor(cat(miss_v, np.int64), device=device),
                      torch.as_tensor(cat(miss_s, np.int64), device=device),
                      n_samples)


def kernel_cols(R: int) -> int:
    """Columns C of kernels B1 and B2 in a product of R right-hand sides:
    their N_SLICES slices each, padded to a multiple of 128."""
    return -(-R * N_SLICES // 128) * 128


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


def packed2_grm_matvec(packed, af, inv, miss_var, miss_samp,
                       b: torch.Tensor) -> torch.Tensor:
    """GRM @ b from the 2-bit store; b [N] or [N, R] f64.

    The algebra of the JAX package's ``_packed2_grm_matvec`` with
    ``impl="pallas"`` on a store of any width N4 >= ceil(N/4): kernel B1
    takes the slices of ``b`` (padded to 4 N4 samples and to a multiple of 128 columns), kernel B2 the slices of the
    weighted per-variant vectors; both results are exact integers,
    recombined with the slice weights in f64.  The missing-pair
    corrections are ``index_add_`` in f64 (on a CUDA device through f64
    atomics, so they may differ in the last bits from run to run)."""
    squeeze = b.dim() == 1
    B = (b[:, None] if squeeze else b).to(torch.float64)
    M, N4 = packed.shape
    Npad = 4 * N4
    N, R = B.shape
    S = N_SLICES
    RS = R * S
    Cpad = kernel_cols(R)

    # pass 1: cv = Cm @ b (padded samples meet zero slice rows)
    Bp = torch.zeros(Npad, R, dtype=torch.float64, device=B.device)
    Bp[:N] = B
    d, scale = _slice_i8(Bp, S)                       # [Npad, R, S]
    d4 = _pad_cols(d.reshape(Npad, RS), Cpad).view(4, N4, Cpad)
    acc = grm_kernel.plane_dot_fwd(packed, d4)[:, :RS]
    cv = torch.sum(acc.reshape(M, R, S) * _slice_weights(scale, S), dim=-1)

    corr1 = torch.zeros(M, R, dtype=torch.float64, device=B.device)
    corr1.index_add_(0, miss_var, B[miss_samp])
    mv = torch.sum(B, dim=0)[None, :] - corr1
    gv = inv[:, None] * (cv - 2.0 * af[:, None] * mv)   # [M, R]

    # pass 2: out = Cm' w1 - (sum(w2) - corr2), natural sample order
    w1 = inv[:, None] * gv
    w2 = 2.0 * af[:, None] * inv[:, None] * gv
    d2, scale2 = _slice_i8(w1, S)                      # [M, R, S]
    dm = _pad_cols(d2.reshape(M, RS), Cpad)
    acc4 = grm_kernel.plane_dot_t(packed, dm)[:, :, :RS]
    pl4 = torch.sum(acc4.reshape(4, N4, R, S) * _slice_weights(scale2, S)[None],
                    dim=-1)
    out = pl4.reshape(Npad, R)[:N]

    corr2 = torch.zeros(N, R, dtype=torch.float64, device=B.device)
    corr2.index_add_(0, miss_samp, w2[miss_var])
    out = (out - (torch.sum(w2, dim=0)[None, :] - corr2)) / M
    return out[:, 0] if squeeze else out
