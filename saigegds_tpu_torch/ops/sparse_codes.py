"""Sparse genotype-code transport: gap-coded uint16 entries, and their
decode on the device (kernel B5).

The counterpart of ``saigegds_tpu/ops/sparse_codes.py``.  The host half is
the encoder; the device half is :func:`decode_codes`, which on a CUDA
tensor launches the hand-written kernel ``csrc/decode_codes.cu`` (replacing
``saigegds_tpu/ops/pallas_sparse.py::decode_codes_pallas``) and on a CPU
tensor runs the plain PyTorch version :func:`decode_codes_plain` (the
cumsum-and-scatter of the JAX package's ``decode_codes``).

The format:

- every nonzero code (1, 2, or 3=missing) is ONE uint16 entry
  ``(gap << 2) | code`` where ``gap`` = distance-1 to the previous nonzero
  in the row (14 bits);
- a gap larger than 16383 is bridged by escape entries with ``code == 0``
  (they advance the cursor without writing);
- rows are concatenated into a flat stream with an int32 ``row_ptr``
  offset table [B+1] (CSR-style).

For a variant with nonzero fraction f the stream costs ``2*f`` bytes per
sample against 0.25 for the 2-bit planar block.  The decode is exact, so
every kernel downstream sees the codes the host held.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from . import _cuda

GAP_BITS = 14
MAX_GAP = (1 << GAP_BITS) - 1          # stored gap field (distance - 1)
ESC_STEP = MAX_GAP + 1                 # cursor advance of an escape entry

# sparse transport wins when 2 bytes/entry < 0.25 bytes/sample * N / nnz
SPARSE_NNZ_FRAC = 1.0 / 8.0

# kernel launches (not plain-version calls)
LAUNCHES = {"decode_codes": 0}


def encode_sparse_rows(codes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Encode an int8 code block [B, N] (0/1/2, 3=missing) into the flat
    uint16 entry stream + int32 row_ptr [B+1].

    The hot path is the SIMD C kernel (``native/fastio.cpp``
    ``sg_sparse_encode``); the numpy body is the fallback and the
    semantics reference."""
    codes = np.ascontiguousarray(codes, dtype=np.int8)
    B, N = codes.shape
    if B * N >= 1 << 31:
        # row_ptr and the JAX package's decoder cursor are int32
        raise ValueError(f"block {B}x{N} exceeds the int32 decode bound; "
                         "reduce the block size")
    from ..io import native
    enc = native.sparse_encode(codes)
    if enc is not None:
        return enc
    return _encode_sparse_rows_np(codes)


def _encode_sparse_rows_np(codes: np.ndarray
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Pure-numpy encoder (one nonzero pass; escape entries inserted by a
    repeat/cumsum expansion)."""
    B, N = codes.shape
    rows, cols = np.nonzero(codes)
    vals = codes[rows, cols].astype(np.uint16)
    counts = np.bincount(rows, minlength=B).astype(np.int64)
    starts = np.zeros(B + 1, np.int64)
    np.cumsum(counts, out=starts[1:])

    L0 = len(cols)
    if L0 == 0:
        return np.zeros(0, np.uint16), np.zeros(B + 1, np.int32)
    prev = np.empty(L0, np.int64)
    prev[1:] = cols[:-1]
    prev[starts[:-1][counts > 0]] = -1
    dist = cols - prev                              # >= 1
    n_esc = (dist - 1) // ESC_STEP                  # escapes per real entry
    out_len = L0 + int(n_esc.sum())

    # expansion offsets: entry k lands at k + cumsum(n_esc before k) + n_esc[k]
    esc_before = np.zeros(L0, np.int64)
    np.cumsum(n_esc[:-1], out=esc_before[1:])
    pos_real = np.arange(L0) + esc_before + n_esc

    entries = np.full(out_len, (MAX_GAP << 2), np.uint16)  # escape template
    rem = (dist - 1) - n_esc * ESC_STEP                    # 0..MAX_GAP
    entries[pos_real] = (rem.astype(np.uint16) << 2) | vals

    row_ptr = np.zeros(B + 1, np.int64)
    # row r ends after its last real entry: starts[r+1]-1 -> pos_real + 1
    ends = np.zeros(B, np.int64)
    nz_rows = counts > 0
    ends[nz_rows] = pos_real[starts[1:][nz_rows] - 1] + 1
    # empty rows end where the previous row ends
    ends = np.maximum.accumulate(ends)
    row_ptr[1:] = ends
    return entries, row_ptr.astype(np.int32)


def decode_codes_plain(entries: torch.Tensor, row_ptr: torch.Tensor,
                       n_rows: int, n_samples: int) -> torch.Tensor:
    """Plain PyTorch version: positions from one cumsum over the gap+1
    steps, re-based at each row's first entry, then a scatter of the
    nonzero codes.  Escape entries (code 0) write nothing; entries at or
    past ``row_ptr[-1]`` (stream padding) are dropped, and so is any
    position outside its row."""
    out = torch.zeros(n_rows * n_samples, dtype=torch.int8,
                      device=entries.device)
    L = entries.shape[0]
    if L and n_rows:
        e = entries.to(torch.int64)
        code = (e & 3).to(torch.int8)
        csum = torch.cumsum((e >> 2) + 1, 0)
        rp = row_ptr.to(torch.int64)
        starts = rp[:-1]
        base = torch.where(starts > 0, csum[(starts - 1).clamp(0, L - 1)],
                           torch.zeros_like(starts))
        row_of = torch.searchsorted(rp[1:].contiguous(),
                                    torch.arange(L, device=e.device),
                                    right=True)
        row = row_of.clamp(max=n_rows - 1)
        pos = csum - base[row] - 1
        keep = (row_of < n_rows) & (code != 0) & (pos >= 0) & \
            (pos < n_samples)
        out[row[keep] * n_samples + pos[keep]] = code[keep]
    return out.view(n_rows, n_samples)


def _check(entries: torch.Tensor, row_ptr: torch.Tensor, n_rows: int,
           n_samples: int):
    if entries.dtype != torch.uint16 or row_ptr.dtype != torch.int32:
        raise TypeError(f"expected uint16 entries and int32 row_ptr, got "
                        f"{entries.dtype} and {row_ptr.dtype}")
    if entries.dim() != 1 or row_ptr.shape != (n_rows + 1,):
        raise ValueError(f"shape mismatch: entries {tuple(entries.shape)}, "
                         f"row_ptr {tuple(row_ptr.shape)} for {n_rows} rows")
    if not 0 <= n_samples < 1 << 31:
        raise ValueError(f"n_samples={n_samples} outside [0, 2^31)")
    if entries.device != row_ptr.device:
        raise ValueError(f"entries on {entries.device}, row_ptr on "
                         f"{row_ptr.device}")


_ENTRY = []             # the configured C entry point, once loaded


def _kernel_fn():
    """The C entry point of ``csrc/decode_codes.cu`` (built at first use),
    with its ctypes signature; set up once."""
    if not _ENTRY:
        fn = _cuda.load("decode_codes").sg_decode_codes
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _ENTRY.append(fn)
    return _ENTRY[0]


def _launch(entries: torch.Tensor, row_ptr: torch.Tensor, n_rows: int,
            n_samples: int) -> torch.Tensor:
    """Zero the output and launch the CUDA kernel on the current stream."""
    if not (entries.is_contiguous() and row_ptr.is_contiguous()):
        raise ValueError("decode_codes needs contiguous operands")
    fn = _kernel_fn()
    out = torch.empty(n_rows, n_samples, dtype=torch.int8,
                      device=entries.device)
    dev = entries.device
    err = fn(entries.data_ptr(), row_ptr.data_ptr(), out.data_ptr(), n_rows,
             n_samples, dev.index if dev.index is not None
             else torch.cuda.current_device(),
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_codes launch failed: CUDA error {err}")
    LAUNCHES["decode_codes"] += 1
    return out


def decode_codes(entries: torch.Tensor, row_ptr: torch.Tensor,
                 n_rows: int, n_samples: int) -> torch.Tensor:
    """Decode the entry stream into int8 codes [n_rows, n_samples] on the
    tensors' device (the exact inverse of :func:`encode_sparse_rows`).

    A CUDA tensor goes through the hand-written kernel (or raises); a CPU
    tensor through the plain version."""
    _check(entries, row_ptr, n_rows, n_samples)
    if entries.device.type == "cuda":
        return _launch(entries, row_ptr, n_rows, n_samples)
    if entries.device.type == "cpu":
        return decode_codes_plain(entries, row_ptr, n_rows, n_samples)
    raise ValueError(f"unsupported device {entries.device}")
