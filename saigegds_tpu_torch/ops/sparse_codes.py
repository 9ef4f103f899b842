"""Sparse genotype-code transport: gap-coded uint16 entries, and their
decode on the device (kernel B5).

The counterpart of ``saigegds_tpu/ops/sparse_codes.py``.  The host half is
the encoder; the device half is :func:`decode_codes`, which on a CUDA
tensor launches the hand-written kernels of ``csrc/decode_codes.cu``
(replacing ``saigegds_tpu/ops/pallas_sparse.py::decode_codes_pallas``) and
on a CPU tensor runs the plain PyTorch version :func:`decode_codes_plain`
(the cumsum-and-scatter of the JAX package's ``decode_codes``).  The card
decodes in two stages, each with its own entry point and plain version: a
scan of the stream that gives each entry a word (its offset in its 16 KiB
output tile and its code) and writes a table of where each tile's entries
start (:func:`tile_table`), then one block per tile that places its words'
codes and stores the tile whole (:func:`replay_tiles`).

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

# the kernels' sizes (csrc/decode_codes.cu; checked when it is loaded)
TILE = 16384            # output bytes a tile of the replay
CHUNK = 4096            # entries a span of the stream scan

# kernel launches (not plain-version calls): one per decode on the card,
# which runs both stages
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


def _stream(entries: torch.Tensor, row_ptr: torch.Tensor):
    """The entries that belong to a row, [s0, end), with what the cursor
    scan gives each: (s0, end, row, code, pos), the last three int64."""
    rp = row_ptr.to(torch.int64)
    s0 = max(int(rp[0]), 0)
    end = max(s0, min(int(rp[-1]), entries.shape[0]))
    k = torch.arange(s0, end, device=entries.device)
    e = entries[s0:end].to(torch.int64)
    csum = torch.cumsum((e >> 2) + 1, 0)
    row = torch.searchsorted(rp[1:].contiguous(), k, right=True)
    before = csum - (e >> 2) - 1
    return s0, end, row, e & 3, csum - before[rp[row] - s0] - 1


def _n_tiles(n_rows: int, n_samples: int, tile: int) -> int:
    return -(-(n_rows * n_samples) // tile)


def tile_table_plain(entries: torch.Tensor, row_ptr: torch.Tensor,
                     n_rows: int, n_samples: int, tile: int = TILE):
    """Plain version of B5's first stage: (table int64 [tiles + 1], words
    uint16 [len(entries)]).

    The output is cut into flat tiles of ``tile`` bytes (at most 16,384).
    Row g of the table is the first entry whose key row * n_samples +
    min(pos, n_samples - 1) reaches min(g * tile, n_rows * n_samples), or
    the stream's end.  Keys never decrease along the stream, so tile g's
    entries are exactly [table[g], table[g + 1]).  Each entry's word is its
    offset in its tile << 2 | its code, or 0 when it writes nothing
    (escape, padding, a position outside its row); words outside
    [row_ptr[0], row_ptr[n_rows]) are left 0 here and undefined on the
    card."""
    if not 0 < tile <= 1 << GAP_BITS:
        raise ValueError(f"tile {tile} outside (0, {1 << GAP_BITS}]")
    total = n_rows * n_samples
    s0, end, row, code, pos = _stream(entries, row_ptr)
    flat = row * n_samples + pos
    key = row * n_samples + pos.clamp(max=n_samples - 1)
    dev = entries.device
    b = (torch.arange(_n_tiles(n_rows, n_samples, tile) + 1, device=dev)
         * tile).clamp(max=total)
    words = torch.zeros(entries.shape[0], dtype=torch.uint16, device=dev)
    keep = (code != 0) & (pos < n_samples)
    words[s0:end] = torch.where(keep, ((flat % tile) << 2) | code,
                                0).to(torch.uint16)
    return s0 + torch.searchsorted(key, b), words


def replay_tiles_plain(table: torch.Tensor, words: torch.Tensor,
                       n_rows: int, n_samples: int,
                       tile: int = TILE) -> torch.Tensor:
    """Plain version of B5's second stage: int8 codes [n_rows, n_samples]
    from the words and the tile table of ``tile_table_plain``: tile g
    places the codes of its words [table[g], table[g + 1]) at the offsets
    they carry, and is zero elsewhere."""
    out = torch.zeros(n_rows * n_samples, dtype=torch.int8,
                      device=words.device)
    k0, k1 = int(table[0]), int(table[-1])
    k = torch.arange(k0, k1, device=words.device)
    g = torch.searchsorted(table.contiguous(), k, right=True) - 1
    w = words[k0:k1].to(torch.int64)
    keep = (w & 3) != 0
    out[(g * tile + (w >> 2))[keep]] = (w & 3)[keep].to(torch.int8)
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
    if entries.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {entries.device}")


def _check_stage(entries, row_ptr, n_rows: int, n_samples: int):
    _check(entries, row_ptr, n_rows, n_samples)
    if n_rows * n_samples == 0:
        raise ValueError("an empty output has no tiles")


def _check_table(table: torch.Tensor, words: torch.Tensor, n_rows: int,
                 n_samples: int):
    want = (_n_tiles(n_rows, n_samples, TILE) + 1,)
    if table.dtype != torch.int64 or tuple(table.shape) != want or \
            words.dtype != torch.uint16 or words.dim() != 1 or \
            table.device != words.device:
        raise ValueError(f"expected an int64 tile table {want} and uint16 "
                         f"words on one device, got {table.dtype} "
                         f"{tuple(table.shape)} on {table.device} and "
                         f"{words.dtype} {tuple(words.shape)} on "
                         f"{words.device}")


_ENTRY = {}             # the configured C entry points, once loaded


def _kernel_fns():
    """The C entry points of ``csrc/decode_codes.cu`` (built at first use),
    with their ctypes signatures; set up once, after checking that the
    library's tile and span sizes are this module's."""
    if not _ENTRY:
        lib = _cuda.load("decode_codes")
        tile, chunk = ctypes.c_int(), ctypes.c_int()
        lib.sg_decode_config.restype = None
        lib.sg_decode_config(ctypes.byref(tile), ctypes.byref(chunk))
        if (tile.value, chunk.value) != (TILE, CHUNK):
            raise RuntimeError(f"decode_codes.cu has tile {tile.value} and "
                               f"span {chunk.value}, expected {TILE} and "
                               f"{CHUNK}")
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        for name, args in (
                ("sg_decode_table", [p, ll, p, ll, ll, p, p, p, i, p]),
                ("sg_decode_tiles", [p, p, ll, ll, p, i, p]),
                ("sg_decode_codes", [p, ll, p, ll, ll, p, p, p, p, i, p])):
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
            _ENTRY[name] = fn
    return _ENTRY


def _device_stream(t: torch.Tensor):
    dev = t.device
    return (dev.index if dev.index is not None
            else torch.cuda.current_device(),
            torch.cuda.current_stream(dev).cuda_stream)


def _scratch(entries: torch.Tensor, n_rows: int, n_samples: int):
    """(table int64 [tiles + 1], words uint16 [len(entries)], the
    look-back's status int64 [spans + 1]) in one allocation."""
    L = entries.shape[0]
    tiles = _n_tiles(n_rows, n_samples, TILE)
    spans = max(1, -(-L // CHUNK))
    buf = torch.empty(tiles + 1 + spans + 1 + -(-L // 4), dtype=torch.int64,
                      device=entries.device)
    table = buf[: tiles + 1]
    status = buf[tiles + 1: tiles + spans + 2]
    words = buf[tiles + spans + 2:].view(torch.uint16)[:L]
    return table, words, status


def _run(name: str, *args):
    err = _kernel_fns()[name](*args)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _contiguous(*ts):
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("decode_codes needs contiguous operands")


def tile_table(entries: torch.Tensor, row_ptr: torch.Tensor, n_rows: int,
               n_samples: int):
    """B5's first stage alone, (table, words) as :func:`tile_table_plain`
    gives them: the kernel on a CUDA tensor (a memset of the look-back's
    scratch, then ``table_kernel``), the plain version on a CPU tensor."""
    _check_stage(entries, row_ptr, n_rows, n_samples)
    if entries.device.type == "cpu":
        return tile_table_plain(entries, row_ptr, n_rows, n_samples)
    _contiguous(entries, row_ptr)
    table, words, status = _scratch(entries, n_rows, n_samples)
    _run("sg_decode_table", entries.data_ptr(), entries.shape[0],
         row_ptr.data_ptr(), n_rows, n_samples, table.data_ptr(),
         words.data_ptr(), status.data_ptr(), *_device_stream(entries))
    return table, words


def replay_tiles(table: torch.Tensor, words: torch.Tensor, n_rows: int,
                 n_samples: int) -> torch.Tensor:
    """B5's second stage alone (see :func:`replay_tiles_plain`): the
    kernel ``tiles_kernel`` on a CUDA tensor, the plain version on a CPU
    tensor."""
    if n_rows * n_samples == 0 or not 0 < n_samples < 1 << 31:
        raise ValueError("an empty output has no tiles")
    _check_table(table, words, n_rows, n_samples)
    if words.device.type == "cpu":
        return replay_tiles_plain(table, words, n_rows, n_samples)
    _contiguous(table, words)
    out = torch.empty(n_rows, n_samples, dtype=torch.int8,
                      device=words.device)
    _run("sg_decode_tiles", words.data_ptr(), table.data_ptr(), n_rows,
         n_samples, out.data_ptr(), *_device_stream(words))
    return out


def decode_codes(entries: torch.Tensor, row_ptr: torch.Tensor,
                 n_rows: int, n_samples: int) -> torch.Tensor:
    """Decode the entry stream into int8 codes [n_rows, n_samples] on the
    tensors' device (the exact inverse of :func:`encode_sparse_rows`).

    A CUDA tensor goes through the hand-written kernels, both stages from
    one call, counted as one launch of ``decode_codes`` (or raises); a CPU
    tensor through the plain version."""
    _check(entries, row_ptr, n_rows, n_samples)
    if entries.device.type == "cpu":
        return decode_codes_plain(entries, row_ptr, n_rows, n_samples)
    out = torch.empty(n_rows, n_samples, dtype=torch.int8,
                      device=entries.device)
    if out.numel() == 0:
        return out
    _contiguous(entries, row_ptr)
    table, words, status = _scratch(entries, n_rows, n_samples)
    _run("sg_decode_codes", entries.data_ptr(), entries.shape[0],
         row_ptr.data_ptr(), n_rows, n_samples, table.data_ptr(),
         words.data_ptr(), status.data_ptr(), out.data_ptr(),
         *_device_stream(entries))
    LAUNCHES["decode_codes"] += 1
    return out
