"""The warpgroup MMA of the port's int8 tensor-core kernels B1-B4
(``csrc/plane_dot.cu``, ``csrc/indicator_tile.cuh``, ``csrc/wgmma_s8.cuh``)
in numpy, on the CPU.

On the card the kernels contract on ``wgmma.mma_async.sync.aligned.m64nNk32
.s32.s8.s8`` with A in the warpgroup's registers and B a K-major tile in
shared memory that TMA wrote with the 128-byte swizzle and a matrix
descriptor addresses.  This module emulates the pieces as the PTX ISA and
the tensor maps lay them out -- the A fragment of the 128 threads, the s32
accumulator registers, and the swizzled tile as the copy writes it and the
descriptor reads it -- and holds each against a plain int32 product or
the tile itself, exactly.  ``test_torch_grm_kernel.py`` composes them into
B1 and B2 contracted fragment by fragment; :func:`indicator_tile` composes
them into the tile that B3 and B4 share, whose test files give it their
kernels' A words (``test_torch_score_kernel.py``,
``test_torch_indicator_dot.py``).
"""

import numpy as np
import pytest

LOW2 = np.uint32(0x03030303)            # one 2-bit value per byte

def _bytes(words: np.ndarray) -> np.ndarray:
    """uint32 words [..., n] -> their s8 bytes as int32 [..., n, 4]."""
    w = np.ascontiguousarray(words, dtype="<u4")
    return w.view(np.int8).reshape(*w.shape, 4).astype(np.int32)


def _words(b: np.ndarray) -> np.ndarray:
    """Four int8/uint8 planes [4, ...] -> one uint32 word each, plane k in
    byte k (a word of four consecutive k, lowest first)."""
    u = b.astype(np.uint8).astype(np.uint32)
    return u[0] | (u[1] << 8) | (u[2] << 16) | (u[3] << 24)


def _pad(a: np.ndarray, axis: int, mult: int) -> np.ndarray:
    widths = [(0, 0)] * a.ndim
    widths[axis] = (0, -a.shape[axis] % mult)
    return np.pad(a, widths)


_TH = np.arange(128)                    # the warpgroup's threads
_W, _G, _T = _TH >> 5, (_TH & 31) >> 2, _TH & 3   # warp, group, thread
_ROW = 16 * _W + _G                     # each thread's first row of the 64


def wgmma_m64nNk32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """One ``wgmma`` m64nNk32 s8 x s8 -> s32 from the warpgroup's registers:
    a [128, 4] uint32 words (the A fragment), b [N, 32] int8 (the B tile
    as its N rows of 32 consecutive k) -> the threads' d [128, N/2] int64
    (a zero accumulator).  Warp w holds rows 16w .. 16w+15 of A; a[:, 0]
    is row g at k 4t .. 4t+3, a[:, 1] row g+8, a[:, 2] and a[:, 3] the same
    rows at k 16+4t ..; d[:, 4q + 2h + e] is row g + 8h at column
    8q + 2t + e."""
    ab = _bytes(a)                                      # [128, 4, 4]
    A = np.zeros((64, 32), np.int64)
    k4 = 4 * _T[:, None] + np.arange(4)
    A[_ROW[:, None], k4], A[_ROW[:, None] + 8, k4] = ab[:, 0], ab[:, 1]
    A[_ROW[:, None], k4 + 16] = ab[:, 2]
    A[_ROW[:, None] + 8, k4 + 16] = ab[:, 3]
    D = A @ b.astype(np.int64).T                        # [64, N]
    n = b.shape[0]
    d = np.empty((128, n // 2), np.int64)
    for q in range(n // 8):
        for h in range(2):
            for e in range(2):
                d[:, 4 * q + 2 * h + e] = D[_ROW + 8 * h, 8 * q + 2 * _T + e]
    return d


def _a_regs(A: np.ndarray) -> np.ndarray:
    """The A fragment of a 64 x 32 s8 tile by the ISA's element index: the
    16 elements i of a thread lie in register i // 4 at byte i % 4, at row
    g (+8 for registers 1 and 3) and column 4t + i % 4 (+16 for registers 2
    and 3) of its warp's 16 rows."""
    regs = np.zeros((128, 4, 4), np.uint8)
    for i in range(16):
        r, byte = divmod(i, 4)
        row = _ROW + 8 * (r % 2)
        col = 4 * _T + byte + 16 * (r // 2)
        regs[:, r, byte] = A[row, col].astype(np.uint8)
    return _words(np.moveaxis(regs, -1, 0))


def swizzle(addr):
    """The shared-memory address of byte ``addr`` of a tile stored with the
    128-byte swizzle from a 1,024-byte aligned start: the 16-byte chunk
    bits 4-6 XOR the row bits 7-9."""
    return addr ^ (((addr >> 7) & 7) << 4)


def tma_write(box: np.ndarray) -> np.ndarray:
    """Shared memory as TMA writes a [rows, 128]-byte box with
    CU_TENSOR_MAP_SWIZZLE_128B: row r densely at 128 r, each byte moved by
    :func:`swizzle` (chunk c of row r to c ^ (r % 8))."""
    rows = box.shape[0]
    smem = np.zeros(rows * 128, box.dtype)
    r = np.arange(rows)[:, None]
    c = np.arange(128)[None, :]
    smem[swizzle(128 * r + c)] = box
    return smem


def desc_read(smem: np.ndarray, start: int, n: int) -> np.ndarray:
    """The [n, 32] K-major tile that a 128-byte-swizzle descriptor (rows
    128 bytes apart, eight-row groups 1,024 apart: its SBO) with its start
    ``start`` bytes into the tile hands the MMA: row x, byte k at
    swizzle(start + 1024 (x // 8) + 128 (x % 8) + k)."""
    x = np.arange(n)[:, None]
    k = np.arange(32)[None, :]
    return smem[swizzle(start + 1024 * (x // 8) + 128 * (x % 8) + k)]


def desc_sw128(addr: int) -> int:
    """``desc_sw128`` of ``wgmma_s8.cuh``: start address >> 4 in bits 0-13,
    LBO 1 in bits 16-29, SBO 1,024 >> 4 in bits 32-45, layout 1 (128-byte
    swizzle) in bits 62-63."""
    return ((addr & 0x3FFFF) >> 4) | (1 << 16) | ((1024 >> 4) << 32) | \
        (1 << 62)


def stage_b(op: np.ndarray, c0: int, bn: int, k0: int):
    """A stage's slice tile through shared memory: TMA's box of ``bn`` rows
    x 128 bytes at (k0, c0) of a K-major operand [C, width], zero past it,
    written with the 128-byte swizzle; its four k32 steps as the
    descriptor reads them."""
    box = np.zeros((bn, 128), np.int8)
    part = op[c0:c0 + bn, k0:k0 + 128]
    box[:part.shape[0], :part.shape[1]] = part
    smem = tma_write(box)
    return [desc_read(smem, 32 * ks, bn) for ks in range(4)]


def fetch_span(flat: np.ndarray, p: np.ndarray, n: np.ndarray,
               span: int) -> np.ndarray:
    """``Span::fetch`` and ``word`` of ``indicator_tile.cuh`` for each
    thread: the ``span`` bytes from byte address p [T] of the buffer
    ``flat`` (uint8, its start aligned), of which the first n [T] are the
    row's, as the aligned words that cover them (none loaded that holds no
    byte of the row: zero instead) funnel-shifted together -> uint32
    [T, span / 4]."""
    s = p & 3
    k = np.arange(span // 4 + 1)
    load = (n[:, None] > 0) & (4 * k[None, :] < s[:, None] + n[:, None])
    at = np.where(load, p[:, None] - s[:, None] + 4 * k[None, :], 0)
    b = flat[at[..., None] + np.arange(4)].astype(np.uint64)
    w = (b[..., 0] | b[..., 1] << 8 | b[..., 2] << 16 | b[..., 3] << 24) \
        * load
    pair = (w[:, 1:] << np.uint64(32)) | w[:, :-1]
    return (pair >> (8 * s[:, None]).astype(np.uint64)).astype(np.uint32)


def indicator_tile(codes: np.ndarray, off: int, span: int, build,
                   op: np.ndarray, bn: int) -> np.ndarray:
    """B3 or B4 as ``indicator_tile.cuh`` contracts them: the codes, rows of
    ``row_bytes`` bytes, ``off`` bytes into an aligned buffer; blocks of 128
    variants x ``bn`` columns; per stage group of 128 k, the slice tile of
    the K-major operand op [C, width] through TMA and the descriptor, each
    consumer thread's ``span`` bytes at byte ``span t`` of the stage of its
    rows g and g + 8 (``fetch_span``), turned into its A words by ``build``
    (the kernel's policy: build(words [128, span / 4], a [3, 4, 128, 4],
    rh)), one wgmma m64nBNk32 per indicator and k-step, and the epilogue's
    rows and columns -> int64 [B, 3, C]."""
    B, row_bytes = codes.shape
    C, width = op.shape
    flat = np.concatenate([np.zeros(off, np.uint8),
                           codes.reshape(-1).view(np.uint8),
                           np.zeros(4, np.uint8)])
    out = np.zeros((B, 3, C), np.int64)
    for b0 in range(0, B, 128):
        for c0 in range(0, C, bn):
            acc = np.zeros((2, 3, 128, bn // 2), np.int64)
            for grp in range(width // 128):
                b = stage_b(op, c0, bn, 128 * grp)
                for wgi in range(2):
                    a = np.zeros((3, 4, 128, 4), np.uint32)
                    for rh in range(2):
                        row = b0 + 64 * wgi + 16 * _W + 8 * rh + _G
                        j = 4 * span * grp + span * _T
                        n = np.where(row < B, np.clip(row_bytes - j, 0, span),
                                     0)
                        p = off + np.where(row < B, row, 0) * row_bytes + j
                        build(fetch_span(flat, p, n, span), a, rh)
                    for ks in range(4):
                        for x in range(3):
                            acc[wgi, x] += wgmma_m64nNk32(a[x, ks], b[ks])
            for wgi in range(2):
                for rh in range(2):
                    row = b0 + 64 * wgi + 16 * _W + 8 * rh + _G
                    live = row < B
                    for x in range(3):
                        for q in range(bn // 8):
                            for e in range(2):
                                out[row[live], x, c0 + 8 * q + 2 * _T[live]
                                    + e] += acc[wgi, x, live, 4 * q + 2 * rh
                                                + e]
    return out


@pytest.mark.parametrize("n", [16, 128, 256])
def test_wgmma_fragments_are_a_matrix_product(n):
    """The emulated m64nNk32, fed the A fragment built element by element,
    equals a plain int32 product at every accumulator register."""
    rng = np.random.default_rng(n)
    A = rng.integers(-128, 128, size=(64, 32), dtype=np.int8)
    B = rng.integers(-128, 128, size=(n, 32), dtype=np.int8)
    D = A.astype(np.int32) @ B.astype(np.int32).T
    d = wgmma_m64nNk32(_a_regs(A), B)
    assert d.shape == (128, n // 2)
    for q in range(n // 8):
        for h in range(2):
            for e in range(2):
                np.testing.assert_array_equal(
                    d[:, 4 * q + 2 * h + e], D[_ROW + 8 * h, 8 * q + 2 * _T + e])
    # every cell of D is held by exactly one register of one thread
    seen = np.zeros((64, n), np.int64)
    for q in range(n // 8):
        for h in range(2):
            for e in range(2):
                np.add.at(seen, (_ROW + 8 * h, 8 * q + 2 * _T + e), 1)
    assert (seen == 1).all()


@pytest.mark.parametrize("n", [16, 128, 256])
def test_swizzled_tile_read_by_descriptor(n):
    """A [n, 128]-byte tile written by TMA with the 128-byte swizzle reads
    back through the descriptor as its k32 steps: a start 32 s bytes in
    gives columns 32 s .. 32 s + 31 of every row (the kernels add 2 to the
    descriptor per step); the swizzle moves most bytes."""
    rng = np.random.default_rng(n + 1)
    tile = rng.integers(0, 256, size=(n, 128), dtype=np.uint8)
    smem = tma_write(tile)
    assert np.mean(smem != tile.reshape(-1)) > 0.5
    for s in range(4):
        np.testing.assert_array_equal(desc_read(smem, 32 * s, n),
                                      tile[:, 32 * s:32 * s + 32])
        assert desc_sw128(1024 * 3 + 32 * s) == desc_sw128(1024 * 3) + 2 * s
    assert desc_sw128(0x1400) >> 62 == 1 and \
        (desc_sw128(0) >> 32) & 0x3FFF == 64


@pytest.mark.parametrize("span", [8, 32])
def test_fetch_span_reads_only_the_row(span):
    """The span at every start modulo 4 and every count n of the row's
    bytes gives those bytes in order, and reads no word that holds none of
    them: past the word of the row's last byte (the buffer's bytes there
    are 0xEE) the span is zero."""
    rng = np.random.default_rng(span)
    for off in range(4):
        for n in range(span + 1):
            flat = np.concatenate([rng.integers(0, 256, size=off + n,
                                                dtype=np.uint8),
                                   np.full(span + 8, 0xEE, np.uint8)])
            w = fetch_span(flat, np.array([off]), np.array([n]), span)
            got = _bytes(w)[0].astype(np.uint8).reshape(-1)
            np.testing.assert_array_equal(got[:n], flat[off:off + n])
            end = 4 * -(-(off + n) // 4) - off if n else 0
            assert not got[end:].any()
