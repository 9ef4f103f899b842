"""The int8 tensor-core fragment map of the port's CUDA kernels, in numpy.

On the card kernels B1-B4 contract on the int8 tensor cores with
``mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32``; this module emulates
one such mma from the 32 lanes' registers, as the PTX ISA lays them out,
and builds the kernels' operand words, so that the CPU tests of the kernel
files (``test_torch_grm_kernel.py``, ``test_torch_score_kernel.py``,
``test_torch_indicator_dot.py``) can contract fragment by fragment and
hold the result against the plain versions.  Its own test holds the
indicator split of B3 and B4 against its definition, exactly.
"""

import numpy as np

# A 32-bit word holds four consecutive k as s8 bytes, lowest first.
_LANE = np.arange(32)
_G, _T = _LANE >> 2, _LANE & 3          # group and thread in group


def _bytes(words: np.ndarray) -> np.ndarray:
    """uint32 words [..., n] -> their s8 bytes as int32 [..., n, 4]."""
    w = np.ascontiguousarray(words, dtype="<u4")
    return w.view(np.int8).reshape(*w.shape, 4).astype(np.int32)


def _mma_m16n8k32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """One ``mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32`` from the 32
    lanes' registers, laid out as the PTX ISA states: a [32, 4] and b
    [32, 2] uint32 words -> the lanes' d [32, 4] int32 (a zero C)."""
    ab, bb = _bytes(a), _bytes(b)
    A = np.zeros((16, 32), np.int32)
    B = np.zeros((32, 8), np.int32)
    k4 = 4 * _T[:, None] + np.arange(4)
    A[_G[:, None], k4], A[_G[:, None] + 8, k4] = ab[:, 0], ab[:, 1]
    A[_G[:, None], k4 + 16], A[_G[:, None] + 8, k4 + 16] = ab[:, 2], ab[:, 3]
    B[k4, _G[:, None]], B[k4 + 16, _G[:, None]] = bb[:, 0], bb[:, 1]
    D = A @ B
    return np.stack([D[_G, 2 * _T], D[_G, 2 * _T + 1],
                     D[_G + 8, 2 * _T], D[_G + 8, 2 * _T + 1]], axis=1)


def _spread_planes(x: np.ndarray) -> np.ndarray:
    """B1's A word of a packed byte: byte p is plane p's code."""
    x = x.astype(np.uint32)
    return (x & 0x03) | ((x & 0x0C) << 6) | ((x & 0x30) << 12) | \
        ((x & 0xC0) << 18)


def _words(b: np.ndarray) -> np.ndarray:
    """Four int8/uint8 planes [4, ...] -> one uint32 word each, plane k in
    byte k (what ``transpose4`` writes)."""
    u = b.astype(np.uint8).astype(np.uint32)
    return u[0] | (u[1] << 8) | (u[2] << 16) | (u[3] << 24)


def _pad(a: np.ndarray, axis: int, mult: int) -> np.ndarray:
    widths = [(0, 0)] * a.ndim
    widths[axis] = (0, -a.shape[axis] % mult)
    return np.pad(a, widths)


def _indicators(cw: np.ndarray):
    """B3's and B4's split of code words (one 2-bit code a byte) into the
    three indicator words (g0 with missing as 0, missing, hom-ALT), as
    ``int8_mma.cuh`` ``indicators`` computes them."""
    cw = cw.astype(np.uint32)
    hi = cw >> 1
    m = cw & hi & np.uint32(0x01010101)
    g2 = hi & ~cw & np.uint32(0x01010101)
    return cw - np.uint32(3) * m, m, g2


def _indicators_by_fragments(aw: np.ndarray, bw: np.ndarray) -> np.ndarray:
    """B3 and B4 as the kernels contract them: code words aw [Bp, Kq] (Bp a
    multiple of 16, Kq of 8 k-quads) against B words bw [Kq, C], one mma
    per 16 variants x 32 k x 8 columns and per indicator, every B fragment
    serving the three indicators -> int64 [Bp, 3, C]."""
    Bp, C = aw.shape[0], bw.shape[1]
    out = np.zeros((Bp, 3, C), np.int64)
    for ks in range(0, aw.shape[1], 8):
        for r in range(0, Bp, 16):
            cw = np.stack([aw[r + _G, ks + _T], aw[r + _G + 8, ks + _T],
                           aw[r + _G, ks + 4 + _T],
                           aw[r + _G + 8, ks + 4 + _T]], axis=1)
            inds = _indicators(cw)
            for c in range(0, C, 8):
                b = np.stack([bw[ks + _T, c + _G], bw[ks + 4 + _T, c + _G]],
                             axis=1)
                for x in range(3):
                    d = _mma_m16n8k32(inds[x], b)
                    for h in range(2):
                        out[r + _G + 8 * h, x, c + 2 * _T] += d[:, 2 * h]
                        out[r + _G + 8 * h, x, c + 2 * _T + 1] += \
                            d[:, 2 * h + 1]
    return out


def test_indicator_words_split_every_code():
    """Every code word of four codes (all 256 of them) splits into g0 (the
    code, missing as 0), [code == 3] and [code == 2], byte by byte."""
    codes = np.stack(np.meshgrid(*[np.arange(4)] * 4, indexing="ij"),
                     axis=-1).reshape(-1, 4)                 # [256, 4]
    g0, m, g2 = (_bytes(w)
                 for w in _indicators(_words(codes.T.astype(np.uint8))))
    np.testing.assert_array_equal(g0, np.where(codes == 3, 0, codes))
    np.testing.assert_array_equal(m, (codes == 3).astype(np.int32))
    np.testing.assert_array_equal(g2, (codes == 2).astype(np.int32))
