"""Kernels B1 and B2 of the PyTorch port (``saigegds_tpu_torch/ops/
grm_kernel``) against the JAX package's Pallas kernels and their XLA twins.

Tolerance: none -- bit-equal.  Every output is an exact integer (each
product is at most 3 * 64 = 192 and the sums stay far below 2^24 at these
sizes), so the Pallas kernels in interpret mode, the XLA twins
``_p1_tile``/``_p2_tile``, the port's plain versions and its CUDA kernels
must agree to the last bit.  The packed bytes are random, so code 3 occurs
too: every version decodes the raw bit pairs.

The JAX package is imported inside the tests that use it, so that the
card-only cases run where jax is not installed:
``python -m pytest --noconftest -m cuda tests/test_torch_grm_kernel.py``.
"""

import numpy as np
import pytest
import torch

from test_torch_wgmma import LOW2, _G, _T, _W, _bytes, _words, \
    stage_b as _stage_b, wgmma_m64nNk32
from saigegds_tpu_torch.ops import grm_kernel
from saigegds_tpu_torch.ops.packed_grm import store_width

M_VARIANTS, N_SAMPLES = 300, 1111       # off every tile size; N % 4 != 0


def _jax():
    """The JAX package's side of the comparison."""
    import jax.numpy as jnp
    from saigegds_tpu.ops import packed_grm, pallas_grm
    return jnp, packed_grm, pallas_grm


def _operands(M: int, N: int, C: int, seed: int, n4: int = 0):
    """uint8 packed [M, N4], int8 d4 [4, N4, C] (zero rows at padded
    samples) and int8 dm [M, C], as numpy arrays; N4 = ceil(N/4) unless
    given."""
    rng = np.random.default_rng(seed)
    n4 = n4 or -(-N // 4)
    packed = rng.integers(0, 256, size=(M, n4), dtype=np.uint8)
    d4 = rng.integers(-64, 65, size=(4, n4, C), dtype=np.int8)
    d4.reshape(4 * n4, C)[N:] = 0
    dm = rng.integers(-64, 65, size=(M, C), dtype=np.int8)
    return packed, d4, dm


@pytest.fixture(scope="module", params=[128, 256])
def ops(request):
    return _operands(M_VARIANTS, N_SAMPLES, request.param, request.param)


def test_fwd_plain_matches_pallas_interpret(ops):
    jnp, _, jpk = _jax()
    packed, d4, _ = ops
    want = np.asarray(jpk.plane_dot_fwd(
        jnp.asarray(packed), jnp.asarray(d4).astype(jnp.bfloat16),
        interpret=True))
    got = grm_kernel.plane_dot_fwd(torch.from_numpy(packed),
                                   torch.from_numpy(d4))
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), want)


def test_t_plain_matches_pallas_interpret(ops):
    jnp, _, jpk = _jax()
    packed, _, dm = ops
    want = np.asarray(jpk.plane_dot_t(
        jnp.asarray(packed), jnp.asarray(dm).astype(jnp.bfloat16),
        interpret=True))
    got = grm_kernel.plane_dot_t(torch.from_numpy(packed),
                                 torch.from_numpy(dm))
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), want)


def test_fwd_plain_matches_xla_twin(ops):
    """``_p1_tile`` over the whole store as one tile."""
    jnp, jpg, _ = _jax()
    packed, d4, _ = ops
    n4, C = d4.shape[1], d4.shape[2]
    dmat = jnp.asarray(d4.reshape(4 * n4, C)).astype(jnp.bfloat16)
    want = np.asarray(jpg._p1_tile(jnp.asarray(packed), dmat, n4, 0))
    got = grm_kernel.plane_dot_fwd_plain(torch.from_numpy(packed),
                                         torch.from_numpy(d4))
    np.testing.assert_array_equal(got.numpy(), want)


def test_t_plain_matches_xla_twin(ops):
    """``_p2_tile`` accumulated from zero over the whole store."""
    jnp, jpg, _ = _jax()
    packed, _, dm = ops
    acc4 = jnp.zeros((4, packed.shape[1], dm.shape[1]), jnp.float64)
    want = np.asarray(jpg._p2_tile(acc4, jnp.asarray(packed),
                                   jnp.asarray(dm).astype(jnp.bfloat16)))
    got = grm_kernel.plane_dot_t_plain(torch.from_numpy(packed),
                                       torch.from_numpy(dm))
    np.testing.assert_array_equal(got.numpy(), want)


def test_plain_chunking_is_exact(monkeypatch):
    """Chunk edges inside the rows and byte columns change nothing (the
    partial sums are exact integers)."""
    packed, d4, dm = (torch.from_numpy(a) for a in
                      _operands(M_VARIANTS, N_SAMPLES, 128, 3))
    fwd = grm_kernel.plane_dot_fwd_plain(packed, d4)
    t = grm_kernel.plane_dot_t_plain(packed, dm)
    monkeypatch.setattr(grm_kernel, "_CHUNK_J", 37)
    monkeypatch.setattr(grm_kernel, "_CHUNK_M", 41)
    assert torch.equal(grm_kernel.plane_dot_fwd_plain(packed, d4), fwd)
    assert torch.equal(grm_kernel.plane_dot_t_plain(packed, dm), t)


def test_launch_counts_untouched_by_plain_versions():
    packed, d4, dm = (torch.from_numpy(a) for a in _operands(5, 41, 128, 4))
    before = dict(grm_kernel.LAUNCHES)
    grm_kernel.plane_dot_fwd(packed, d4)
    grm_kernel.plane_dot_t(packed, dm)
    assert grm_kernel.LAUNCHES == before


@pytest.mark.parametrize("kernel", ["fwd", "t"])
@pytest.mark.parametrize("bad", ["dtype", "width", "shape", "samples",
                                 "variants", "device"])
def test_wrappers_reject(kernel, bad):
    """Dtype, shape, width, size and device checks run before any dispatch
    (meta tensors carry shapes without memory)."""
    packed, d4, dm = (torch.from_numpy(a) for a in _operands(3, 41, 128, 5))
    rhs = d4 if kernel == "fwd" else dm
    if bad == "dtype":
        rhs = rhs.to(torch.int16)
    elif bad == "width":
        rhs = rhs[..., :100]
    elif bad == "shape":
        rhs = rhs[1:]
    elif bad == "samples":
        n4 = grm_kernel.MAX_AXIS // 4
        packed = torch.empty(1, n4, dtype=torch.uint8, device="meta")
        rhs = torch.empty(4, n4, 128, dtype=torch.int8, device="meta") \
            if kernel == "fwd" else \
            torch.empty(1, 128, dtype=torch.int8, device="meta")
    elif bad == "variants":
        m = grm_kernel.MAX_AXIS
        packed = torch.empty(m, 2, dtype=torch.uint8, device="meta")
        rhs = torch.empty(4, 2, 128, dtype=torch.int8, device="meta") \
            if kernel == "fwd" else \
            torch.empty(m, 128, dtype=torch.int8, device="meta")
    else:
        packed = packed.to("meta")
        rhs = rhs.to("meta")
    fn = grm_kernel.plane_dot_fwd if kernel == "fwd" else \
        grm_kernel.plane_dot_t
    with pytest.raises((TypeError, ValueError)):
        fn(packed, rhs)


# The kernels' tiling and fragment maps (the warpgroup MMA and the swizzled
# tiles are emulated in test_torch_wgmma), mirroring csrc/plane_dot.cu.


def _tiling(C: int):
    """Column tile, m64 tiles per consumer warpgroup, B1's variants and
    B2's byte columns per block."""
    bn = grm_kernel.column_tile(C)
    mt = 1 if bn == 256 else 2
    return bn, mt, 128 * mt, 32 * mt


def _transpose4(w0, w1, w2, w3):
    """``plane_dot.cu`` ``transpose4``: word k holds byte k of w0 .. w3."""
    b = _bytes(np.stack([w0, w1, w2, w3], axis=-1)).astype(np.uint8)
    return [_words(np.moveaxis(b[..., :, k], -1, 0)) for k in range(4)]


def _fwd_by_fragments(packed: np.ndarray, d4: np.ndarray,
                      op: np.ndarray = None) -> np.ndarray:
    """B1 as kernel B1 contracts it: the store and the slices padded to a
    width N4 of 16 byte columns (as the store is on the card), the slices
    in the kernel's order (``fwd_rows_operand``, or ``op`` when given,
    for a store already that wide), stages of 32 byte columns,
    each consumer warpgroup's A fragments built from its rows' 8 bytes at
    byte column 8t, one wgmma m64nNk32 per k-step and m64 tile, the
    epilogue's rows and columns."""
    M, n4 = packed.shape
    C = d4.shape[2]
    N4 = -(-n4 // 16) * 16
    packed = np.pad(packed, ((0, 0), (0, N4 - n4)))
    d4 = np.pad(d4, ((0, 0), (0, N4 - n4), (0, 0)))
    bn, mt, bm, _ = _tiling(C)
    if op is None:
        op = grm_kernel.fwd_rows_operand(
            torch.from_numpy(d4.reshape(4 * N4, C)), N4, C, "cpu").numpy()
    n4p = op.shape[1] // 4
    pk = np.zeros((-(-M // bm) * bm, n4p), np.uint8)     # TMA's zero fill
    pk[:M, :N4] = packed
    out = np.zeros((pk.shape[0], C), np.int64)
    for m0 in range(0, pk.shape[0], bm):
        for c0 in range(0, C, bn):
            acc = np.zeros((2, mt, 128, bn // 2), np.int64)
            for grp in range(n4p // 32):
                tile = pk[m0:m0 + bm, 32 * grp:32 * grp + 32]
                b = _stage_b(op, c0, bn, 128 * grp)
                for wgi in range(2):
                    a = np.zeros((4, mt, 128, 4), np.uint32)
                    for ti in range(mt):
                        for rh in range(2):
                            row = 64 * (wgi * mt + ti) + 16 * _W + 8 * rh + _G
                            w8 = tile[row[:, None], 8 * _T[:, None]
                                      + np.arange(8)]
                            for wi in range(2):
                                x = _words(w8[:, 4 * wi:4 * wi + 4].T)
                                q = _transpose4(x & LOW2, (x >> 2) & LOW2,
                                                (x >> 4) & LOW2,
                                                (x >> 6) & LOW2)
                                a[2 * wi, ti, :, rh] = q[0]
                                a[2 * wi, ti, :, rh + 2] = q[1]
                                a[2 * wi + 1, ti, :, rh] = q[2]
                                a[2 * wi + 1, ti, :, rh + 2] = q[3]
                    for ks in range(4):
                        for ti in range(mt):
                            acc[wgi, ti] += wgmma_m64nNk32(a[ks, ti], b[ks])
            for wgi in range(2):
                for ti in range(mt):
                    for rh in range(2):
                        m = m0 + 64 * (wgi * mt + ti) + 16 * _W + 8 * rh + _G
                        for q in range(bn // 8):
                            for e in range(2):
                                out[m, c0 + 8 * q + 2 * _T + e] += \
                                    acc[wgi, ti, :, 4 * q + 2 * rh + e]
    return out[:M]


def _t_by_fragments(packed: np.ndarray, dm: np.ndarray) -> np.ndarray:
    """B2 as kernel B2 contracts it: the operand laid out by the wrapper
    (``t_operand``), stages of 128 variants, each consumer warpgroup's
    rows (byte column 4g + w of its 32-column sub-tile, two planes per m64
    tile), A words from one byte of each of variants t, 4+t, 8+t, 12+t of a
    16-variant group, and the epilogue's rows (plane, byte column)."""
    (M, N4), C = packed.shape, dm.shape[1]
    bn, mt, _, jb_cols = _tiling(C)
    op = grm_kernel.t_operand(torch.from_numpy(dm)).numpy()
    pk = np.zeros((-(-M // 128) * 128, -(-N4 // jb_cols) * jb_cols),
                  np.uint8)
    pk[:M, :N4] = packed
    out = np.zeros((4, pk.shape[1], C), np.int64)
    for jb in range(0, pk.shape[1], jb_cols):
        for c0 in range(0, C, bn):
            acc = np.zeros((2, mt, 128, bn // 2), np.int64)
            for mb in range(0, pk.shape[0], 128):
                b = _stage_b(op, c0, bn, mb)
                for wgi in range(2):
                    sub, plane0 = wgi * mt // 2, (wgi * 2 * mt) % 4
                    jj = jb + 32 * sub + 4 * _G + _W
                    for ks in range(4):
                        v = []
                        for h in range(2):
                            var = mb + 32 * ks + 16 * h + 4 * np.arange(4) \
                                + _T[:, None]
                            v.append(_words(pk[var, jj[:, None]].T))
                        for ti in range(mt):
                            pl = plane0 + 2 * ti
                            a = np.stack([(v[0] >> 2 * pl) & LOW2,
                                          (v[0] >> 2 * pl + 2) & LOW2,
                                          (v[1] >> 2 * pl) & LOW2,
                                          (v[1] >> 2 * pl + 2) & LOW2],
                                         axis=1)
                            acc[wgi, ti] += wgmma_m64nNk32(a, b[ks])
            for wgi in range(2):
                sub, plane0 = wgi * mt // 2, (wgi * 2 * mt) % 4
                jj = jb + 32 * sub + 4 * _G + _W
                for ti in range(mt):
                    for rh in range(2):
                        for q in range(bn // 8):
                            for e in range(2):
                                out[plane0 + 2 * ti + rh, jj,
                                    c0 + 8 * q + 2 * _T + e] = \
                                    acc[wgi, ti, :, 4 * q + 2 * rh + e]
    return out[:, :N4]


@pytest.mark.parametrize("shape", [(37, 83, 128), (17, 130, 256),
                                   (300, 90, 16), (40, 97, 32),
                                   (150, 300, 64), (20, 50, 384)])
def test_fragment_contraction_matches_plain(shape):
    """The kernels' operand layouts, k order, tiling and fragment maps,
    contracted fragment by fragment in int32, equal the plain versions
    exactly at every column tile (ragged M and N4, several blocks, stages
    and column tiles, code 3 included)."""
    packed, d4, dm = _operands(*shape, seed=7)
    np.testing.assert_array_equal(
        _fwd_by_fragments(packed, d4),
        grm_kernel.plane_dot_fwd_plain(torch.from_numpy(packed),
                                       torch.from_numpy(d4)).numpy())
    np.testing.assert_array_equal(
        _t_by_fragments(packed, dm),
        grm_kernel.plane_dot_t_plain(torch.from_numpy(packed),
                                     torch.from_numpy(dm)).numpy())


def _rows_operands(M: int, N: int, C: int, seed: int):
    """The store at the GRM store's width, slice rows int8 [N, RS] with RS
    off every tile (as a product's live columns are) and the [4, N4, C]
    slices they stand for, zero-padded; as numpy arrays."""
    packed, d4, _ = _operands(M, N, C, seed, n4=store_width(N))
    rs = max(1, C - 3)
    d4[:, :, rs:] = 0
    return packed, d4.reshape(-1, C)[:N, :rs].copy(), d4


@pytest.mark.parametrize("shape", [(37, 83, 16), (40, 97, 64),
                                   (17, 130, 256), (20, 50, 384)])
def test_rows_operand_is_the_kernels_order(shape):
    """B1's operand written from the slices' sample rows
    (``fwd_rows_operand``) is the header's k order: byte ``128 G + 32 s +
    16 h + 4 t + p`` of row c is sample ``p N4 + 32 G + 8 t + 2 s + h`` of
    the zero-padded slices (zero past N4 and at padded columns), and
    contracted by fragments it equals the plain version, as does
    ``plane_dot_fwd_rows``."""
    M, N, C = shape
    packed, d_rows, d4 = _rows_operands(M, N, C, seed=8)
    N4 = packed.shape[1]
    op = grm_kernel.fwd_rows_operand(torch.from_numpy(d_rows), N4, C,
                                     "cpu").numpy()
    n4p = -(-N4 // 32) * 32
    d4p = np.zeros((4, n4p, C), np.int8)
    d4p[:, :N4] = d4
    #            [p, G, t, s, h, c] -> [c, G, s, h, t, p]
    want = d4p.reshape(4, n4p // 32, 4, 4, 2, C).transpose(5, 1, 3, 4, 2, 0)
    np.testing.assert_array_equal(op, want.reshape(C, 4 * n4p))
    plain = grm_kernel.plane_dot_fwd_plain(torch.from_numpy(packed),
                                           torch.from_numpy(d4)).numpy()
    np.testing.assert_array_equal(_fwd_by_fragments(packed, d4, op), plain)
    np.testing.assert_array_equal(grm_kernel.plane_dot_fwd_rows(
        torch.from_numpy(packed), torch.from_numpy(d_rows), C).numpy(),
        plain)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(37, 1031, 128), (300, 1111, 256),
                                   (4100, 65537, 128), (1, 1031, 128),
                                   (15, 997, 256), (129, 4001, 128),
                                   (129, 1031, 256), (15, 2000, 256),
                                   (129, 4016, 128), (1, 1040, 16),
                                   (15, 1069, 32), (129, 1040, 64),
                                   (129, 1069, 16), (300, 4001, 384),
                                   (37, 2000, 512), (4100, 65537, 16)])
def test_kernels_match_plain_on_card(shape):
    """The hand-written CUDA kernels against their plain versions, on the
    card, at the GRM store's width N4 = store_width(N), at every column
    tile (C = 16 .. 256, and 384 and 512 over several tiles) and ragged
    shapes: M of 1, 15, 129 and others off every block size, ceil(N / 4)
    off a multiple of 16 by 2, 4 and 12 (the store pads it), N4 off the
    32-byte-column stage and the 64-column block."""
    _need_card()
    packed, d4, dm = (torch.from_numpy(a).cuda()
                      for a in _operands(*shape, seed=shape[0],
                                         n4=store_width(shape[1])))
    before = dict(grm_kernel.LAUNCHES)
    fwd = grm_kernel.plane_dot_fwd(packed, d4)
    t = grm_kernel.plane_dot_t(packed, dm)
    torch.cuda.synchronize()
    assert grm_kernel.LAUNCHES["plane_dot_fwd"] == \
        before["plane_dot_fwd"] + 1
    assert grm_kernel.LAUNCHES["plane_dot_t"] == before["plane_dot_t"] + 1
    assert torch.equal(fwd, grm_kernel.plane_dot_fwd_plain(packed, d4))
    assert torch.equal(t, grm_kernel.plane_dot_t_plain(packed, dm))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1040, 16), (15, 1069, 32),
                                   (129, 1031, 64), (300, 4001, 128),
                                   (37, 2000, 256), (129, 1111, 768),
                                   (4100, 65537, 16)])
@pytest.mark.parametrize("where", ["card", "host"])
def test_rows_kernel_matches_plain_on_card(shape, where):
    """Kernel B1 from the slices' sample rows (``plane_dot_fwd_rows``, the
    GRM product's path; the rows on the card or on the host) launches once
    and equals the plain version of the zero-padded slices at every
    column tile, several tiles and ragged shapes; the layout kernel's
    operand equals the CPU's scatter byte for byte."""
    _need_card()
    packed, d_rows, d4 = _rows_operands(*shape, seed=shape[1])
    packed, d4 = torch.from_numpy(packed).cuda(), torch.from_numpy(d4).cuda()
    d_rows = torch.from_numpy(d_rows)
    N4, C = packed.shape[1], shape[2]
    assert torch.equal(
        grm_kernel.fwd_rows_operand(d_rows, N4, C, "cuda").cpu(),
        grm_kernel.fwd_rows_operand(d_rows, N4, C, "cpu"))
    if where == "card":
        d_rows = d_rows.cuda()
    before = grm_kernel.LAUNCHES["plane_dot_fwd"]
    got = grm_kernel.plane_dot_fwd_rows(packed, d_rows, shape[2])
    torch.cuda.synchronize()
    assert grm_kernel.LAUNCHES["plane_dot_fwd"] == before + 1
    assert torch.equal(got, grm_kernel.plane_dot_fwd_plain(packed, d4))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["fwd", "t"])
def test_kernels_exact_at_int32_bound(kernel):
    """Every code 2 and every slice 64 at the largest axis the wrappers
    take (the largest store width below 2^22 for B1): each cell is
    2 * 64 * (4 * N4 or M), just below 2^31, and must come out exact (s32
    sums, no saturation)."""
    _need_card()
    C = 128
    if kernel == "fwd":
        M, N4 = 3, (1 << 22) - 16
        rhs = torch.full((4, N4, C), 64, dtype=torch.int8, device="cuda")
        want = 2 * 64 * 4 * N4
    else:
        M, N4 = (1 << 24) - 1, 16
        rhs = torch.full((M, C), 64, dtype=torch.int8, device="cuda")
        want = 2 * 64 * M
    assert want < 2 ** 31
    packed = torch.full((M, N4), 0xAA, dtype=torch.uint8, device="cuda")
    got = grm_kernel.plane_dot_fwd(packed, rhs) if kernel == "fwd" else \
        grm_kernel.plane_dot_t(packed, rhs)
    torch.cuda.synchronize()
    assert got.shape == ((M, C) if kernel == "fwd" else (4, N4, C))
    assert torch.equal(got, torch.full_like(got, float(want)))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["fwd", "t"])
@pytest.mark.parametrize("rows", ["ragged", "offset"])
def test_kernels_reject_unaligned_rows(kernel, rows):
    """A CUDA store whose rows do not start 16-byte aligned (N4 % 16 != 0,
    or a base one byte in) is refused before any launch."""
    _need_card()
    packed, d4, dm = (torch.from_numpy(a).cuda()
                      for a in _operands(37, 1031, 128, seed=9))
    if rows == "offset":       # N4 = 272, the store's width, one byte in
        packed, d4, dm = (torch.from_numpy(a).cuda() for a in
                          _operands(37, 1031, 128, seed=9,
                                    n4=store_width(1031)))
        flat = torch.zeros(packed.numel() + 1, dtype=torch.uint8,
                           device="cuda")
        flat[1:] = packed.reshape(-1)
        packed = flat[1:].view(packed.shape)
    assert packed.is_contiguous()
    fn = grm_kernel.plane_dot_fwd if kernel == "fwd" else \
        grm_kernel.plane_dot_t
    before = dict(grm_kernel.LAUNCHES)
    with pytest.raises(ValueError, match="16-byte"):
        fn(packed, d4 if kernel == "fwd" else dm)
    assert grm_kernel.LAUNCHES == before
