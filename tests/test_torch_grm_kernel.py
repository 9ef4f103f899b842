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

from test_torch_mma import _G, _T, _mma_m16n8k32, _pad, _spread_planes, \
    _words
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


# The kernels' fragment maps (the mma itself is emulated in test_torch_mma).


def _fwd_by_fragments(packed: np.ndarray, d4: np.ndarray) -> np.ndarray:
    """B1 as the kernel contracts it: k ordered (byte column j, plane p),
    one mma per 16 variants x 8 byte columns x 8 columns."""
    M, C = packed.shape[0], d4.shape[2]
    aw = _spread_planes(_pad(_pad(packed, 0, 16), 1, 8))    # [Mp, N4p]
    bw = _words(_pad(d4, 1, 8))                             # [N4p, C]
    out = np.zeros((aw.shape[0], C), np.int64)
    for ks in range(0, aw.shape[1], 8):
        for r in range(0, aw.shape[0], 16):
            a = np.stack([aw[r + _G, ks + _T], aw[r + _G + 8, ks + _T],
                          aw[r + _G, ks + 4 + _T],
                          aw[r + _G + 8, ks + 4 + _T]], axis=1)
            for c in range(0, C, 8):
                b = np.stack([bw[ks + _T, c + _G], bw[ks + 4 + _T, c + _G]],
                             axis=1)
                d = _mma_m16n8k32(a, b)
                for h in range(2):
                    out[r + _G + 8 * h, c + 2 * _T] += d[:, 2 * h]
                    out[r + _G + 8 * h, c + 2 * _T + 1] += d[:, 2 * h + 1]
    return out[:M]


def _t_by_fragments(packed: np.ndarray, dm: np.ndarray) -> np.ndarray:
    """B2 as the kernel contracts it: output rows (plane p, byte column j),
    an m16 tile being 16 byte columns of one plane; k is the variant, one
    word per four consecutive variants."""
    N4, C = packed.shape[1], dm.shape[1]
    pk = _pad(_pad(packed, 0, 32), 1, 16)
    x = _words(pk.reshape(-1, 4, pk.shape[1]).transpose(1, 0, 2))  # [Q, N4p]
    aw = np.stack([(x >> (2 * p)) & 0x03030303 for p in range(4)])
    bw = _words(_pad(dm, 0, 32).reshape(-1, 4, C).transpose(1, 0, 2))
    out = np.zeros((4, aw.shape[2], C), np.int64)
    for kq in range(0, aw.shape[1], 8):
        for p in range(4):
            for j in range(0, aw.shape[2], 16):
                w = aw[p]
                a = np.stack([w[kq + _T, j + _G], w[kq + _T, j + _G + 8],
                              w[kq + 4 + _T, j + _G],
                              w[kq + 4 + _T, j + _G + 8]], axis=1)
                for c in range(0, C, 8):
                    b = np.stack([bw[kq + _T, c + _G],
                                  bw[kq + 4 + _T, c + _G]], axis=1)
                    d = _mma_m16n8k32(a, b)
                    for h in range(2):
                        out[p, j + _G + 8 * h, c + 2 * _T] += d[:, 2 * h]
                        out[p, j + _G + 8 * h, c + 2 * _T + 1] += \
                            d[:, 2 * h + 1]
    return out[:, :N4]


def test_mma_fragment_map_is_a_matrix_product():
    """The emulated mma against a plain int32 product of the same tiles."""
    rng = np.random.default_rng(6)
    A = rng.integers(-128, 128, size=(16, 32), dtype=np.int8)
    B = rng.integers(-128, 128, size=(32, 8), dtype=np.int8)
    k4 = 4 * _T[:, None] + np.arange(4)
    word = lambda v: _words(np.moveaxis(v, -1, 0))          # noqa: E731
    a = np.stack([word(A[_G[:, None], k4]), word(A[_G[:, None] + 8, k4]),
                  word(A[_G[:, None], k4 + 16]),
                  word(A[_G[:, None] + 8, k4 + 16])], axis=1)
    b = np.stack([word(B[k4, _G[:, None]]), word(B[k4 + 16, _G[:, None]])],
                 axis=1)
    D = A.astype(np.int32) @ B.astype(np.int32)
    d = _mma_m16n8k32(a, b)
    np.testing.assert_array_equal(d[:, 0], D[_G, 2 * _T])
    np.testing.assert_array_equal(d[:, 3], D[_G + 8, 2 * _T + 1])


@pytest.mark.parametrize("shape", [(37, 83, 128), (17, 130, 256)])
def test_fragment_contraction_matches_plain(shape):
    """The kernels' operand words and k order, contracted fragment by
    fragment in int32, equal the plain versions exactly (ragged M and N4,
    code 3 included)."""
    packed, d4, dm = _operands(*shape, seed=7)
    np.testing.assert_array_equal(
        _fwd_by_fragments(packed, d4),
        grm_kernel.plane_dot_fwd_plain(torch.from_numpy(packed),
                                       torch.from_numpy(d4)).numpy())
    np.testing.assert_array_equal(
        _t_by_fragments(packed, dm),
        grm_kernel.plane_dot_t_plain(torch.from_numpy(packed),
                                     torch.from_numpy(dm)).numpy())


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(37, 1031, 128), (300, 1111, 256),
                                   (4100, 65537, 128), (1, 1031, 128),
                                   (15, 997, 256), (129, 4001, 128),
                                   (129, 1031, 256), (15, 2000, 256),
                                   (129, 4016, 128)])
def test_kernels_match_plain_on_card(shape):
    """The hand-written CUDA kernels against their plain versions, on the
    card, at the GRM store's width N4 = store_width(N) (ragged shapes: M
    and N off every tile size, N4 off the 8- and 32-byte-column steps)."""
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
@pytest.mark.parametrize("kernel", ["fwd", "t"])
def test_kernels_exact_at_int32_bound(kernel):
    """Every code 2 and every slice 64 at the largest axis the wrappers
    take (the largest store width below 2^22 for B1): each cell is
    2 * 64 * (4 * N4 or M), just below 2^31, and must come out exact (s32
    sums, no saturation)."""
    _need_card()
    C = 128
    if kernel == "fwd":
        M, N4 = 3, (1 << 22) - 4
        rhs = torch.full((4, N4, C), 64, dtype=torch.int8, device="cuda")
        want = 2 * 64 * 4 * N4
    else:
        M, N4 = (1 << 24) - 1, 4
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
    """A CUDA store whose rows do not start 4-byte aligned (N4 % 4 != 0,
    or a base one byte in) is refused before any launch."""
    _need_card()
    packed, d4, dm = (torch.from_numpy(a).cuda()
                      for a in _operands(37, 1031, 128, seed=9))
    if rows == "offset":       # N4 = 260, the store's width, one byte in
        packed, d4, dm = (torch.from_numpy(a).cuda() for a in
                          _operands(37, 1031, 128, seed=9, n4=260))
        flat = torch.zeros(packed.numel() + 1, dtype=torch.uint8,
                           device="cuda")
        flat[1:] = packed.reshape(-1)
        packed = flat[1:].view(packed.shape)
    assert packed.is_contiguous()
    fn = grm_kernel.plane_dot_fwd if kernel == "fwd" else \
        grm_kernel.plane_dot_t
    before = dict(grm_kernel.LAUNCHES)
    with pytest.raises(ValueError, match="4-byte"):
        fn(packed, d4 if kernel == "fwd" else dm)
    assert grm_kernel.LAUNCHES == before
