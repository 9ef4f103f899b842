"""Kernel B3 of the PyTorch port (``saigegds_tpu_torch/ops/score_kernel``)
against the JAX package's Pallas kernel and its XLA twin.

Tolerance: none — bit-equal (the numpy emulation of the kernel's
warpgroup-MMA contraction included).  Every output is an exact integer
(each product is at most 2 * 64 = 128 and the sums stay far below 2^24 at
these sizes), so the Pallas kernel in interpret mode, the ``xla2`` route,
the port's plain version and its CUDA kernel must agree to the last bit.
The slice decomposition ``_slice_i8`` and the 2-bit pack are bit-equal
too.  The port pads the slices to its kernels' tiles
(``score_kernel.padded_cols``: 88 live columns -> 96), the JAX package to
a multiple of 128; the JAX side's extra columns are zero, and the tests
compare the port's columns.

The JAX package is imported inside the tests that use it, so that the
card-only cases run where jax is not installed:
``python -m pytest --noconftest -m cuda tests/test_torch_score_kernel.py``.
"""

import numpy as np
import pytest
import torch

from test_torch_wgmma import LOW2, _bytes, indicator_tile
from _torch_synth import jax_null_model, synth_codes, synth_pheno, \
    var_ratio_table
from saigegds_tpu_torch.models.nullmodel import NullModel
from saigegds_tpu_torch.ops import score_kernel
from saigegds_tpu_torch.ops.packed_grm import _slice_i8, pack_codes_2bit, \
    unpack_codes_2bit
from saigegds_tpu_torch.ops.score_packed import pack_scan_model

N_SAMPLES = 1031          # not a multiple of 4: the last plane pads


def _jax():
    """The JAX package's side of the comparison."""
    import jax.numpy as jnp
    from saigegds_tpu.ops import pallas_score, score_packed
    from saigegds_tpu.ops.packed_grm import _slice_i8, pack_codes_2bit
    from saigegds_tpu.ops.score import ScanParams
    return jnp, pallas_score, score_packed, _slice_i8, pack_codes_2bit, \
        ScanParams


@pytest.fixture(scope="module")
def setup():
    jnp, _, jsp, _, _, _ = _jax()
    rng = np.random.default_rng(11)
    X, y = synth_pheno(rng, N_SAMPLES)
    codes = synth_codes(rng, 97, N_SAMPLES, y=y)
    jm = jax_null_model(X, y, var_ratio_table("pooled"))
    jpm = jsp.pack_scan_model(jm.scan_model())
    tpm = pack_scan_model(NullModel.from_arrays(vars(jm))
                          .scan_model(device="cpu"))
    return codes, jpm, tpm


def test_packed_model_slices_bit_equal(setup):
    """The port's int8 vs4 holds exactly the JAX package's bf16 values in
    its columns (96 for the 88 live ones), and the JAX package's columns
    past them (to 128) are zero; on the CPU no kernel layout is made."""
    jnp = _jax()[0]
    _, jpm, tpm = setup
    want = np.asarray(jpm.vs4.astype(jnp.float32))
    C = tpm.vs4.shape[2]
    assert tpm.vs4.dtype == torch.int8
    assert C == score_kernel.padded_cols(tpm.V.shape[0] * 8) == 96
    assert tuple(tpm.vs4.shape) == want.shape[:2] + (C,)
    np.testing.assert_array_equal(tpm.vs4.numpy().astype(np.float32),
                                  want[..., :C])
    assert not want[..., C:].any()
    np.testing.assert_array_equal(tpm.wts.numpy(), np.asarray(jpm.wts))
    assert tpm.vs4k is None and tpm.vsk is None


def test_plain_matches_pallas_interpret(setup):
    jnp, jps, _, _, jax_pack, _ = _jax()
    codes, jpm, tpm = setup
    packed = jax_pack(codes)
    want = np.asarray(jps.indicator_dot_2bit(jnp.asarray(packed), jpm.vs4,
                                             interpret=True))
    got = score_kernel.indicator_dot_2bit(torch.from_numpy(packed),
                                          tpm.vs4)
    assert got.dtype == torch.float64
    C = got.shape[2]
    np.testing.assert_array_equal(got.numpy(), want[..., :C])
    assert not want[..., C:].any()


def test_plain_matches_xla2_route(setup, monkeypatch):
    """The xla2 route's raw [B, Cpad] contractions, captured where they
    enter ``_combine_slices``, equal the port's three output planes."""
    jnp, _, jsp, _, jax_pack, JaxScanParams = _jax()
    codes, jpm, tpm = setup
    packed = jax_pack(codes)
    seen = []
    combine = jsp._combine_slices

    def capture(a, B, R, wts):
        seen.append(np.asarray(a))
        return combine(a, B, R, wts)

    monkeypatch.setattr(jsp, "_combine_slices", capture)
    params = JaxScanParams(maf=-1.0, mac=1.0, missing=0.1, spa_pval=0.05)
    jsp._packed_phase1(jpm, params, jnp.asarray(packed), "xla2")
    assert len(seen) == 3
    got = score_kernel.indicator_dot_2bit(torch.from_numpy(packed),
                                          tpm.vs4).numpy()
    for i in range(3):
        np.testing.assert_array_equal(got[:, i], seen[i][:, :got.shape[2]])


def test_launch_count_untouched_by_plain_version(setup):
    jax_pack = _jax()[4]
    codes, _, tpm = setup
    before = dict(score_kernel.LAUNCHES)
    score_kernel.indicator_dot_2bit(torch.from_numpy(jax_pack(codes[:5])),
                                    tpm.vs4)
    assert score_kernel.LAUNCHES == before


@pytest.mark.parametrize("bad", ["dtype", "width", "samples", "device"])
def test_wrapper_rejects(setup, bad):
    """Shape, dtype, width and device checks run before any dispatch
    (meta tensors carry shapes without memory)."""
    _, _, tpm = setup
    packed = torch.zeros(3, tpm.vs4.shape[1], dtype=torch.uint8)
    vs4 = tpm.vs4
    if bad == "dtype":
        vs4 = vs4.to(torch.int16)
    elif bad == "width":
        vs4 = vs4[:, :, :90]           # not a width the kernels run
    elif bad == "samples":
        n4 = score_kernel.MAX_SAMPLES // 4
        packed = torch.empty(1, n4, dtype=torch.uint8, device="meta")
        vs4 = torch.empty(4, n4, 128, dtype=torch.int8, device="meta")
    else:
        packed = packed.to("meta")
        vs4 = vs4.to("meta")
    with pytest.raises((TypeError, ValueError)):
        score_kernel.indicator_dot_2bit(packed, vs4)


def test_slice_i8_bit_equal():
    jnp, _, _, jax_slice_i8, _, _ = _jax()
    rng = np.random.default_rng(3)
    x = rng.normal(size=(257, 6)) * np.array([1e-9, 1.0, 3e4, 1.0, 0.0, 7.0])
    x[5, 3] = -2.5
    x[:, 3] = np.round(x[:, 3] * 2) / 2           # exact halves: ties
    d, scale = _slice_i8(torch.from_numpy(x), 8)
    jd, jscale = jax_slice_i8(jnp.asarray(x), 8)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))


@pytest.mark.parametrize("n", [1031, 1032, 5])
def test_pack_codes_2bit_roundtrip(n):
    jax_pack = _jax()[4]
    rng = np.random.default_rng(n)
    codes = rng.integers(0, 4, size=(9, n)).astype(np.int8)
    packed = pack_codes_2bit(codes)
    np.testing.assert_array_equal(packed, jax_pack(codes))
    np.testing.assert_array_equal(unpack_codes_2bit(packed, n), codes)


def _random_operands(B: int, N: int, C: int, seed: int):
    """Random packed bytes (all four codes) [B, ceil(N/4)] and slices
    [4, ceil(N/4), C] in [-64, 64] with zero rows at padded samples."""
    rng = np.random.default_rng(seed)
    n4 = -(-N // 4)
    packed = rng.integers(0, 256, size=(B, n4), dtype=np.uint8)
    vs4 = rng.integers(-64, 65, size=(4, n4, C), dtype=np.int8)
    vs4.reshape(-1, C)[N:] = 0
    return packed, vs4


def test_column_rule():
    """``padded_cols`` pads to the fewest tiles of at most 96 columns, each
    as narrow as the tiles 32, 64, 96 allow; ``column_tile`` splits an
    accepted C into those tiles; every live count of 2K + 3 vectors x 8
    slices pads by less than a tile."""
    assert [score_kernel.padded_cols(c) for c in (1, 32, 33, 40, 56, 72, 88,
                                                  96, 104, 120, 136, 184,
                                                  200, 384)] == \
        [32, 32, 64, 64, 64, 96, 96, 96, 128, 128, 192, 192, 288, 384]
    for k in range(1, 40):
        live = (2 * k + 3) * 8
        C = score_kernel.padded_cols(live)
        tile = score_kernel.column_tile(C)
        assert C >= live and C % tile == 0 and C - live < tile
        assert tile in score_kernel.COLUMN_TILES
        assert C // tile == -(-live // 96)
        assert score_kernel.padded_cols(C) == C


@pytest.mark.parametrize("shape", [(3, 1031, 96), (2, 130, 32), (1, 5, 64),
                                   (2, 1024, 384)])
def test_operand_2bit_gives_back_vs4(shape):
    """B3's once-per-model layout read back by the kernel's k order: byte
    ``128 G + 32 p + 16 w + 4 t + i`` of row c is ``vs4[p, 32 G + 8 t +
    4 w + i, c]``, every byte of vs4 exactly once, zero past N4."""
    _, N, C = shape
    _, vs4 = _random_operands(1, N, C, seed=N + C)
    op = score_kernel.operand_2bit(torch.from_numpy(vs4)).numpy()
    n4 = vs4.shape[1]
    n4p = -(-n4 // 32) * 32
    assert op.shape == (C, 4 * n4p) and op.dtype == np.int8
    #        [c, G, p, w, t, i] -> [p, G, t, w, i, c]
    back = op.reshape(C, n4p // 32, 4, 2, 4, 4).transpose(2, 1, 4, 3, 5, 0)
    back = back.reshape(4, n4p, C)
    np.testing.assert_array_equal(back[:, :n4], vs4)
    assert not back[:, n4:].any()


def _split_2bit(x: np.ndarray):
    """B3's split of packed words (``Planar2::build``): per 2-bit field,
    m = [code == 3], g2 = [code == 2] in the field's low bit,
    g0 = code - 3 m."""
    x = x.astype(np.uint32)
    hi = x >> 1
    m = x & hi & np.uint32(0x55555555)
    return x - np.uint32(3) * m, m, hi & ~x & np.uint32(0x55555555)


def test_indicator_split_every_byte():
    """Every packed byte (four codes) in every byte of a word splits into
    g0 (the code, missing as 0), [code == 3] and [code == 2], field by
    field, and plane p of each is one shift and one mask."""
    x = np.arange(256, dtype=np.uint32)
    words = x | (x[::-1] << 8) | (x << 16) | ((x * 7 % 256) << 24)
    codes = np.stack([(words >> (2 * f)) & 3 for f in range(16)])  # [16, 256]
    for v, want in zip(_split_2bit(words),
                       (np.where(codes == 3, 0, codes), codes == 3,
                        codes == 2)):
        got = np.stack([(v >> (2 * f)) & 3 for f in range(16)])
        np.testing.assert_array_equal(got, want.astype(np.uint32))
        for p in range(4):
            plane = _bytes((v >> np.uint32(2 * p)) & LOW2)      # [256, 4]
            np.testing.assert_array_equal(plane.T, got[p::4])


def _build_2bit(w: np.ndarray, a: np.ndarray, rh: int):
    """``Planar2::build``: a thread's two packed words of row rh (byte
    columns 8t .. 8t+7 of the stage) -> plane p of word w is the A word of
    k-step p, half w, for each indicator."""
    for wi in range(2):
        for x, v in enumerate(_split_2bit(w[:, wi])):
            for p in range(4):
                a[x, p, :, rh + 2 * wi] = (v >> np.uint32(2 * p)) & LOW2


@pytest.mark.parametrize("shape", [(37, 1031, 96, 0), (5, 130, 32, 1),
                                   (16, 1024, 64, 2), (130, 517, 128, 3),
                                   (9, 999, 384, 0)])
def test_fragment_contraction_matches_plain(shape):
    """The kernel's contraction emulated in numpy (``indicator_tile.cuh``
    with B3's policy: each thread's packed words from rows that start off
    a 4-byte boundary, the indicator split, plane shifts, the slices laid
    out once by ``operand_2bit`` and read through TMA's swizzled tile, one
    wgmma per indicator and k-step) equals the plain version exactly: ragged
    B and N4 (258, 33, 256, 130, 250), each tile width and two multi-tile
    C, rows starting at every offset modulo 4."""
    B, N, C, off = shape
    packed, vs4 = _random_operands(B, N, C, seed=B + N)
    codes = np.stack([(packed >> (2 * p)) & 3 for p in range(4)])
    assert set(np.unique(codes)) == {0, 1, 2, 3}
    op = score_kernel.operand_2bit(torch.from_numpy(vs4)).numpy()
    got = indicator_tile(packed, off, 8, _build_2bit, op,
                         score_kernel.column_tile(C))
    want = score_kernel.indicator_dot_2bit_plain(torch.from_numpy(packed),
                                                 torch.from_numpy(vs4))
    np.testing.assert_array_equal(got, want.numpy())


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(37, 1031, 32), (37, 1031, 64),
                                   (37, 1031, 96), (37, 1031, 128),
                                   (37, 1031, 384), (1024, 65537, 96),
                                   (300, 65537, 192)])
def test_kernel_matches_plain_on_card(shape):
    """The hand-written CUDA kernel against its plain version, on the card
    (ragged shapes: B and N off every tile size; every column tile and
    multi-tile C), with the layout made by the wrapper and handed over."""
    _need_card()
    B, N, C = shape
    packed, vs4 = (torch.from_numpy(a).cuda()
                   for a in _random_operands(B, N, C, seed=B))
    before = score_kernel.LAUNCHES["indicator_dot_2bit"]
    got = score_kernel.indicator_dot_2bit(packed, vs4)
    again = score_kernel.indicator_dot_2bit(
        packed, vs4, score_kernel.operand_2bit(vs4))
    torch.cuda.synchronize()
    assert score_kernel.LAUNCHES["indicator_dot_2bit"] == before + 2
    want = score_kernel.indicator_dot_2bit_plain(packed, vs4)
    assert torch.equal(got, want) and torch.equal(again, want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(37, 1031, 1), (16, 4097, 2),
                                   (33, 2000, 3), (64, 1029, 0)])
def test_kernel_takes_any_row_start(shape):
    """Rows that start off a 4-byte boundary (N4 % 4 != 0, and the payload
    a view one to three bytes into its buffer) give the plain version's
    result on the card."""
    _need_card()
    B, N, off = shape
    packed, vs4 = (torch.from_numpy(a).cuda()
                   for a in _random_operands(B, N, 96, seed=N + off))
    flat = torch.zeros(packed.numel() + off, dtype=torch.uint8,
                       device="cuda")
    flat[off:] = packed.reshape(-1)
    view = flat[off:].view(packed.shape)
    assert view.is_contiguous() and view.data_ptr() % 4 == off
    got = score_kernel.indicator_dot_2bit(view, vs4)
    torch.cuda.synchronize()
    assert torch.equal(got, score_kernel.indicator_dot_2bit_plain(packed,
                                                                  vs4))


@pytest.mark.cuda
def test_kernel_exact_at_int32_bound():
    """Constant codes against slices of 64 at the largest byte-column count
    the wrapper takes (4 * N4 just under 2^24, N4 % 4 == 3): every cell is
    known in closed form, g0 of code 2 being 2 * 64 * 4 * N4 just below
    2^31, and must come out exact (s32 sums, no saturation)."""
    _need_card()
    n4 = score_kernel.MAX_SAMPLES // 4 - 1
    assert n4 % 4 == 3 and 2 * 64 * 4 * n4 < 2 ** 31
    packed = torch.tensor([0xAA, 0xFF, 0x55, 0x00], dtype=torch.uint8,
                          device="cuda")[:, None].expand(4, n4).contiguous()
    vs4 = torch.full((4, n4, 96), 64, dtype=torch.int8, device="cuda")
    got = score_kernel.indicator_dot_2bit(packed, vs4)
    torch.cuda.synchronize()
    s = 64 * 4 * n4                      # one indicator over every sample
    want = torch.tensor([[2 * s, 0, s], [0, s, 0], [s, 0, 0], [0, 0, 0]],
                        dtype=torch.float64, device="cuda")
    assert torch.equal(got, want[:, :, None].expand(4, 3, 96))


@pytest.mark.cuda
def test_scan_uses_the_models_layouts(monkeypatch):
    """A model packed on the card carries both kernels' layouts, made once
    (``pack_scan_model``), and a block's phase 1 on either route goes
    through them: no layout is made per block."""
    _need_card()
    from saigegds_tpu_torch.ops import score_packed
    from saigegds_tpu_torch.ops.score import ScanModel
    rng = np.random.default_rng(4)
    X, y = synth_pheno(rng, N_SAMPLES)
    codes = synth_codes(rng, 40, N_SAMPLES, y=y)
    mu = np.clip(rng.uniform(0.05, 0.5, N_SAMPLES), 0.05, 0.5)
    W = mu * (1 - mu)
    XV = (X * W[:, None]).T
    f64 = lambda a: torch.as_tensor(a, dtype=torch.float64,   # noqa: E731
                                    device="cuda")
    sm = ScanModel(True, f64([1.0, 0.5]), f64(y), f64(mu), f64(y - mu),
                   f64(W), f64(XV), f64(X @ np.linalg.inv(XV @ X)), 1.0)
    pm = pack_scan_model(sm)
    assert pm.vs4.shape[2] == 96
    assert torch.equal(pm.vs4k, score_kernel.operand_2bit(pm.vs4))
    assert torch.equal(pm.vsk, score_kernel.operand(pm.vs))

    def refuse(*_):
        raise AssertionError("a layout was made per block")

    monkeypatch.setattr(score_kernel, "operand_2bit", refuse)
    monkeypatch.setattr(score_kernel, "operand", refuse)
    before = dict(score_kernel.LAUNCHES)
    two = score_packed._contract(pm, torch.from_numpy(
        pack_codes_2bit(codes)).cuda())
    one = score_packed._contract(pm, torch.from_numpy(codes).cuda())
    torch.cuda.synchronize()
    assert score_kernel.LAUNCHES["indicator_dot_2bit"] == \
        before["indicator_dot_2bit"] + 1
    assert score_kernel.LAUNCHES["indicator_dot"] == \
        before["indicator_dot"] + 1
    assert torch.equal(two, one)
