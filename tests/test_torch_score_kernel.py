"""Kernel B3 of the PyTorch port (``saigegds_tpu_torch/ops/score_kernel``)
against the JAX package's Pallas kernel and its XLA twin.

Tolerance: none — bit-equal (the numpy emulation of the kernel's
``mma.sync`` fragments included).  Every output is an exact integer (each
product is at most 2 * 64 = 128 and the sums stay far below 2^24 at these
sizes), so the Pallas kernel in interpret mode, the ``xla2`` route, the
port's plain version and its CUDA kernel must agree to the last bit.  The
slice decomposition ``_slice_i8`` and the 2-bit pack are bit-equal too.

The JAX package is imported inside the tests that use it, so that the
card-only case runs where jax is not installed:
``python -m pytest --noconftest -m cuda tests/test_torch_score_kernel.py``.
"""

import numpy as np
import pytest
import torch

from test_torch_mma import _indicators_by_fragments, _pad, _spread_planes, \
    _words
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
    """The port's int8 vs4 holds exactly the JAX package's bf16 values."""
    jnp = _jax()[0]
    _, jpm, tpm = setup
    want = np.asarray(jpm.vs4.astype(jnp.float32))
    assert tpm.vs4.dtype == torch.int8
    assert tuple(tpm.vs4.shape) == want.shape
    np.testing.assert_array_equal(tpm.vs4.numpy().astype(np.float32), want)
    np.testing.assert_array_equal(tpm.wts.numpy(), np.asarray(jpm.wts))


def test_plain_matches_pallas_interpret(setup):
    jnp, jps, _, _, jax_pack, _ = _jax()
    codes, jpm, tpm = setup
    packed = jax_pack(codes)
    want = np.asarray(jps.indicator_dot_2bit(jnp.asarray(packed), jpm.vs4,
                                             interpret=True))
    got = score_kernel.indicator_dot_2bit(torch.from_numpy(packed),
                                          tpm.vs4)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), want)


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
        np.testing.assert_array_equal(got[:, i], seen[i])


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
        vs4 = vs4[:, :, :100]
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


@pytest.mark.parametrize("shape", [(37, 1031, 128), (5, 130, 256),
                                   (16, 1024, 128)])
def test_fragment_contraction_matches_plain(shape):
    """The kernel's operand words (spread planes against transposed slice
    bytes, k ordered (byte column, plane)), split into the three indicators
    and contracted fragment by fragment in int32, equal the plain version
    exactly: ragged B, N4 = 258 and 33 (not multiples of 4) and 256."""
    B, N, C = shape
    packed, vs4 = _random_operands(B, N, C, seed=B + N)
    codes = np.stack([(packed >> (2 * p)) & 3 for p in range(4)])
    assert set(np.unique(codes)) == {0, 1, 2, 3}
    aw = _spread_planes(_pad(_pad(packed, 0, 16), 1, 8))    # [Bp, N4p]
    bw = _words(_pad(vs4, 1, 8))                            # [N4p, C]
    got = _indicators_by_fragments(aw, bw)[:B]
    want = score_kernel.indicator_dot_2bit_plain(torch.from_numpy(packed),
                                                 torch.from_numpy(vs4))
    np.testing.assert_array_equal(got, want.numpy())


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(37, 1031), (1024, 65537)])
def test_kernel_matches_plain_on_card(shape):
    """The hand-written CUDA kernel against its plain version, on the card
    (ragged shapes: B and N off every tile size)."""
    _need_card()
    B, N = shape
    packed, vs4 = (torch.from_numpy(a).cuda()
                   for a in _random_operands(B, N, 128, seed=B))
    before = score_kernel.LAUNCHES["indicator_dot_2bit"]
    got = score_kernel.indicator_dot_2bit(packed, vs4)
    torch.cuda.synchronize()
    assert score_kernel.LAUNCHES["indicator_dot_2bit"] == before + 1
    want = score_kernel.indicator_dot_2bit_plain(packed, vs4)
    assert torch.equal(got, want)


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
                   for a in _random_operands(B, N, 128, seed=N + off))
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
    vs4 = torch.full((4, n4, 128), 64, dtype=torch.int8, device="cuda")
    got = score_kernel.indicator_dot_2bit(packed, vs4)
    torch.cuda.synchronize()
    s = 64 * 4 * n4                      # one indicator over every sample
    want = torch.tensor([[2 * s, 0, s], [0, s, 0], [s, 0, 0], [0, 0, 0]],
                        dtype=torch.float64, device="cuda")
    assert torch.equal(got, want[:, :, None].expand(4, 3, 128))
