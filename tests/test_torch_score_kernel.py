"""Kernel B3 of the PyTorch port (``saigegds_tpu_torch/ops/score_kernel``)
against the JAX package's Pallas kernel and its XLA twin.

Tolerance: none — bit-equal.  Every output is an exact integer (each
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


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(37, 1031), (1024, 65537)])
def test_kernel_matches_plain_on_card(shape):
    """The hand-written CUDA kernel against its plain version, on the card
    (ragged shapes: B and N off every tile size)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    B, N = shape
    rng = np.random.default_rng(B)
    n4 = -(-N // 4)
    packed = torch.from_numpy(rng.integers(0, 256, size=(B, n4),
                                           dtype=np.uint8)).cuda()
    vs4 = rng.integers(-64, 65, size=(4, n4, 128), dtype=np.int8)
    vs4.reshape(-1, 128)[N:] = 0                  # padded samples
    vs4 = torch.from_numpy(vs4).cuda()
    before = score_kernel.LAUNCHES["indicator_dot_2bit"]
    got = score_kernel.indicator_dot_2bit(packed, vs4)
    torch.cuda.synchronize()
    assert score_kernel.LAUNCHES["indicator_dot_2bit"] == before + 1
    want = score_kernel.indicator_dot_2bit_plain(packed, vs4)
    assert torch.equal(got, want)
