"""Kernel B4 of the PyTorch port (``score_kernel.indicator_dot``, int8
codes) against the JAX package's Pallas kernel and its XLA twin.

Tolerance: none — bit-equal.  Every output is an exact integer (each
product is at most 2 * 64 = 128 and the sums stay far below 2^24), so the
Pallas kernel ``indicator_dot`` in interpret mode, the ``"xla"`` route of
``score_packed._packed_phase1``, the port's plain version and its CUDA
kernel must agree to the last bit, and so must the numpy emulation of the
kernel's ``mma.sync`` fragments.  Ragged B and N, all four code values,
C = 128 and 256.  The card-only case:
``python -m pytest --noconftest -m cuda tests/test_torch_indicator_dot.py``.
"""

import numpy as np
import pytest
import torch

from test_torch_mma import _indicators_by_fragments, _pad, _words
from _torch_synth import jax_null_model, synth_codes, synth_pheno, \
    var_ratio_table
from saigegds_tpu_torch.models.nullmodel import NullModel
from saigegds_tpu_torch.ops import score_kernel
from saigegds_tpu_torch.ops.score_packed import pack_scan_model

N_SAMPLES = 1031          # ragged against every tile size


def _jax():
    import jax.numpy as jnp
    from saigegds_tpu.ops import pallas_score, score_packed
    from saigegds_tpu.ops.score import ScanParams
    return jnp, pallas_score, score_packed, ScanParams


def _operands(B: int, N: int, C: int, seed: int):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(B, N)).astype(np.int8)
    codes[0] = 3
    codes[1] = 2
    vs = rng.integers(-64, 65, size=(N, C)).astype(np.int8)
    return codes, vs


@pytest.mark.parametrize("C", [128, 256])
@pytest.mark.parametrize("B", [37, 5])
def test_plain_matches_pallas_interpret(B, C):
    jnp, jps, _, _ = _jax()
    codes, vs = _operands(B, N_SAMPLES, C, B + C)
    want = np.asarray(jps.indicator_dot(
        jnp.asarray(codes), jnp.asarray(vs.astype(np.float32))
        .astype(jnp.bfloat16), interpret=True))
    got = score_kernel.indicator_dot(torch.from_numpy(codes),
                                     torch.from_numpy(vs))
    assert got.dtype == torch.float64 and tuple(got.shape) == (B, 3, C)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        score_kernel.indicator_dot_plain(torch.from_numpy(codes),
                                         torch.from_numpy(vs)).numpy(), want)


@pytest.fixture(scope="module")
def models():
    jnp, _, jsp, _ = _jax()
    rng = np.random.default_rng(12)
    X, y = synth_pheno(rng, N_SAMPLES)
    codes = synth_codes(rng, 61, N_SAMPLES, y=y)
    jm = jax_null_model(X, y, var_ratio_table("pooled"))
    jpm = jsp.pack_scan_model(jm.scan_model())
    tpm = pack_scan_model(NullModel.from_arrays(vars(jm))
                          .scan_model(device="cpu"))
    return codes, jpm, tpm


def test_packed_model_vs_view(models):
    """``PackedScanModel.vs`` is B4's [N, Cpad] operand: the JAX package's
    bf16 ``vs`` values, as a view of ``vs4`` (no second copy)."""
    jnp = _jax()[0]
    _, jpm, tpm = models
    vs = tpm.vs
    assert vs.dtype == torch.int8 and vs.is_contiguous()
    assert vs.data_ptr() == tpm.vs4.data_ptr()
    np.testing.assert_array_equal(vs.numpy().astype(np.float32),
                                  np.asarray(jpm.vs.astype(jnp.float32)))


def test_plain_matches_xla_route(models, monkeypatch):
    """The ``xla`` route's raw [B, Cpad] contractions, captured where they
    enter ``_combine_slices``, equal the port's three output planes."""
    jnp, _, jsp, JaxScanParams = _jax()
    codes, jpm, tpm = models
    seen = []
    combine = jsp._combine_slices

    def capture(a, B, R, wts):
        seen.append(np.asarray(a))
        return combine(a, B, R, wts)

    monkeypatch.setattr(jsp, "_combine_slices", capture)
    params = JaxScanParams(maf=-1.0, mac=1.0, missing=0.1, spa_pval=0.05)
    jsp._packed_phase1(jpm, params, jnp.asarray(codes), "xla")
    assert len(seen) == 3
    got = score_kernel.indicator_dot(torch.from_numpy(codes), tpm.vs).numpy()
    for i in range(3):
        np.testing.assert_array_equal(got[:, i], seen[i])


def test_launch_count_untouched_by_plain_version():
    codes, vs = _operands(4, 99, 128, 0)
    before = dict(score_kernel.LAUNCHES)
    score_kernel.indicator_dot(torch.from_numpy(codes), torch.from_numpy(vs))
    assert score_kernel.LAUNCHES == before


@pytest.mark.parametrize("bad", ["dtype", "width", "rows", "samples",
                                 "device"])
def test_wrapper_rejects(bad):
    """Shape, dtype, width and device checks run before any dispatch
    (meta tensors carry shapes without memory)."""
    codes = torch.zeros(3, 64, dtype=torch.int8)
    vs = torch.zeros(64, 128, dtype=torch.int8)
    if bad == "dtype":
        codes = codes.to(torch.uint8)
    elif bad == "width":
        vs = vs[:, :100]
    elif bad == "rows":
        vs = vs[:63]
    elif bad == "samples":
        n = score_kernel.MAX_SAMPLES
        codes = torch.empty(1, n, dtype=torch.int8, device="meta")
        vs = torch.empty(n, 128, dtype=torch.int8, device="meta")
    else:
        codes, vs = codes.to("meta"), vs.to("meta")
    with pytest.raises((TypeError, ValueError)):
        score_kernel.indicator_dot(codes, vs)


@pytest.mark.parametrize("shape", [(37, 1031, 128), (5, 130, 256),
                                   (16, 1026, 128), (17, 1024, 128)])
def test_fragment_contraction_matches_plain(shape):
    """The kernel's operand words (four code bytes of a row as they lie in
    memory against four transposed slice rows, k the sample), split into
    the three indicators and contracted fragment by fragment in int32,
    equal the plain version exactly: ragged B, N % 4 = 3, 2, 2 and 0."""
    B, N, C = shape
    codes, vs = _operands(B, N, C, seed=B * N)
    assert set(np.unique(codes)) == {0, 1, 2, 3}
    cq = _pad(_pad(codes, 0, 16), 1, 32)
    aw = _words(np.moveaxis(cq.reshape(cq.shape[0], -1, 4), -1, 0))
    vq = _pad(vs, 0, 32)
    bw = _words(vq.reshape(-1, 4, C).transpose(1, 0, 2))      # [Q, C]
    got = _indicators_by_fragments(aw, bw)[:B]
    want = score_kernel.indicator_dot_plain(torch.from_numpy(codes),
                                            torch.from_numpy(vs))
    np.testing.assert_array_equal(got, want.numpy())


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(37, 1031, 128), (5, 1031, 256),
                                   (256, 65537, 128)])
def test_kernel_matches_plain_on_card(shape):
    """The hand-written CUDA kernel against its plain version, on the card
    (ragged shapes: B and N off every tile size, N not a multiple of 4)."""
    _need_card()
    codes, vs = _operands(*shape, seed=sum(shape))
    codes, vs = torch.from_numpy(codes).cuda(), torch.from_numpy(vs).cuda()
    before = score_kernel.LAUNCHES["indicator_dot"]
    got = score_kernel.indicator_dot(codes, vs)
    torch.cuda.synchronize()
    assert score_kernel.LAUNCHES["indicator_dot"] == before + 1
    assert torch.equal(got, score_kernel.indicator_dot_plain(codes, vs))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(37, 1031, 1), (16, 4097, 2),
                                   (33, 2000, 3), (64, 1028, 1)])
def test_kernel_takes_any_row_start(shape):
    """Codes whose rows start off a 4-byte boundary (N % 4 != 0, and the
    codes a view one to three bytes into their buffer, as a row slice of
    a decoded batch is) give the plain version's result on the card."""
    _need_card()
    B, N, off = shape
    codes, vs = _operands(B, N, 128, seed=N + off)
    codes, vs = torch.from_numpy(codes).cuda(), torch.from_numpy(vs).cuda()
    flat = torch.zeros(codes.numel() + off, dtype=torch.int8, device="cuda")
    flat[off:] = codes.reshape(-1)
    view = flat[off:].view(codes.shape)
    assert view.is_contiguous() and view.data_ptr() % 4 == off
    got = score_kernel.indicator_dot(view, vs)
    torch.cuda.synchronize()
    assert torch.equal(got, score_kernel.indicator_dot_plain(codes, vs))


@pytest.mark.cuda
def test_kernel_exact_at_int32_bound():
    """Constant codes against slices of 64 at the largest sample count the
    wrapper takes (N = 2^24 - 1, so rows start at every offset mod 4):
    every cell is known in closed form, g0 of code 2 being 2 * 64 * N just
    below 2^31, and must come out exact (s32 sums, no saturation)."""
    _need_card()
    N = score_kernel.MAX_SAMPLES - 1
    assert 2 * 64 * N < 2 ** 31
    codes = torch.tensor([2, 3, 1, 0, 2], dtype=torch.int8,
                         device="cuda")[:, None].expand(5, N).contiguous()
    vs = torch.full((N, 128), 64, dtype=torch.int8, device="cuda")
    got = score_kernel.indicator_dot(codes, vs)
    torch.cuda.synchronize()
    s = 64 * N                           # one indicator over every sample
    want = torch.tensor([[2 * s, 0, s], [0, s, 0], [s, 0, 0], [0, 0, 0],
                         [2 * s, 0, s]], dtype=torch.float64, device="cuda")
    assert torch.equal(got, want[:, :, None].expand(5, 3, 128))
