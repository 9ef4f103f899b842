"""Kernel B4 of the PyTorch port (``score_kernel.indicator_dot``, int8
codes) against the JAX package's Pallas kernel and its XLA twin.

Tolerance: none — bit-equal.  Every output is an exact integer (each
product is at most 2 * 64 = 128 and the sums stay far below 2^24), so the
Pallas kernel ``indicator_dot`` in interpret mode, the ``"xla"`` route of
``score_packed._packed_phase1``, the port's plain version and its CUDA
kernel must agree to the last bit, and so must the numpy emulation of the
kernel's warpgroup-MMA contraction.  Ragged B and N, all four code values,
every column tile.  The JAX package takes C a multiple of 128, the port a
width of its kernels' tiles (``score_kernel.padded_cols``): where both get
the same slices, the port's copy is zero-padded to its width (or the JAX
package's columns past the port's are zero) and the tests compare the
same columns.  The card-only cases:
``python -m pytest --noconftest -m cuda tests/test_torch_indicator_dot.py``.
"""

import numpy as np
import pytest
import torch

from test_torch_wgmma import LOW2, _bytes, _words, indicator_tile
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
    Cp = score_kernel.padded_cols(C)          # 128 -> 128, 256 -> 288
    vp = np.zeros((vs.shape[0], Cp), np.int8)
    vp[:, :C] = vs
    got = score_kernel.indicator_dot(torch.from_numpy(codes),
                                     torch.from_numpy(vp))
    assert got.dtype == torch.float64 and tuple(got.shape) == (B, 3, Cp)
    np.testing.assert_array_equal(got.numpy()[..., :C], want)
    assert not got.numpy()[..., C:].any()
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
    bf16 ``vs`` values in its columns (the JAX package's further columns
    zero), as a view of ``vs4`` (no second copy)."""
    jnp = _jax()[0]
    _, jpm, tpm = models
    vs = tpm.vs
    want = np.asarray(jpm.vs.astype(jnp.float32))
    assert vs.dtype == torch.int8 and vs.is_contiguous()
    assert vs.data_ptr() == tpm.vs4.data_ptr()
    np.testing.assert_array_equal(vs.numpy().astype(np.float32),
                                  want[:, :vs.shape[1]])
    assert not want[:, vs.shape[1]:].any()


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
        np.testing.assert_array_equal(got[:, i], seen[i][:, :got.shape[2]])


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


@pytest.mark.parametrize("shape", [(3, 1031, 96), (2, 130, 32), (1, 5, 64),
                                   (2, 1024, 384)])
def test_operand_gives_back_vs(shape):
    """B4's once-per-model layout read back by the kernel's k order: byte
    ``128 G + 32 s + 16 h + 4 t + i`` of row c is ``vs[128 G + 32 t + 8 s +
    4 h + i, c]``, every byte of vs exactly once, zero past N."""
    _, N, C = shape
    _, vs = _operands(2, N, C, seed=N)
    op = score_kernel.operand(torch.from_numpy(vs)).numpy()
    npad = -(-N // 128) * 128
    assert op.shape == (C, npad) and op.dtype == np.int8
    #        [c, G, s, h, t, i] -> [G, t, s, h, i, c]
    back = op.reshape(C, npad // 128, 4, 2, 4, 4).transpose(1, 4, 2, 3, 5, 0)
    back = back.reshape(npad, C)
    np.testing.assert_array_equal(back[:N], vs)
    assert not back[N:].any()


def _split_bytes(c: np.ndarray):
    """B4's split of code words (``Bytes::build``), byte by byte:
    g0 = code - 3 m, m = [code == 3], g2 = [code == 2]."""
    c = c.astype(np.uint32) & LOW2
    hi = c >> 1
    m = c & hi & np.uint32(0x01010101)
    return c - np.uint32(3) * m, m, hi & ~c & np.uint32(0x01010101)


def test_indicator_split_every_code_word():
    """Every word of four codes (all 256) splits into g0 (the code,
    missing as 0), [code == 3] and [code == 2], byte by byte."""
    codes = np.stack(np.meshgrid(*[np.arange(4)] * 4, indexing="ij"),
                     axis=-1).reshape(-1, 4)                 # [256, 4]
    for v, want in zip(_split_bytes(_words(codes.T.astype(np.uint8))),
                       (np.where(codes == 3, 0, codes), codes == 3,
                        codes == 2)):
        np.testing.assert_array_equal(_bytes(v), want.astype(np.int32))


def _build_bytes(w: np.ndarray, a: np.ndarray, rh: int):
    """``Bytes::build``: a thread's eight code words of row rh (samples
    32t .. 32t+31 of the stage) -> word j is the A word of k-step j // 2,
    half j % 2, for each indicator."""
    for j in range(8):
        for x, v in enumerate(_split_bytes(w[:, j])):
            a[x, j // 2, :, rh + 2 * (j % 2)] = v


@pytest.mark.parametrize("shape", [(37, 1031, 96, 0), (5, 130, 32, 3),
                                   (16, 1026, 64, 1), (17, 1024, 128, 0),
                                   (130, 300, 384, 2)])
def test_fragment_contraction_matches_plain(shape):
    """The kernel's contraction emulated in numpy (``indicator_tile.cuh``
    with B4's policy: each thread's 32-byte spans of rows that start off a
    4-byte boundary, the indicator split, the slices laid out once by
    ``operand`` and read through TMA's swizzled tile, one wgmma per
    indicator and k-step) equals the plain version exactly: ragged B, N %
    128 off 0 and N % 4 = 3, 2, 2, 0, 0, each tile width and two
    multi-tile C, rows starting at every offset modulo 4."""
    B, N, C, off = shape
    codes, vs = _operands(B, N, C, seed=B * N)
    assert set(np.unique(codes)) == {0, 1, 2, 3}
    op = score_kernel.operand(torch.from_numpy(vs)).numpy()
    got = indicator_tile(codes, off, 32, _build_bytes, op,
                         score_kernel.column_tile(C))
    want = score_kernel.indicator_dot_plain(torch.from_numpy(codes),
                                            torch.from_numpy(vs))
    np.testing.assert_array_equal(got, want.numpy())


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(37, 1031, 32), (37, 1031, 64),
                                   (37, 1031, 96), (5, 1031, 128),
                                   (37, 1031, 384), (256, 65537, 96),
                                   (300, 65537, 192)])
def test_kernel_matches_plain_on_card(shape):
    """The hand-written CUDA kernel against its plain version, on the card
    (ragged shapes: B and N off every tile size, N not a multiple of 4;
    every column tile and multi-tile C), with the layout made by the
    wrapper and handed over."""
    _need_card()
    codes, vs = _operands(*shape, seed=sum(shape))
    codes, vs = torch.from_numpy(codes).cuda(), torch.from_numpy(vs).cuda()
    before = score_kernel.LAUNCHES["indicator_dot"]
    got = score_kernel.indicator_dot(codes, vs)
    again = score_kernel.indicator_dot(codes, vs, score_kernel.operand(vs))
    torch.cuda.synchronize()
    assert score_kernel.LAUNCHES["indicator_dot"] == before + 2
    want = score_kernel.indicator_dot_plain(codes, vs)
    assert torch.equal(got, want) and torch.equal(again, want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(37, 1031, 1), (16, 4097, 2),
                                   (33, 2000, 3), (64, 1028, 1)])
def test_kernel_takes_any_row_start(shape):
    """Codes whose rows start off a 4-byte boundary (N % 4 != 0, and the
    codes a view one to three bytes into their buffer, as a row slice of
    a decoded batch is) give the plain version's result on the card."""
    _need_card()
    B, N, off = shape
    codes, vs = _operands(B, N, 96, seed=N + off)
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
    vs = torch.full((N, 96), 64, dtype=torch.int8, device="cuda")
    got = score_kernel.indicator_dot(codes, vs)
    torch.cuda.synchronize()
    s = 64 * N                           # one indicator over every sample
    want = torch.tensor([[2 * s, 0, s], [0, s, 0], [s, 0, 0], [0, 0, 0],
                         [2 * s, 0, s]], dtype=torch.float64, device="cuda")
    assert torch.equal(got, want[:, :, None].expand(5, 3, 96))
