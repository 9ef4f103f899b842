"""The port's sparse transport (``saigegds_tpu_torch/ops/sparse_codes``):
the host encoder and kernel B5's plain version against the JAX package.

Tolerance: none — everything here is integers.  The port's encoder (native
and numpy) must produce the JAX package's entry stream and row_ptr byte
for byte, and ``decode_codes_plain`` must give exactly the codes that the
JAX package's XLA decode ``decode_codes`` and its Pallas kernel
``decode_codes_pallas`` (interpret mode) give, on fuzzed streams with
escape entries, empty and trailing empty rows, padded entries and a
zero-length stream (against the Pallas decode only: the XLA twin cannot
index an empty stream).  The CUDA kernel is held to the plain version on the
card (the ``cuda``-marked case):
``python -m pytest --noconftest -m cuda tests/test_torch_sparse_codes.py``.
"""

import numpy as np
import pytest
import torch

from saigegds_tpu_torch.ops import sparse_codes as tsc

ESC = tsc.ESC_STEP


def _jax():
    import jax.numpy as jnp
    from saigegds_tpu.ops import sparse_codes as jsc
    from saigegds_tpu.ops.pallas_sparse import decode_codes_pallas
    return jnp, jsc, decode_codes_pallas


def _fuzz(seed: int, B: int, N: int, frac: float) -> np.ndarray:
    """int8 codes [B, N]: sparse nonzeros of all three codes, an empty
    first row, an all-missing row, long zero runs (escapes) and trailing
    empty rows."""
    rng = np.random.default_rng(seed)
    codes = np.zeros((B, N), np.int8)
    nz = rng.random((B, N)) < frac
    codes[nz] = rng.choice(np.int8([1, 2, 3]), size=int(nz.sum()))
    codes[0] = 0
    codes[2] = 3
    if N > ESC + 2:
        codes[3] = 0
        codes[3, [0, ESC, ESC + 1, N - 1]] = [1, 2, 3, 1]
        codes[4, : N - 2] = 0                    # one escape-bridged tail
    codes[-3:] = 0                               # trailing empty rows
    return codes


CASES = [(0, 37, 503, 0.1), (1, 9, 3 * ESC + 10, 0.002),
         (2, 64, 40000, 0.01), (3, 5, 100, 0.0)]


@pytest.mark.parametrize("case", CASES)
def test_encoder_matches_jax(case):
    _, jsc, _ = _jax()
    from saigegds_tpu.io import native as jnative
    from saigegds_tpu_torch.io import native as tnative
    codes = _fuzz(*case)
    want = jsc._encode_sparse_rows_np(codes)
    for got in (tsc.encode_sparse_rows(codes),
                tsc._encode_sparse_rows_np(codes),
                jsc.encode_sparse_rows(codes)):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[0].dtype == np.uint16 and got[1].dtype == np.int32
    assert tnative.available() and jnative.available()
    if case[0] == 1:
        assert (want[0] & 3 == 0).sum() >= 2     # escape entries present


@pytest.mark.parametrize("pad", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_plain_decode_matches_jax(case, pad):
    """Plain decode == JAX XLA decode == JAX Pallas (interpret) == the
    codes; ``pad`` appends zero entries past row_ptr[-1] and empty rows."""
    jnp, jsc, decode_pallas = _jax()
    codes = _fuzz(*case)
    B, N = codes.shape
    entries, row_ptr = tsc.encode_sparse_rows(codes)
    if pad:
        entries = jsc.pad_entries(entries)
        rp = np.full(B + 6, row_ptr[-1], np.int32)
        rp[: len(row_ptr)] = row_ptr
        row_ptr = rp
        codes = np.concatenate([codes, np.zeros((5, N), np.int8)])
    n_rows = len(row_ptr) - 1
    got = tsc.decode_codes(torch.from_numpy(entries),
                           torch.from_numpy(row_ptr), n_rows, N)
    assert got.dtype == torch.int8 and tuple(got.shape) == (n_rows, N)
    np.testing.assert_array_equal(got.numpy(), codes)
    if len(entries):                  # the XLA twin needs one entry
        xla = jsc.decode_codes(jnp.asarray(entries), jnp.asarray(row_ptr),
                               n_rows, N)
        np.testing.assert_array_equal(got.numpy(), np.asarray(xla))
    if n_rows * N < 1 << 21:          # interpret mode replays entry by entry
        pallas = decode_pallas(jnp.asarray(entries), jnp.asarray(row_ptr),
                               n_rows, N, interpret=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))


def test_zero_length_stream():
    """No entries at all: zeros, as the Pallas decode gives (the JAX
    package's XLA twin cannot index an empty stream, and its callers never
    hand it one)."""
    jnp, _, decode_pallas = _jax()
    entries = np.zeros(0, np.uint16)
    row_ptr = np.zeros(8, np.int32)
    got = tsc.decode_codes(torch.from_numpy(entries),
                           torch.from_numpy(row_ptr), 7, 300)
    assert tuple(got.shape) == (7, 300) and not got.any()
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(decode_pallas(
            jnp.asarray(entries), jnp.asarray(row_ptr), 7, 300,
            interpret=True)))


def test_launch_count_untouched_by_plain_version():
    entries, row_ptr = tsc.encode_sparse_rows(_fuzz(0, 37, 503, 0.1))
    before = dict(tsc.LAUNCHES)
    tsc.decode_codes(torch.from_numpy(entries), torch.from_numpy(row_ptr),
                     37, 503)
    assert tsc.LAUNCHES == before


@pytest.mark.parametrize("bad", ["dtype", "row_ptr", "device"])
def test_wrapper_rejects(bad):
    entries = torch.zeros(5, dtype=torch.uint16)
    row_ptr = torch.zeros(4, dtype=torch.int32)
    n_rows = 3
    if bad == "dtype":
        entries = entries.to(torch.int32)
    elif bad == "row_ptr":
        n_rows = 4
    else:
        entries, row_ptr = entries.to("meta"), row_ptr.to("meta")
    with pytest.raises((TypeError, ValueError)):
        tsc.decode_codes(entries, row_ptr, n_rows, 10)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES + [(4, 256, 430_000, 0.01)])
def test_kernel_matches_plain_on_card(case):
    """The hand-written CUDA kernel against its plain version, on the card
    (and against the codes that were encoded)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    codes = _fuzz(*case)
    entries, row_ptr = tsc.encode_sparse_rows(codes)
    e, rp = torch.from_numpy(entries).cuda(), torch.from_numpy(row_ptr).cuda()
    before = tsc.LAUNCHES["decode_codes"]
    got = tsc.decode_codes(e, rp, *codes.shape)
    torch.cuda.synchronize()
    assert tsc.LAUNCHES["decode_codes"] == before + 1
    assert torch.equal(got, tsc.decode_codes_plain(e, rp, *codes.shape))
    np.testing.assert_array_equal(got.cpu().numpy(), codes)
