"""The slice decomposition of the GRM product's f64 operands: the slice
kernels of ``csrc/plane_dot.cu`` (``ops/grm_kernel.slice_i8``: the column
max, then the slices) against the plain chain
``ops/packed_grm._slice_i8_plain``.

Tolerance: none -- bit-equal.  Apart from one IEEE division per element
every step of the decomposition is exact in f64, and both round half to
even, so the kernels' slices and scales, the plain chain's on the card and
the plain chain's on the CPU are the same bytes.  The CPU cases run the
kernels' arithmetic (``slice_word``: the rounding by adding 1.5 * 2^52 and
the low byte of the sum) statement by statement in numpy; the card cases
run the kernels.  Non-finite inputs: only the scales are specified (a
product's inputs are finite), so there the bytes are compared in the
columns that hold finite values alone.

The card cases: ``python -m pytest --noconftest -m cuda
tests/test_torch_slice_kernel.py``.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from _torch_synth import one_torch_thread  # noqa: F401 (autouse)
from saigegds_tpu_torch.ops import grm_kernel, packed_grm
from saigegds_tpu_torch.ops.packed_grm import N_SLICES, _slice_i8, \
    _slice_i8_plain, build_packed2_grm
from saigegds_tpu_torch.utils import profiling

ROUND_EVEN = 6755399441055744.0         # 1.5 * 2^52, as in the kernel
ROWS = 100_003                          # off every block's rows

CASES = ["R1", "R31", "R38", "R248", "n1", "column_view", "transposed",
         "transposed_wide", "zero_column", "signed_zeros", "halves",
         "tiny_huge", "nonfinite"]


def _halves(rng, n: int, R: int) -> np.ndarray:
    """Columns of scale 1 whose elements land on a half at one slice: the
    digits before it drawn, then d + 1/2 at slice k (exact in f64)."""
    digits = rng.integers(-63, 64, size=(n, R, 8)).astype(np.float64)
    k = rng.integers(0, 7, size=(n, R))
    x = np.zeros((n, R))
    for s in range(8):
        w = 1.0 / (64.0 * 128.0 ** s)
        x += np.where(s < k, digits[:, :, s], 0.0) * w
        x += np.where(s == k, digits[:, :, s] + 0.5, 0.0) * w
    x[0] = 1.0                          # the scale: every column's max
    return x


def _input(case: str, rows: int) -> torch.Tensor:
    """f64 [n, R] on the CPU, strided as the case says."""
    rng = np.random.default_rng(sum(map(ord, case)))
    norm = lambda n, R: rng.normal(size=(n, R)) * \
        10.0 ** rng.uniform(-5, 5, (1, R))
    if case.startswith("R"):
        return torch.from_numpy(norm(rows, int(case[1:])))
    if case == "n1":
        return torch.from_numpy(norm(1, 31))
    if case == "column_view":           # U[:, :nrun]
        return torch.from_numpy(norm(rows, 53))[:, :38]
    if case in ("transposed", "transposed_wide"):   # PY.T
        return torch.from_numpy(norm(8 if case == "transposed" else 40,
                                     rows).copy()).T
    x = norm(rows, 31)
    if case == "zero_column":
        x[:, 3] = 0.0
        x[:, 4] = -0.0
    elif case == "signed_zeros":
        x[rng.random(x.shape) < 0.3] = 0.0
        x[rng.random(x.shape) < 0.3] = -0.0
    elif case == "halves":
        x = _halves(rng, rows, 31)
    elif case == "tiny_huge":
        x[:, :10] *= 1e-300 / np.abs(x[:, :10]).max(axis=0)
        x[:, 10:20] *= 1e300 / np.abs(x[:, 10:20]).max(axis=0)
        x[::7, 20] = 5e-324             # beside 1e300: slices of zero
        x[1::7, 20] = 1e-10             # a subnormal rem
        x[0, 20] = 1e300
        x[::3, 21] = 5e-324             # the least subnormal as the scale
        x[:, 21] *= 0.0
        x[0, 21] = 5e-324
    elif case == "nonfinite":
        x[5, 0] = np.nan
        x[6, 1] = np.inf
        x[7, 2] = -np.inf
        x[8, 3], x[9, 3] = np.nan, np.inf
    return torch.from_numpy(x)


def _finite_columns(x: torch.Tensor) -> torch.Tensor:
    return torch.isfinite(x).all(dim=0)


def _emulated(x: torch.Tensor):
    """The kernels' arithmetic in numpy (f64, no contraction): the column
    max of |x| as bit patterns, then ``slice_word`` per element."""
    a = np.ascontiguousarray(x.numpy())
    bits = (a.view(np.uint64) & np.uint64(0x7FFFFFFFFFFFFFFF)).max(
        axis=0, initial=np.uint64(0))
    amax = bits.view(np.float64)
    with np.errstate(invalid="ignore"):
        scale = np.where(amax > 0.0, amax, 1.0)
        rem = a / scale
        out = np.empty(a.shape + (8,), np.int8)
        for k in range(8):
            t = rem * 64.0 + ROUND_EVEN
            d = t - ROUND_EVEN
            out[..., k] = (t.view(np.int64) & 0xFF).astype(np.uint8).view(
                np.int8)
            rem = (rem - d * (1.0 / 64.0)) * 128.0
    return torch.from_numpy(out), torch.from_numpy(scale)


def _assert_same(got, want, x):
    """Scales equal; slices equal in the columns of finite values."""
    (d, scale), (dw, sw) = got, want
    assert d.dtype == torch.int8 and d.shape == dw.shape
    assert torch.equal(scale.cpu(), sw.cpu())
    keep = _finite_columns(x.cpu())
    assert torch.equal(d.cpu()[:, keep], dw.cpu()[:, keep])


@pytest.mark.parametrize("case", CASES)
def test_kernel_arithmetic_matches_plain(case):
    """The kernels' statements, run in numpy on the CPU, give the plain
    chain's bytes: the rounding to an integer through 1.5 * 2^52 is round
    half to even, its low byte is the slice, and the bit-pattern max is
    torch.amax, NaN included."""
    x = _input(case, 4099)
    _assert_same(_emulated(x), _slice_i8_plain(x, N_SLICES), x)


def test_cpu_tensor_takes_the_plain_chain():
    """A CPU tensor is sliced by the plain chain: no kernel launch, and the
    counter ``grm.slice_kernel`` stays unset in a traced product."""
    x = _input("R31", 997)
    before = grm_kernel.LAUNCHES["slice_i8"]
    got = _slice_i8(x, N_SLICES)
    want = _slice_i8_plain(x, N_SLICES)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    rng = np.random.default_rng(5)
    codes = rng.binomial(2, 0.3, (64, 997)).astype(np.int8)
    g = build_packed2_grm(codes, device="cpu")
    b = torch.from_numpy(rng.normal(size=(997, 3)))
    g.matvec(b)                                 # found the profiler off
    with profile(activities=[ProfilerActivity.CPU]):
        g.matvec(b)
    assert sum(s.name == "grm.product" for s in profiling.spans()) == 1
    assert "grm.slice_kernel" not in profiling.counts()
    assert grm_kernel.LAUNCHES["slice_i8"] == before


def test_kernel_wrapper_rejects():
    """The wrapper takes a CUDA f64 matrix and 8 slices, else raises before
    any launch."""
    before = grm_kernel.LAUNCHES["slice_i8"]
    with pytest.raises(ValueError, match="CUDA"):
        grm_kernel.slice_i8(torch.zeros(4, 2, dtype=torch.float64))
    assert grm_kernel.LAUNCHES["slice_i8"] == before


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES + ["main_shape"])
def test_slice_kernel_matches_plain_on_card(case):
    """Kernel against the plain chain on the card and on the CPU: R = 1,
    31, 38, 248 and the fit's average 103 at n = 430,000; n off every
    block's rows, and 1; a column view and transposed inputs (lanes along
    the rows); zero and negative-zero columns (scale 1); ties at every
    slice; magnitudes near 1e-300 and 1e300 with subnormals; non-finite
    values (scales only)."""
    _need_card()
    if case == "main_shape":
        x = torch.from_numpy(np.random.default_rng(103).normal(
            size=(430_000, 103))).cuda()
    else:
        x = _input(case, ROWS).cuda()
    before = grm_kernel.LAUNCHES["slice_i8"]
    got = _slice_i8(x, N_SLICES)
    torch.cuda.synchronize()
    assert grm_kernel.LAUNCHES["slice_i8"] == before + 1
    assert got[0].device == x.device and got[1].device == x.device
    _assert_same(got, _slice_i8_plain(x, N_SLICES), x)
    if case != "main_shape":
        _assert_same(got, _slice_i8_plain(x.cpu(), N_SLICES), x)


@pytest.mark.cuda
def test_slice_kernel_rejects_on_card():
    """Another slice count or dtype on a CUDA tensor raises before any
    launch."""
    _need_card()
    before = grm_kernel.LAUNCHES["slice_i8"]
    x = torch.zeros(4, 2, dtype=torch.float64, device="cuda")
    with pytest.raises(ValueError, match="slices"):
        _slice_i8(x, 4)
    with pytest.raises(TypeError):
        grm_kernel.slice_i8(x.float())
    assert grm_kernel.LAUNCHES["slice_i8"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("R", [5, 248])
def test_product_with_the_slice_kernel_on_card(R, monkeypatch):
    """One product on the card with the slice kernels equals the same
    product with the plain chain's slices bit for bit, and a traced
    product counts the kernels twice (``grm.slice_kernel``)."""
    _need_card()
    rng = np.random.default_rng(R)
    codes = rng.binomial(2, rng.uniform(0.02, 0.5, (97, 1)),
                         size=(97, 1031)).astype(np.int8)
    codes[rng.random(codes.shape) < 0.05] = 3
    g = build_packed2_grm(codes, device="cuda")
    b = torch.from_numpy(rng.normal(size=(1031, R))
                         * 10.0 ** rng.uniform(-5, 5, (1, R))).cuda()
    with monkeypatch.context() as m:
        m.setattr(packed_grm, "_slice_i8", _slice_i8_plain)
        want = g.matvec(b)                  # found the profiler off
    before = grm_kernel.LAUNCHES["slice_i8"]
    with profile(activities=[ProfilerActivity.CPU]):
        got = [g.matvec(b) for _ in range(2)]
    torch.cuda.synchronize()
    assert grm_kernel.LAUNCHES["slice_i8"] == before + 4
    assert sum(s.name == "grm.product" for s in profiling.spans()) == 2
    assert profiling.counts()["grm.slice_kernel"] == 4
    assert all(torch.equal(p, want) for p in got)
