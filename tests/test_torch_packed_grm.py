"""The PyTorch port's 2-bit GRM operator (``ops/packed_grm.Packed2GRM``)
and its dense oracle (``ops/grm.GRMOperator``) against the JAX package's.

The JAX operator is carried across with ``Packed2GRM.from_arrays`` (its
leaves and tiles concatenated back to one [M, N4] store).  Tolerances:

* the host-side state (store, af, inv, diag, missing pairs) -- exact: the
  same numpy/native code builds it;
* the matvec -- 1e-13 of each column's largest magnitude, as in
  ``tests/test_packed_grm.py``: the integer partials are exact, only the
  f64 slice recombination and the corrections may reassociate;
* the streamed build -- the in-memory build exactly (store, moments,
  missing pairs and products), diag within 1e-15 (its per-block partial
  sums reassociate);
* the dense oracle -- 1e-12 of each column's largest magnitude against the
  2-bit operator (two different f64 formulations of one GRM).
"""

import numpy as np
import pytest
import torch

from _torch_synth import one_torch_thread  # noqa: F401 (autouse)
from saigegds_tpu_torch.ops import grm_kernel
from saigegds_tpu_torch.ops.grm import build_grm
from saigegds_tpu_torch.ops.packed_grm import Packed2GRM, build_packed2_grm, \
    build_packed2_grm_streamed, store_width, unpack_codes_2bit

RTOL = 1e-13
M_VARIANTS, N_SAMPLES = 97, 1031            # N % 4 != 0: the last plane pads


def _close(got, want, rtol):
    """Each column within ``rtol`` of its largest magnitude."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = np.abs(want).max(axis=0)
    np.testing.assert_array_less(np.abs(got - want).max(axis=0),
                                 rtol * scale + 1e-300)


def _codes(seed: int = 7):
    rng = np.random.default_rng(seed)
    codes = rng.binomial(2, rng.uniform(0.02, 0.5, (M_VARIANTS, 1)),
                         size=(M_VARIANTS, N_SAMPLES)).astype(np.int8)
    codes[rng.random(codes.shape) < 0.05] = 3
    codes[0] = 0                       # monomorphic: inv = 0
    codes[1] = 3                       # all missing
    return codes


def _carry(jg):
    """The JAX operator's state as the port's operator on the CPU."""
    full = np.concatenate([np.concatenate([np.asarray(t) for t in lf], axis=1)
                           for lf in jg.packed], axis=0)
    return Packed2GRM.from_arrays(full, jg.af, jg.inv, jg.diag, jg.miss_var,
                                  jg.miss_samp, jg.miss_pad,
                                  n_samples=jg.n_samples, device="cpu")


@pytest.fixture(scope="module")
def grms():
    import jax.numpy as jnp
    from saigegds_tpu.ops.packed_grm import build_packed2_grm as jbuild
    codes = _codes()
    jg = jbuild(codes)
    return codes, jg, _carry(jg), jnp


def test_build_matches_jax_state(grms):
    codes, jg, tg, _ = grms
    own = build_packed2_grm(codes, device="cpu")
    for g in (tg, own):
        assert g.packed.dtype == torch.uint8 and g.packed.is_contiguous()
        assert (g.n_variants, g.n_samples) == (M_VARIANTS, N_SAMPLES)
    assert torch.equal(own.packed, tg.packed)
    for f in ("af", "inv", "diag", "miss_var", "miss_samp"):
        assert torch.equal(getattr(own, f), getattr(tg, f)), f
    nnz = int(np.asarray(jg.miss_pad).sum())
    assert own.miss_var.numel() == nnz == int((codes == 3).sum())


@pytest.mark.parametrize("rhs", ["1d", "scaled", "wide"])
def test_matvec_matches_jax(grms, rhs):
    """1-D and [N, R] right-hand sides, columns of scale 1, 1e5, 1e-5."""
    _, jg, tg, jnp = grms
    rng = np.random.default_rng(11)
    if rhs == "1d":
        b = rng.normal(size=N_SAMPLES)
    elif rhs == "scaled":
        b = rng.normal(size=(N_SAMPLES, 3)) * np.array([1.0, 1e5, 1e-5])
    else:
        b = rng.choice([-1.0, 1.0], size=(N_SAMPLES, 31))
    want = np.asarray(jg.matvec(jnp.asarray(b)))
    before = tg.matvecs
    got = tg.matvec(torch.from_numpy(b))
    assert tg.matvecs == before + 1
    assert got.dtype == torch.float64 and got.shape == want.shape
    got = got.numpy()
    if b.ndim == 1:
        got, want = got[:, None], want[:, None]
    _close(got, want, RTOL)


def test_matvec_goes_through_the_kernel_wrappers(grms, monkeypatch):
    """One B1 and one B2 call per product (their plain versions here)."""
    _, _, tg, _ = grms
    seen = []
    for name in ("plane_dot_fwd", "plane_dot_t"):
        fn = getattr(grm_kernel, name)
        monkeypatch.setattr(grm_kernel, name,
                            lambda *a, _f=fn, _n=name: seen.append(_n)
                            or _f(*a))
    tg.matvec(torch.ones(N_SAMPLES, 2, dtype=torch.float64))
    assert seen == ["plane_dot_fwd", "plane_dot_t"]


@pytest.mark.parametrize("n", [1, 15, 16, 17, 1031, 1040])
def test_store_rows_are_word_aligned(n):
    """Every width of the store is a multiple of 4 byte columns (kernels
    B1 and B2 load four at a time), at most 3 past ceil(N/4); the padding
    samples are code 0 and the store unpacks to the zeroed codes; the
    streamed build lays it out the same."""
    rng = np.random.default_rng(n)
    codes = rng.integers(0, 4, size=(5, n), dtype=np.int8)
    width = store_width(n)
    assert width % 4 == 0 and -(-n // 4) <= width < -(-n // 4) + 4
    g = build_packed2_grm(codes, device="cpu")
    assert tuple(g.packed.shape) == (5, width)
    full = unpack_codes_2bit(g.packed.numpy(), 4 * width)
    np.testing.assert_array_equal(full[:, :n], np.where(codes < 3, codes, 0))
    assert not full[:, n:].any()
    s = build_packed2_grm_streamed(iter([(None, codes[:2]), (None, codes[2:])]),
                                   n, 5, device="cpu")
    assert torch.equal(s.packed, g.packed)


def test_carried_store_is_packed_to_the_store_width(grms):
    """The JAX store (N4 = ceil(N/4) = 258 here) comes across at the
    port's width (260), holding the same codes."""
    _, jg, tg, _ = grms
    full = np.concatenate([np.concatenate([np.asarray(t) for t in lf], axis=1)
                           for lf in jg.packed], axis=0)
    assert full.shape[1] == -(-N_SAMPLES // 4) != store_width(N_SAMPLES)
    assert tuple(tg.packed.shape) == (M_VARIANTS, store_width(N_SAMPLES))
    np.testing.assert_array_equal(
        unpack_codes_2bit(tg.packed.numpy(), N_SAMPLES),
        unpack_codes_2bit(full, N_SAMPLES))


@pytest.mark.parametrize("block", [17, M_VARIANTS])
def test_streamed_build_equals_in_memory(block):
    codes = _codes(3)
    ref = build_packed2_grm(codes, device="cpu")
    blocks = ((np.arange(s, min(s + block, M_VARIANTS)), codes[s:s + block])
              for s in range(0, M_VARIANTS, block))
    got = build_packed2_grm_streamed(blocks, N_SAMPLES, device="cpu",
                                     n_variants=M_VARIANTS)
    for f in ("packed", "af", "inv", "miss_var", "miss_samp"):
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
    if block == M_VARIANTS:        # one block: the very same sums
        assert torch.equal(got.diag, ref.diag)
    else:   # diag sums per-block partials: reassociated, within a few ulps
        np.testing.assert_allclose(got.diag.numpy(), ref.diag.numpy(),
                                   rtol=1e-15, atol=0)
    b = torch.from_numpy(np.random.default_rng(1).normal(size=(N_SAMPLES, 2)))
    assert torch.equal(got.matvec(b), ref.matvec(b))


def test_streamed_build_checks_row_count():
    codes = _codes(4)
    with pytest.raises(ValueError):
        build_packed2_grm_streamed(iter([(None, codes)]), N_SAMPLES,
                                   device="cpu", n_variants=M_VARIANTS + 1)
    with pytest.raises(ValueError):
        build_packed2_grm_streamed(iter([(None, codes)]), N_SAMPLES,
                                   device="cpu", n_variants=M_VARIANTS - 1)


def test_dense_oracle_matches_jax_and_packed(grms):
    import jax.numpy as jnp
    from saigegds_tpu.ops.grm import build_grm as jbuild_dense
    codes, _, tg, _ = grms
    dense = build_grm(codes, device="cpu")
    jd = jbuild_dense(codes)
    np.testing.assert_array_equal(dense.diag.numpy(), np.asarray(jd.diag))
    np.testing.assert_allclose(dense.diag.numpy(), tg.diag.numpy(),
                               rtol=1e-13)
    b = np.random.default_rng(2).normal(size=(N_SAMPLES, 4))
    got = dense.matvec(torch.from_numpy(b)).numpy()
    _close(got, np.asarray(jd.matvec(jnp.asarray(b))), RTOL)
    _close(got, tg.matvec(torch.from_numpy(b)).numpy(), 1e-12)


def _index_add_corrections(mv, ms, B, W, M, N):
    """The missing-pair corrections as ``index_add_`` over the lists
    (the product's form before they became segment sums)."""
    c1 = torch.zeros(M, B.shape[1], dtype=torch.float64)
    c1.index_add_(0, mv, B[ms])
    c2 = torch.zeros(N, W.shape[1], dtype=torch.float64)
    c2.index_add_(0, ms, W[mv])
    return c1, c2


@pytest.mark.parametrize("R", [1, 30])
@pytest.mark.parametrize("order", ["sorted", "shuffled", "none"])
def test_missing_pair_sums_equal_index_add(order, R):
    """``MissingPairs``' segment sums (kept sorted once, added in list
    order) equal ``index_add_`` over the original lists bit for bit, in
    any list order; a list given out of order is sorted stably by
    variant."""
    from saigegds_tpu_torch.ops.packed_grm import MissingPairs
    rng = np.random.default_rng(R)
    M, N = 53, 1003
    miss = rng.random((M, N)) < (0.0 if order == "none" else 0.04)
    miss[7] = False                       # a variant without missing pairs
    mv, ms = (torch.from_numpy(a) for a in np.nonzero(miss))
    if order == "shuffled":
        perm = torch.from_numpy(rng.permutation(len(mv)))
        mv, ms = mv[perm], ms[perm]
    B = torch.from_numpy(rng.normal(size=(N, R))
                         * 10.0 ** rng.uniform(-5, 5, (N, 1)))
    W = torch.from_numpy(rng.normal(size=(M, R)))
    pairs = MissingPairs(mv, ms, M, N)
    want1, want2 = _index_add_corrections(mv, ms, B, W, M, N)
    assert torch.equal(pairs.per_variant(B), want1)
    assert torch.equal(pairs.per_sample(W), want2)
    assert len(pairs) == len(mv) and pairs.samp.dtype == torch.int32
    order_v = torch.sort(mv, stable=True).indices
    assert torch.equal(pairs.variants().long(), mv[order_v])
    assert torch.equal(pairs.samp.long(), ms[order_v])
    assert pairs.nbytes == 4 * (2 * len(mv) + M + N)


def test_product_equals_index_add_form(grms):
    """The whole product, against the same algebra with the corrections
    by ``index_add_``: bit for bit on the CPU."""
    from saigegds_tpu_torch.ops.packed_grm import N_SLICES, _pad_cols, \
        _slice_i8, _slice_weights, kernel_cols
    codes, _, _, _ = grms
    g = build_packed2_grm(codes, device="cpu")
    B = torch.from_numpy(np.random.default_rng(3).normal(size=(N_SAMPLES, 5)))
    M, N4 = g.packed.shape
    N, R = B.shape
    S, RS, C = N_SLICES, 5 * N_SLICES, kernel_cols(5)
    Bp = torch.zeros(4 * N4, R, dtype=torch.float64)
    Bp[:N] = B
    d, scale = _slice_i8(Bp, S)
    acc = grm_kernel.plane_dot_fwd(
        g.packed, _pad_cols(d.reshape(4 * N4, RS), C).view(4, N4, C))[:, :RS]
    cv = torch.sum(acc.reshape(M, R, S) * _slice_weights(scale, S), dim=-1)
    mv, ms = g.miss_var.long(), g.miss_samp.long()
    corr1 = torch.zeros(M, R, dtype=torch.float64)
    corr1.index_add_(0, mv, B[ms])
    gv = g.inv[:, None] * (cv - 2.0 * g.af[:, None]
                           * (torch.sum(B, dim=0)[None, :] - corr1))
    w1 = g.inv[:, None] * gv
    w2 = 2.0 * g.af[:, None] * g.inv[:, None] * gv
    d2, scale2 = _slice_i8(w1, S)
    acc4 = grm_kernel.plane_dot_t(g.packed, _pad_cols(d2.reshape(M, RS), C))
    pl4 = torch.sum(acc4[:, :, :RS].reshape(4, N4, R, S)
                    * _slice_weights(scale2, S)[None], dim=-1)
    corr2 = torch.zeros(N, R, dtype=torch.float64)
    corr2.index_add_(0, ms, w2[mv])
    want = (pl4.reshape(4 * N4, R)[:N]
            - (torch.sum(w2, dim=0)[None, :] - corr2)) / M
    assert torch.equal(g.matvec(B), want)


@pytest.mark.cuda
def test_product_is_deterministic_on_the_card():
    """The same product twice on the card, and over a two-shard mesh on
    the same card: bit-equal (the corrections were f64 atomics before)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from saigegds_tpu_torch.parallel.mesh import ShardedGrmHandle, make_mesh
    codes = _codes(9)
    g = build_packed2_grm(codes, device="cuda")
    b = torch.from_numpy(np.random.default_rng(2).normal(
        size=(N_SAMPLES, 30))).cuda()
    first = g.matvec(b)
    assert torch.equal(first, g.matvec(b))
    h = ShardedGrmHandle(g, make_mesh(devices=["cuda:0", "cuda:0"]))
    assert torch.equal(first, h.matvec(b))
    torch.cuda.synchronize()
