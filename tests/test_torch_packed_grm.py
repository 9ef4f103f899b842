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

from saigegds_tpu_torch.ops import grm_kernel
from saigegds_tpu_torch.ops.grm import build_grm
from saigegds_tpu_torch.ops.packed_grm import Packed2GRM, build_packed2_grm, \
    build_packed2_grm_streamed

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
