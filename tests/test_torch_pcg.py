"""The PyTorch port's batched Jacobi PCG (``ops/pcg.pcg_solve``) against
the JAX package's ``pcg_solve_op`` on the same operator.

The JAX 2-bit operator is carried across with ``Packed2GRM.from_arrays``
(and the dense one rebuilt from the same codes).  Tolerances: the
per-column iteration counts and convergence flags are equal (the port
keeps ``_pcg_body``'s arithmetic, per-column freezing included); the
solutions agree within 1e-10 of each column's largest magnitude (the GRM
products agree to ~1e-15, and each iteration reassociates a few sums).
"""

import numpy as np
import pytest
import torch

from _torch_synth import one_torch_thread  # noqa: F401 (autouse)
from saigegds_tpu_torch.ops.grm import build_grm
from saigegds_tpu_torch.ops.packed_grm import Packed2GRM
from saigegds_tpu_torch.ops.pcg import pcg_solve

RTOL = 1e-10
M_VARIANTS, N_SAMPLES = 120, 901
TOL = 1e-5


@pytest.fixture(scope="module")
def problem():
    from saigegds_tpu.ops.packed_grm import build_packed2_grm
    rng = np.random.default_rng(21)
    codes = rng.binomial(2, rng.uniform(0.05, 0.5, (M_VARIANTS, 1)),
                         size=(M_VARIANTS, N_SAMPLES)).astype(np.int8)
    codes[rng.random(codes.shape) < 0.01] = 3
    jg = build_packed2_grm(codes)
    full = np.concatenate([np.concatenate([np.asarray(t) for t in lf], axis=1)
                           for lf in jg.packed], axis=0)
    tg = Packed2GRM.from_arrays(full, jg.af, jg.inv, jg.diag, jg.miss_var,
                                jg.miss_samp, jg.miss_pad,
                                n_samples=N_SAMPLES, device="cpu")
    mu = rng.uniform(0.05, 0.5, N_SAMPLES)
    w = mu * (1 - mu)
    # columns of different scales converge after different iterations
    B = rng.normal(size=(N_SAMPLES, 5)) * np.array([1.0, 30.0, 1e-3, 3.0,
                                                    1e-2])
    return codes, jg, tg, w, B


def _solve_both(jop, top, w, tau, B, maxiter):
    import jax.numpy as jnp
    from saigegds_tpu.ops.pcg import pcg_solve_op
    jx, jit, jconv = pcg_solve_op(jop, jnp.asarray(w), jnp.asarray(tau),
                                  jnp.asarray(B), TOL, maxiter)
    before = top.matvecs
    tx, tit, tconv = pcg_solve(top, torch.from_numpy(w), tau,
                               torch.from_numpy(B), TOL, maxiter)
    # one GRM product per iteration, none after the last column froze
    assert top.matvecs - before == int(tit.max())
    return (np.asarray(jx), np.asarray(jit), np.asarray(jconv),
            tx.numpy(), tit.numpy(), tconv.numpy())


def _check(jx, jit, jconv, tx, tit, tconv):
    np.testing.assert_array_equal(tit, jit)
    np.testing.assert_array_equal(tconv, jconv)
    scale = np.abs(jx).max(axis=0)
    np.testing.assert_array_less(np.abs(tx - jx).max(axis=0), RTOL * scale)


@pytest.mark.parametrize("tau", [(1.0, 0.5), (1.0, 0.0), (0.3, 2.0)])
def test_pcg_matches_jax_packed(problem, tau):
    _, jg, tg, w, B = problem
    res = _solve_both(jg, tg, w, np.array(tau), B, 500)
    assert res[2].all()
    if tau[1] > 0:            # columns froze after different iterations
        assert len(set(res[1].tolist())) > 1
    _check(*res)


def test_pcg_matches_jax_at_maxiter(problem):
    """A bound below convergence: the large columns stop at maxiter
    unconverged, and the iterates still agree."""
    _, jg, tg, w, B = problem
    res = _solve_both(jg, tg, w, np.array([1.0, 0.5]), B, 3)
    assert not res[2][:2].any() and (res[1][:2] == 3).all()
    _check(*res)


def test_pcg_1d_rhs(problem):
    """A 1-D right-hand side (the port squeezes; the JAX solver takes the
    same column as [N, 1])."""
    import jax.numpy as jnp
    from saigegds_tpu.ops.pcg import pcg_solve_op
    _, jg, tg, w, B = problem
    tau = np.array([1.0, 0.5])
    jx, jit, jconv = pcg_solve_op(jg, jnp.asarray(w), jnp.asarray(tau),
                                  jnp.asarray(B[:, 1:2]), TOL, 500)
    tx, tit, tconv = pcg_solve(tg, torch.from_numpy(w), tau,
                               torch.from_numpy(B[:, 1]), TOL, 500)
    assert tx.shape == (N_SAMPLES,) and tit.shape == ()
    _check(np.asarray(jx), np.asarray(jit), np.asarray(jconv),
           tx.numpy()[:, None], tit.numpy()[None], tconv.numpy()[None])


def test_pcg_matches_jax_dense(problem):
    from saigegds_tpu.ops.grm import build_grm as jbuild_dense
    codes, _, _, w, B = problem
    res = _solve_both(jbuild_dense(codes), build_grm(codes, device="cpu"),
                      w, np.array([1.0, 0.5]), B, 500)
    _check(*res)


def test_pcg_per_column_weights_and_tau(problem):
    """Per-column weights w [N, R] and tau [2, R] (the systems of several
    models in one solve, as the batched fits and GxG pass them) against
    the JAX solver's per-column form; each column also equals its own
    one-column solve, with the same iterations."""
    import jax.numpy as jnp
    from saigegds_tpu.ops.pcg import pcg_solve_op
    _, jg, tg, w, B = problem
    rng = np.random.default_rng(22)
    R = B.shape[1]
    mus = rng.uniform(0.05, 0.5, (len(w), R))
    W = mus * (1 - mus)
    tau = np.array([[1.0, 1.0, 0.3, 1.0, 0.7], [0.5, 0.0, 2.0, 0.1, 1.5]])
    jx, jit, jconv = pcg_solve_op(jg, jnp.asarray(W), jnp.asarray(tau),
                                  jnp.asarray(B), TOL, 500)
    tx, tit, tconv = pcg_solve(tg, torch.from_numpy(W),
                               torch.from_numpy(tau), torch.from_numpy(B),
                               TOL, 500)
    assert len(set(tit.tolist())) > 1
    _check(np.asarray(jx), np.asarray(jit), np.asarray(jconv), tx.numpy(),
           tit.numpy(), tconv.numpy())
    for r in range(R):
        x1, it1, _ = pcg_solve(tg, torch.from_numpy(W[:, r]), tau[:, r],
                               torch.from_numpy(B[:, r]), TOL, 500)
        assert int(it1) == int(tit[r])
        np.testing.assert_allclose(tx[:, r].numpy(), x1.numpy(), rtol=0,
                                   atol=RTOL * float(x1.abs().max()))
