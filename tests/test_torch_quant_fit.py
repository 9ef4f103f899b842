"""The PyTorch port's quantitative-trait null-GLMM fit (``fit_null_glmm``
with ``trait_type="quantitative"`` on the CPU) against the JAX package's,
end to end from one synthetic GDS, its pieces on one shared state, and the
scan run from each package's fitted model.

The phenotype is polygenic (heritability ~0.4) with a right-skewed
(log-normal) noise, so the default inverse-normal transform has work to
do.  The JAX side fits with ``grm_impl="packed2"`` from a pandas DataFrame;
the port from a dict of numpy columns.  Tolerances (the reference contract
is 1e-4 for the model and 1e-7 for p-values):

* tau, coefficients and variance ratios within 1e-6 relative, with the
  same outer-iteration count and the same variance-ratio markers;
* ``_get_trace(quant=True)`` and ``_fit_tau_quant`` on one state within
  1e-10 relative, with the same probe escalation;
* PCG with the Gaussian weights (w = 1) and tau_E != 1: the same
  iteration count per column, solutions within 1e-10 of each column's
  largest magnitude -- 1e-7 at tau = (0.05, 3.0), where Sigma's condition
  number is ~280 and 95 iterations amplify the two packages' differently
  ordered sums to ~1e-8 (each solution is ~1e-6 from the exact solve, the
  PCG tolerance's own error, at every tau);
* the scan's p-values within 1e-7 relative.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from _torch_synth import one_torch_thread  # noqa: F401 (autouse)
from _torch_synth import synth_quant_pheno
import saigegds_tpu
import saigegds_tpu_torch as sgt
from saigegds_tpu.io.gds_write import write_seqarray_gds
from saigegds_tpu.models import fitnull as jfit
from saigegds_tpu.models.glm import glm_gaussian, obj_nok_quant
from saigegds_tpu_torch.models import fitnull as tfit
from saigegds_tpu_torch.ops.packed_grm import Packed2GRM
from saigegds_tpu_torch.ops.pcg import pcg_solve

RTOL_FIT = 1e-6
RTOL_STATE = 1e-10
RTOL_P = 1e-7
N_SAMPLES, N_VARIANTS = 800, 600
FORMULA = "y ~ x1 + x2 + x3"


def _rel(a, b) -> float:
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.max(np.abs(a - b) / np.abs(b)))


def _quant_config(pkg, **kw):
    return pkg.NullModelConfig(trait_type="quantitative", **kw)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A GDS with a polygenic quantitative phenotype (heritability ~0.4,
    log-normal noise) and 0.5% missing genotypes."""
    rng = np.random.default_rng(15)
    af = rng.uniform(0.05, 0.5, size=(N_VARIANTS, 1))
    codes = rng.binomial(2, af, size=(N_VARIANTS, N_SAMPLES)).astype(np.int8)
    beta = rng.normal(size=N_VARIANTS) * np.sqrt(0.4 / N_VARIANTS) \
        / np.sqrt(2 * af[:, 0] * (1 - af[:, 0]))
    X, y = synth_quant_pheno(rng, N_SAMPLES, g=codes.T @ beta)
    codes[rng.random(codes.shape) < 0.005] = 3
    gds = str(tmp_path_factory.mktemp("torch_quant_fit") / "fit.gds")
    write_seqarray_gds(gds, codes)
    cols = {"sample.id": np.arange(1, N_SAMPLES + 1), "y": y,
            "x1": X[:, 1], "x2": X[:, 2], "x3": X[:, 3]}
    return gds, cols, codes


@pytest.fixture(scope="module", params=[True, False], ids=["inv_norm",
                                                           "raw"])
def fits(request, data):
    gds, cols, _ = data
    inv = request.param
    jm = jfit.fit_null_glmm(FORMULA, pd.DataFrame(cols), gds,
                            _quant_config(saigegds_tpu, grm_impl="packed2",
                                          inv_norm=inv))
    inst = {}
    tm = sgt.fit_null_glmm(FORMULA, cols, gds,
                           _quant_config(sgt, inv_norm=inv),
                           instrument=inst, device="cpu")
    return jm, tm, inst, inv


def test_fit_matches_jax(fits):
    jm, tm, inst, inv = fits
    assert tm.trait_type == jm.trait_type == "quantitative"
    assert tm.converged and jm.converged
    assert tm.tau[0] > 0 and tm.tau[1] > 0
    assert _rel(tm.tau, jm.tau) < RTOL_FIT
    assert _rel(tm.coefficients, jm.coefficients) < RTOL_FIT
    assert tm.coef_names == list(jm.coef_names)
    np.testing.assert_array_equal(tm.var_ratio["id"], jm.var_ratio["id"])
    assert _rel(tm.var_ratio["ratio"], jm.var_ratio["ratio"]) < RTOL_FIT
    n_iter = sum(e["event"] == "iteration" for e in jm.fit_log)
    assert inst["outer_iterations"] == n_iter
    # the transformed response is the model's y; the raw one is the data's
    np.testing.assert_allclose(tm.y, jm.y, rtol=1e-12)
    np.testing.assert_allclose(tm.fitted_values, jm.fitted_values,
                               rtol=RTOL_FIT)
    assert inst["matvecs"] > inst["pcg_iterations"] > 0
    for k in ("ingest_s", "aireml_s", "var_ratio_s"):
        assert inst[k] >= 0


def test_inv_norm_transforms_the_response(data, fits):
    """With ``inv_norm`` the model's y is the rank-normalised covariate
    residual (symmetric, so its skew is ~0); without, the raw phenotype."""
    _, cols, _ = data
    _, tm, _, inv = fits
    skew = lambda v: float(np.mean((v - v.mean()) ** 3) / v.std() ** 3)
    if inv:
        assert abs(skew(tm.y)) < 0.05 < skew(cols["y"])
    else:
        np.testing.assert_array_equal(tm.y, cols["y"])


def test_scan_from_fitted_models_matches(data, fits):
    gds = data[0]
    jm, tm, _, _ = fits
    want = saigegds_tpu.assoc_spa(
        gds, jm, saigegds_tpu.ScanConfig(packed_sparse=False, block_size=128))
    inst = {}
    got = sgt.assoc_spa(gds, tm, sgt.ScanConfig(block_size=128),
                        instrument=inst, device="cpu")
    assert list(got)[6:] == list(want.columns)[6:] == [
        "AF.alt", "mac", "num", "beta", "SE", "pval"]
    np.testing.assert_array_equal(got["id"], want["id"].to_numpy())
    assert len(got["id"]) > 500 and inst["spa_n"] == 0
    for c in ("pval", "beta", "SE"):
        np.testing.assert_allclose(got[c], want[c].to_numpy(), rtol=RTOL_P,
                                   err_msg=c)


def test_streamed_fit_equals_in_memory(data, fits):
    """The streamed ingest builds the same operator and harvests the same
    marker rows: the same quantitative model."""
    gds, cols, _ = data
    _, tm, inst, inv = fits
    inst2 = {}
    got = sgt.fit_null_glmm(FORMULA, cols, gds,
                            _quant_config(sgt, inv_norm=inv,
                                          stream_geno=True),
                            instrument=inst2, device="cpu")
    assert _rel(got.tau, tm.tau) < 1e-12
    assert _rel(got.var_ratio["ratio"], tm.var_ratio["ratio"]) < 1e-12
    assert inst2["matvecs"] == inst["matvecs"]
    assert inst2["outer_iterations"] == inst["outer_iterations"]


@pytest.fixture(scope="module")
def state(data):
    """One fit state in both packages: the JAX 2-bit operator carried over
    by ``Packed2GRM.from_arrays``, and the inner IRLS state of a
    quantitative start (tau = var(y)/2 each) from the JAX package."""
    from saigegds_tpu.ops.packed_grm import build_packed2_grm
    _, cols, codes = data
    jg = build_packed2_grm(codes)
    full = np.concatenate([np.concatenate([np.asarray(t) for t in lf], axis=1)
                           for lf in jg.packed], axis=0)
    tg = Packed2GRM.from_arrays(full, jg.af, jg.inv, jg.diag, jg.miss_var,
                                jg.miss_samp, jg.miss_pad,
                                n_samples=N_SAMPLES, device="cpu")
    X = np.column_stack([np.ones(N_SAMPLES), cols["x1"], cols["x2"],
                         cols["x3"]])
    fit0 = glm_gaussian(X, cols["y"])
    nok = obj_nok_quant(X, fit0)
    tau = np.var(cols["y"], ddof=1) * np.array([0.5, 0.5])
    st = jfit._get_coeff(jg, cols["y"], nok.X1, tau, jfit._Gaussian(),
                         fit0.coefficients, fit0.linear_predictors,
                         np.zeros(N_SAMPLES), 500, 20, 1e-5)
    return jg, tg, st, tau


def _probe_widths(monkeypatch, module):
    """Record the column count of every PCG solve through ``module._pcg``."""
    widths = []
    orig = module._pcg

    def rec(grm, w, tau, B, *a):
        widths.append(B.shape[1])
        return orig(grm, w, tau, B, *a)
    monkeypatch.setattr(module, "_pcg", rec)
    return widths


@pytest.mark.parametrize("cutoff", [0.0025, 0.001, 0.0007])
def test_trace_matches_jax(state, monkeypatch, cutoff):
    """Both traces, with the same +10 probe escalation on the R-RNG
    stream (none at the default cutoff, one and three rounds below it)."""
    jg, tg, st, tau = state
    jw = _probe_widths(monkeypatch, jfit)
    tw = _probe_widths(monkeypatch, tfit)
    want = jfit._get_trace(jg, st, tau, saigegds_tpu.NullModelConfig(
        trace_cv_cutoff=cutoff), quant=True)
    got = tfit._get_trace(tfit._FitGRM(tg), tfit._CoeffState(**vars(st)),
                          tau, sgt.NullModelConfig(trace_cv_cutoff=cutoff),
                          quant=True)
    assert tw == jw and tw[0] == 30 and set(tw[1:]) <= {10}
    assert len(tw) == {0.0025: 1, 0.001: 2, 0.0007: 4}[cutoff]
    assert len(got) == 2 and _rel(got, want) < RTOL_STATE
    assert min(got) > 0


def test_fit_tau_quant_matches_jax(state):
    jg, tg, st, tau = state
    cfg = saigegds_tpu.NullModelConfig()
    want = jfit._fit_tau_quant(jg, st, tau, cfg)
    got = tfit._fit_tau_quant(tfit._FitGRM(tg), tfit._CoeffState(**vars(st)),
                              tau, sgt.NullModelConfig())
    assert _rel(got, want) < RTOL_STATE and (got > 0).all()
    (ya, yb), (t0, t1), ai = tfit._get_ai_score_quant(
        tfit._FitGRM(tg), tfit._CoeffState(**vars(st)), tau,
        sgt.NullModelConfig())
    (ja, jb), (j0, j1), jai = jfit._get_ai_score_quant(jg, st, tau, cfg)
    assert _rel([ya, yb, t0, t1], [ja, jb, j0, j1]) < RTOL_STATE
    assert _rel(ai, jai) < RTOL_STATE and ai[0, 1] == ai[1, 0]


def test_fit_tau_quant_step_halving(state, monkeypatch):
    """A Newton step that drives a tau below zero is halved until both are
    non-negative, and a tau that started below ``tol`` stays at 0 (the
    ``zero_v`` mask), as in the JAX package."""
    jg, tg, st, _ = state
    # score (-51, -30): the Newton step lowers both taus by ~10
    fake = ((-27.0, -50.0), (1.0, 3.0), np.array([[4.0, 1.0], [1.0, 2.0]]))
    for mod in (jfit, tfit):
        monkeypatch.setattr(mod, "_get_ai_score_quant",
                            lambda *a, **k: fake)
    for tau0 in (np.array([0.3, 0.4]), np.array([0.3, 0.01])):
        want = jfit._fit_tau_quant(jg, st, tau0,
                                   saigegds_tpu.NullModelConfig())
        got = tfit._fit_tau_quant(tfit._FitGRM(tg),
                                  tfit._CoeffState(**vars(st)), tau0,
                                  sgt.NullModelConfig())
        np.testing.assert_array_equal(got, want)
        assert got[0] > 0 and (got[1] > 0) == (tau0[1] > 0.02)


@pytest.mark.parametrize("tau,rtol", [
    ((0.24, 0.42), RTOL_STATE), ((2.5, 0.1), RTOL_STATE),
    ((0.05, 3.0), 1e-7), ((1e-5, 1e-6), RTOL_STATE)],
    ids=["fitted", "tau_E_large", "tau_G_large", "jacobi_floor"])
def test_pcg_gaussian_weights_match_jax(state, tau, rtol):
    """The Gaussian model's solves (w = 1, tau_E != 1): the same iteration
    count per column; at (1e-5, 1e-6) every diagonal entry sits under the
    1e-4 Jacobi floor."""
    import jax.numpy as jnp
    from saigegds_tpu.ops.pcg import pcg_solve_op
    jg, tg, _, _ = state
    rng = np.random.default_rng(3)
    B = rng.normal(size=(N_SAMPLES, 4)) * np.array([1.0, 20.0, 1e-3, 0.3])
    w = np.ones(N_SAMPLES)
    jx, jit, jconv = pcg_solve_op(jg, jnp.asarray(w), jnp.asarray(tau),
                                  jnp.asarray(B), 1e-5, 500)
    tx, tit, tconv = pcg_solve(tg, torch.from_numpy(w), tau,
                               torch.from_numpy(B), 1e-5, 500)
    np.testing.assert_array_equal(tit.numpy(), np.asarray(jit))
    np.testing.assert_array_equal(tconv.numpy(), np.asarray(jconv))
    assert tconv.all() and len(set(tit.tolist())) > 1
    jx = np.asarray(jx)
    scale = np.abs(jx).max(axis=0)
    np.testing.assert_array_less(np.abs(tx.numpy() - jx).max(axis=0),
                                 rtol * scale)


def test_tau_init_and_invalid_trait(data):
    """``tau_init`` splits var(y) in its ratio in both packages, and an
    unknown trait type raises ValueError."""
    gds, cols, _ = data
    kw = dict(tau_init=(1.0, 3.0), inv_norm=False, num_marker=5)
    jm = jfit.fit_null_glmm(FORMULA, pd.DataFrame(cols), gds,
                            _quant_config(saigegds_tpu, grm_impl="packed2",
                                          **kw))
    tm = sgt.fit_null_glmm(FORMULA, cols, gds, _quant_config(sgt, **kw),
                           device="cpu")
    assert _rel(tm.tau, jm.tau) < RTOL_FIT
    with pytest.raises(ValueError):
        sgt.fit_null_glmm(FORMULA, cols, gds,
                          sgt.NullModelConfig(trait_type="survival"),
                          device="cpu")
