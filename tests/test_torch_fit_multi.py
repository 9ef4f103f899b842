"""The PyTorch port's PheWAS-mode fit against the JAX package's.

* The batched fitters (``models/fit_device.py``), binary and
  quantitative, P = 3 lanes at n = 400 x m = 150 (the problem of
  ``tests/test_fit_device_multi.py``), against JAX
  ``fit_glmm_*_device_multi`` on the same operator: tau, coefficients,
  mu and cov within 1e-8 relative, iterations, ``converged`` and
  ``trace_capped`` equal; each lane within 1e-10 of the port's one-lane
  run; the one-design-per-lane form (GxG's refits) against a vmapped JAX
  ``fit_glmm_binary_device``.
* ``fit_null_glmm_multi`` end to end on an N = 800 x M = 600 GDS, binary
  (P = 2) and quantitative, against JAX ``fit_null_glmm_multi``
  (``grm_impl="packed2"``): tau, coefficients, fitted values and variance
  ratios within 1e-6 relative, the same markers; each lane against the
  port's ``fit_null_glmm`` within the 2% stopping rule (see
  :func:`test_lanes_match_single_fits`); ``var_ratio_mac_cat``; the
  variance ratios lane for lane against serial passes; the validation
  errors.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from _torch_synth import one_torch_thread  # noqa: F401 (autouse)
import saigegds_tpu
import saigegds_tpu_torch as sgt
from saigegds_tpu.io.gds_write import write_seqarray_gds
from saigegds_tpu_torch.models import fit_device, fitnull
from saigegds_tpu_torch.ops.grm import build_grm
from saigegds_tpu_torch.ops.packed_grm import build_packed2_grm
from saigegds_tpu_torch.utils.rrandom import RRandom

RTOL_DEV = 1e-8
RTOL_LANE = 1e-10
RTOL_FIT = 1e-6
N_SAMPLES, N_VARIANTS = 800, 600
COVS = "x1 + x2 + x3"


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def _rel(a, b) -> float:
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


@pytest.fixture(scope="module")
def small():
    """P = 3 binary and quantitative lanes over one 2-bit GRM (n = 400,
    m = 150) and a 40-probe pool, in both packages."""
    from saigegds_tpu.models.glm import glm_binomial
    from saigegds_tpu.ops.packed_grm import build_packed2_grm as jbuild
    rng = np.random.default_rng(5)
    P, n, m = 3, 400, 150
    codes = rng.binomial(2, rng.uniform(0.1, 0.5, size=(m, 1)),
                         size=(m, n)).astype(np.int8)
    X = np.column_stack([np.ones(n), rng.normal(size=(n, 2))])
    U = rng.choice([-1.0, 1.0], size=(n, 40))
    Y, E = [], []
    for _ in range(P):
        eta = X @ (rng.normal(size=3) * 0.4) - 1.0
        y = (rng.random(n) < 1 / (1 + np.exp(-eta))).astype(np.float64)
        Y.append(y)
        E.append(glm_binomial(X, y).linear_predictors)
    Yq = np.stack([X @ (rng.normal(size=3) * 0.4) + rng.normal(size=n)
                   for _ in range(P)])
    tq = np.stack([np.var(Yq[p], ddof=1) * np.array([0.5, 0.5])
                   for p in range(P)])
    return dict(codes=codes, jop=jbuild(codes),
                op=build_packed2_grm(codes, device="cpu"), X=X, U=U,
                Y=np.stack(Y), E=np.stack(E), Yq=Yq, tq=tq,
                tb=np.tile([1.0, 0.5], (P, 1)))


def _assert_fits(got, want, rtol):
    for k in ("tau", "coefficients", "mu", "cov"):
        w = np.asarray(getattr(want, k))
        g = getattr(got, k).numpy()
        scale = np.maximum(np.abs(w), 1e-12)
        assert np.all(np.abs(g - w) <= rtol * scale), k
    for k in ("iterations", "converged", "trace_capped"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)), k)


def test_binary_multi_matches_jax(small):
    import jax.numpy as jnp
    from saigegds_tpu.models.fit_device import fit_glmm_binary_device_multi
    s = small
    want = fit_glmm_binary_device_multi(
        s["jop"], jnp.asarray(s["Y"]), jnp.asarray(s["X"]),
        jnp.asarray(s["tb"]), jnp.asarray(s["E"]), jnp.asarray(s["U"]),
        0.02, 1e-5)
    got = fit_device.fit_glmm_binary_device_multi(
        s["op"], _t(s["Y"]), _t(s["X"]), _t(s["tb"]), _t(s["E"]),
        _t(s["U"]), 0.02, 1e-5)
    assert (got.tau[:, 1] > 0).sum() >= 2 and got.pcg_iterations > 0
    # a pool of 40 probes at n = 400: the CV cutoff is out of reach, so
    # every trace escalates through the pool and is capped
    assert got.trace_capped.all()
    _assert_fits(got, want, RTOL_DEV)


def test_quant_multi_matches_jax(small):
    import jax.numpy as jnp
    from saigegds_tpu.models.fit_device import fit_glmm_quant_device_multi
    s = small
    want = fit_glmm_quant_device_multi(
        s["jop"], jnp.asarray(s["Yq"]), jnp.asarray(s["X"]),
        jnp.asarray(s["tq"]), jnp.asarray(s["U"]), 0.02, 1e-5)
    got = fit_device.fit_glmm_quant_device_multi(
        s["op"], _t(s["Yq"]), _t(s["X"]), _t(s["tq"]), _t(s["U"]), 0.02,
        1e-5)
    assert len(set(got.iterations.tolist())) > 1
    _assert_fits(got, want, RTOL_DEV)


@pytest.mark.parametrize("trait", ["binary", "quantitative"])
def test_lane_equals_its_own_run(small, trait):
    """Each lane of the batched fit equals the port's one-lane fit of its
    phenotype (the columns of a product are independent)."""
    s = small
    if trait == "binary":
        run = lambda sl: fit_device.fit_glmm_binary_device_multi(
            s["op"], _t(s["Y"][sl]), _t(s["X"]), _t(s["tb"][sl]),
            _t(s["E"][sl]), _t(s["U"]), 0.02, 1e-5, nrun=10,
            trace_cv_cutoff=0.05)
    else:
        run = lambda sl: fit_device.fit_glmm_quant_device_multi(
            s["op"], _t(s["Yq"][sl]), _t(s["X"]), _t(s["tq"][sl]),
            _t(s["U"]), 0.02, 1e-5, nrun=10, trace_cv_cutoff=0.05)
    multi = run(slice(None))
    for p in range(3):
        one = run(slice(p, p + 1))
        for k in ("tau", "coefficients", "mu", "cov"):
            np.testing.assert_allclose(getattr(multi, k)[p].numpy(),
                                       getattr(one, k)[0].numpy(),
                                       rtol=RTOL_LANE, atol=1e-14, err_msg=k)
        assert int(multi.iterations[p]) == int(one.iterations[0])
        assert bool(multi.trace_capped[p]) == bool(one.trace_capped[0])


def test_per_lane_design_matches_vmapped_jax(small):
    """One design per lane (GxG's refits: the covariates plus each pair's
    two dosages) against the JAX package's vmapped one-lane device fit,
    over the dense operator of the same codes."""
    import jax
    import jax.numpy as jnp
    from saigegds_tpu.models.fit_device import fit_glmm_binary_device
    from saigegds_tpu.models.glm import glm_binomial
    from saigegds_tpu.ops.grm import build_grm as jbuild_dense
    s = small
    rng = np.random.default_rng(9)
    y = s["Y"][1]
    Xs = np.stack([np.column_stack([s["X"], rng.binomial(2, 0.3, (400, 2))])
                   for _ in range(3)])
    E = np.stack([glm_binomial(X, y).linear_predictors for X in Xs])
    f = lambda X, eta: fit_glmm_binary_device(
        jbuild_dense(s["codes"]), jnp.asarray(y), X, jnp.asarray([1.0, 0.5]),
        eta, jnp.asarray(s["U"]), 0.02, 1e-5)
    want = jax.vmap(f)(jnp.asarray(Xs), jnp.asarray(E))
    got = fit_device.fit_glmm_binary_device_multi(
        build_grm(s["codes"], device="cpu"), _t(np.tile(y, (3, 1))), _t(Xs),
        _t(np.tile([1.0, 0.5], (3, 1))), _t(E), _t(s["U"]), 0.02, 1e-5)
    _assert_fits(got, want, RTOL_DEV)


# ---------------------------------------------------------------------------
# fit_null_glmm_multi end to end


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A GDS with two binary phenotypes of one polygenic liability (case
    fractions ~30% and ~15%) and two quantitative ones, 0.5% missing."""
    rng = np.random.default_rng(15)
    af = rng.uniform(0.05, 0.5, size=(N_VARIANTS, 1))
    codes = rng.binomial(2, af, size=(N_VARIANTS, N_SAMPLES)).astype(np.int8)
    beta = rng.normal(size=N_VARIANTS) * np.sqrt(0.8 / N_VARIANTS) \
        / np.sqrt(2 * af[:, 0] * (1 - af[:, 0]))
    X = rng.normal(size=(N_SAMPLES, 3))
    g = codes.T @ beta
    cols = {"sample.id": np.arange(1, N_SAMPLES + 1), "x1": X[:, 0],
            "x2": X[:, 1], "x3": X[:, 2]}
    for name, c in (("y0", -1.0), ("y1", -2.0)):
        eta = X @ np.array([0.3, -0.2, 0.1]) + c + g
        cols[name] = (rng.random(N_SAMPLES) < 1 / (1 + np.exp(-eta))) * 1.0
    for name in ("q0", "q1"):
        cols[name] = 20 + X @ np.array([0.5, 0.1, -0.3]) + g \
            + np.exp(rng.normal(size=N_SAMPLES) * 0.7)
    codes[rng.random(codes.shape) < 0.005] = 3
    gds = str(tmp_path_factory.mktemp("torch_fit_multi") / "fit.gds")
    write_seqarray_gds(gds, codes)
    return gds, cols, codes


def _both(data, resps, **cfg):
    from saigegds_tpu.models.fitnull import fit_null_glmm_multi as jfit
    gds, cols, _ = data
    formulas = [f"{r} ~ {COVS}" for r in resps]
    jm = jfit(formulas, pd.DataFrame(cols), gds,
              saigegds_tpu.NullModelConfig(grm_impl="packed2", **cfg))
    inst = {}
    tm = sgt.fit_null_glmm_multi(formulas, cols, gds,
                                 sgt.NullModelConfig(**cfg), instrument=inst,
                                 device="cpu")
    return jm, tm, inst


@pytest.fixture(scope="module")
def binary_fits(data):
    return _both(data, ["y0", "y1"])


def _assert_models(tms, jms):
    assert len(tms) == len(jms)
    for tm, jm in zip(tms, jms):
        assert tm.converged == jm.converged
        assert _rel(tm.tau, jm.tau) < RTOL_FIT
        assert _rel(tm.coefficients, jm.coefficients) < RTOL_FIT
        assert _rel(tm.fitted_values, jm.fitted_values) < RTOL_FIT
        np.testing.assert_array_equal(tm.var_ratio["id"], jm.var_ratio["id"])
        assert _rel(tm.var_ratio["ratio"], jm.var_ratio["ratio"]) < RTOL_FIT
        assert tm.coef_names == list(jm.coef_names)
        np.testing.assert_array_equal(tm.sample_id, jm.sample_id)


def test_binary_multi_fit_matches_jax(binary_fits):
    jm, tm, inst = binary_fits
    assert all(m.converged and m.tau[1] > 0 for m in tm)
    _assert_models(tm, jm)
    assert inst["lanes"] == 2 and len(inst["outer_iterations"]) == 2
    assert inst["matvecs"] > 0 and inst["pcg_iterations"] > 0
    for k in ("ingest_s", "aireml_s", "var_ratio_s"):
        assert inst[k] >= 0
    for p, m in enumerate(tm):
        markers = [e for e in m.fit_log if e["event"] == "var_ratio_marker"]
        assert markers and {e["phenotype"] for e in m.fit_log} == {p}
        assert len(markers) == len(m.var_ratio["id"])
    assert tm[0].fit_log is not tm[1].fit_log


def test_lanes_match_single_fits(data, binary_fits):
    """Each lane against the port's own fit of its phenotype, at the
    tolerances of ``tests/test_fit_null_multi.py`` except tau and the
    fitted values: both fits stop at the 2% rule (``tol = 0.02``) from
    different probe draws (a pool here, a stream restarted per trace
    there), so their tau_G may differ by up to twice ``tol`` relative, and
    the fitted values follow tau (5e-3 as for the coefficients, where the
    JAX file has 2e-3 for its fixture).  Measured on this fixture: tau_G
    1.97% (y0) and 2.71% (y1) apart against the 4% bound; fitted values
    2.2e-3 and 3.3e-3, coefficients 1.2e-3 and 1.3e-3 against 5e-3;
    variance ratios 0.28% and 0.35% against 2%."""
    gds, cols, _ = data
    _, tm, _ = binary_fits
    for p, r in enumerate(("y0", "y1")):
        s = sgt.fit_null_glmm(f"{r} ~ {COVS}", cols, gds,
                              sgt.NullModelConfig(), device="cpu")
        m = tm[p]
        assert m.converged and s.converged
        np.testing.assert_allclose(m.tau, s.tau, rtol=2 * 0.02)
        np.testing.assert_allclose(m.fitted_values, s.fitted_values,
                                   atol=5e-3)
        np.testing.assert_allclose(m.coefficients, s.coefficients, atol=5e-3)
        np.testing.assert_allclose(m.var_ratio["ratio"], s.var_ratio["ratio"],
                                   rtol=2e-2)
        np.testing.assert_array_equal(m.var_ratio["id"], s.var_ratio["id"])


def test_quantitative_multi_fit_matches_jax(data):
    jm, tm, _ = _both(data, ["q0", "q1"], trait_type="quantitative")
    assert all(m.converged and (m.tau > 0).all() for m in tm)
    _assert_models(tm, jm)
    gds, cols, _ = data
    s = sgt.fit_null_glmm(f"q0 ~ {COVS}", cols, gds,
                          sgt.NullModelConfig(trait_type="quantitative"),
                          device="cpu")
    np.testing.assert_allclose(tm[0].tau, s.tau, rtol=3e-2)
    np.testing.assert_allclose(tm[0].var_ratio["ratio"], s.var_ratio["ratio"],
                               rtol=3e-2)


def test_var_ratio_mac_cat_matches_jax(data):
    jm, tm, _ = _both(data, ["y0", "y1"], var_ratio_mac_cat=(300.5, 550.5))
    _assert_models(tm, jm)
    for p, (m, j) in enumerate(zip(tm, jm)):
        np.testing.assert_array_equal(m.var_ratio["mac_cat"],
                                      j.var_ratio["mac_cat"])
        markers = [e for e in m.fit_log if e["event"] == "var_ratio_marker"]
        assert {e["phenotype"] for e in m.fit_log} == {p}
        np.testing.assert_array_equal(
            np.sort([e["mac_cat"] for e in markers]),
            np.sort(m.var_ratio["mac_cat"]))


def test_var_ratio_multi_matches_serial(data):
    """The stacked variance ratios equal P serial ``calc_var_ratio``
    passes lane for lane: the same markers, escalations and ratios."""
    from saigegds_tpu_torch.models.glm import glm_binomial, obj_nok_binary
    _, cols, codes = data
    rng = np.random.default_rng(21)
    codes = codes[:400]
    grm = fitnull._FitGRM(build_packed2_grm(codes, device="cpu"))
    X = np.column_stack([np.ones(N_SAMPLES), cols["x1"], cols["x2"]])
    cfg = sgt.NullModelConfig()
    order = RRandom(cfg.seed).sample_int(len(codes), len(codes))
    fit0s, glmms, noks = [], [], []
    for p in range(3):
        y = (rng.random(N_SAMPLES) < 0.3) * 1.0
        f0 = glm_binomial(X, y)
        fit0s.append(f0)
        noks.append(obj_nok_binary(X, y))
        glmms.append(fitnull.GlmmFit(
            coefficients=f0.coefficients, tau=np.array([1.0, 0.2 + 0.1 * p]),
            linear_predictors=f0.linear_predictors,
            fitted_values=f0.fitted_values, residuals=f0.residuals,
            cov=np.eye(3), converged=True))
    multi = fitnull.calc_var_ratio_multi(grm, codes, fit0s, glmms, noks, cfg,
                                         order, binary=True)
    for p in range(3):
        one = fitnull.calc_var_ratio(grm, codes, fit0s[p], glmms[p], noks[p],
                                     cfg, order, binary=True)
        assert multi[p]["id"] == one["id"]
        np.testing.assert_allclose(multi[p]["ratio"], one["ratio"],
                                   rtol=1e-10)


def test_validation_and_not_ported(data, tmp_path):
    gds, cols, _ = data
    fit = lambda f, **kw: sgt.fit_null_glmm_multi(f, cols, gds,
                                                  device="cpu", **kw)
    with pytest.raises(ValueError, match="covariate terms"):
        fit(["y0 ~ x1 + x2", "y1 ~ x1"])
    with pytest.raises(ValueError, match="duplicate"):
        fit(["y0 ~ x1", "y0 ~ x1"])
    with pytest.raises(ValueError, match="'{}'"):
        fit(["y0 ~ x1", "y1 ~ x1"], model_savefn=str(tmp_path / "m.npz"))
    with pytest.raises(ValueError, match="Invalid trait type"):
        fit(["q0 ~ x1"], config=sgt.NullModelConfig(trait_type="poisson"))
    with pytest.raises(NotImplementedError, match="takes no mesh"):
        fit(["y0 ~ x1"], mesh=object())
    with pytest.raises(TypeError):
        sgt.fit_null_glmm_multi(["y0 ~ x1"], cols, gds)


def test_save_pattern(data, binary_fits, tmp_path):
    gds, cols, _ = data
    _, tm, _ = binary_fits
    pat = str(tmp_path / "m_{}.npz")
    got = sgt.fit_null_glmm_multi([f"y0 ~ {COVS}", f"y1 ~ {COVS}"], cols,
                                  gds, model_savefn=pat, device="cpu")
    for p, m in enumerate(tm):
        back = sgt.NullModel.load(pat.format(p))
        np.testing.assert_array_equal(back.tau, got[p].tau)
        np.testing.assert_allclose(back.tau, m.tau, rtol=1e-12)
