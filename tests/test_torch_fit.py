"""The PyTorch port's binary null-GLMM fit (``fit_null_glmm`` on the CPU)
against the JAX package's, end to end from one synthetic GDS, and the scan
run from each package's fitted model.

The JAX side fits with ``grm_impl="packed2"`` from a pandas DataFrame; the
port from a dict of numpy columns.  Tolerances (the reference contract is
1e-4 for the model and 1e-7 for p-values):

* tau, coefficients and variance ratios within 1e-6 relative, with the
  same outer-iteration count, the same variance-ratio markers and the same
  coefficient names -- every GRM product agrees to ~1e-15
  (test_torch_packed_grm) and every PCG solve to ~1e-10 with the same
  iteration counts (test_torch_pcg);
* the scan's p-values within 1e-7 relative.
"""

import numpy as np
import pandas as pd
import pytest

from _torch_synth import one_torch_thread  # noqa: F401 (autouse)
import saigegds_tpu
import saigegds_tpu_torch as sgt
from saigegds_tpu.io.gds_write import write_seqarray_gds
from saigegds_tpu.models.fitnull import fit_null_glmm as jax_fit
from saigegds_tpu.models.fitnull import _model_matrix as jax_model_matrix
from saigegds_tpu_torch.models import fitnull

RTOL_FIT = 1e-6
RTOL_P = 1e-7
N_SAMPLES, N_VARIANTS = 800, 600
FORMULA = "y ~ x1 + x2 + x3"
FACTOR_FORMULA = "y ~ x1 + site + I(x2 * 2)"


def _rel(a, b) -> float:
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.max(np.abs(a - b) / np.abs(b)))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A GDS with a polygenic binary phenotype (true tau_G ~ 0.6, as in
    ``bench.py``'s fit data) and 0.5% missing genotypes."""
    rng = np.random.default_rng(5)
    af = rng.uniform(0.05, 0.5, size=(N_VARIANTS, 1))
    codes = rng.binomial(2, af, size=(N_VARIANTS, N_SAMPLES)).astype(np.int8)
    beta = rng.normal(size=N_VARIANTS) * np.sqrt(0.6 / N_VARIANTS) \
        / np.sqrt(2 * af[:, 0] * (1 - af[:, 0]))
    X = rng.normal(size=(N_SAMPLES, 3))
    eta = X @ np.array([0.3, -0.2, 0.1]) - 1.0 + codes.T @ beta
    y = (rng.random(N_SAMPLES) < 1 / (1 + np.exp(-eta))).astype(np.float64)
    codes[rng.random(codes.shape) < 0.005] = 3
    gds = str(tmp_path_factory.mktemp("torch_fit") / "fit.gds")
    write_seqarray_gds(gds, codes)
    cols = {"sample.id": np.arange(1, N_SAMPLES + 1), "y": y,
            "x1": X[:, 0], "x2": X[:, 1], "x3": X[:, 2]}
    return gds, cols, rng


@pytest.fixture(scope="module")
def fits(data):
    gds, cols, _ = data
    jm = jax_fit(FORMULA, pd.DataFrame(cols), gds,
                 saigegds_tpu.NullModelConfig(grm_impl="packed2"))
    inst = {}
    tm = sgt.fit_null_glmm(FORMULA, cols, gds, sgt.NullModelConfig(),
                           instrument=inst, device="cpu")
    return jm, tm, inst


def _assert_models_match(tm, jm, inst):
    assert tm.converged == jm.converged
    assert tm.coef_names == list(jm.coef_names)
    assert _rel(tm.tau[1], jm.tau[1]) < RTOL_FIT and tm.tau[0] == jm.tau[0]
    assert _rel(tm.coefficients, jm.coefficients) < RTOL_FIT
    np.testing.assert_array_equal(tm.var_ratio["id"], jm.var_ratio["id"])
    assert _rel(tm.var_ratio["ratio"], jm.var_ratio["ratio"]) < RTOL_FIT
    np.testing.assert_array_equal(tm.variant_id, jm.variant_id)
    np.testing.assert_array_equal(tm.sample_id, jm.sample_id)
    n_iter = sum(e["event"] == "iteration" for e in jm.fit_log)
    assert inst["outer_iterations"] == n_iter


def test_fit_matches_jax(fits):
    jm, tm, inst = fits
    assert tm.converged and tm.tau[1] > 0
    _assert_models_match(tm, jm, inst)
    np.testing.assert_allclose(tm.fitted_values, jm.fitted_values,
                               rtol=RTOL_FIT)
    np.testing.assert_allclose(tm.X1, jm.X1, rtol=0, atol=1e-12)
    # one GRM product per PCG iteration, plus APY per AI score (an outer
    # iteration's update and the first one) and AU per trace round
    assert inst["matvecs"] > inst["pcg_iterations"] > 0
    for k in ("ingest_s", "aireml_s", "var_ratio_s"):
        assert inst[k] >= 0


def test_scan_from_fitted_models_matches(data, fits):
    gds = data[0]
    jm, tm, _ = fits
    want = saigegds_tpu.assoc_spa(
        gds, jm, saigegds_tpu.ScanConfig(packed_sparse=False, block_size=128))
    got = sgt.assoc_spa(gds, tm, sgt.ScanConfig(block_size=128),
                        device="cpu")
    np.testing.assert_array_equal(got["id"], want["id"].to_numpy())
    assert len(got["id"]) > 500
    for c in ("pval", "p.norm"):
        np.testing.assert_allclose(got[c], want[c].to_numpy(), rtol=RTOL_P,
                                   err_msg=c)


@pytest.mark.parametrize("dropped", [False, True])
def test_streamed_fit_equals_in_memory(data, fits, dropped):
    """The streamed ingest (the route past 4 GB of int8 codes) builds the
    same operator and harvests the same marker rows: the same model, with
    every sample of the GDS file in the fit or (``dropped``) some left out
    by a missing covariate."""
    gds, cols, _ = data
    _, tm, inst = fits
    if dropped:
        cols = dict(cols, x2=cols["x2"].copy())
        cols["x2"][[0, 7, 300, N_SAMPLES - 1]] = np.nan
        inst = {}
        tm = sgt.fit_null_glmm(FORMULA, cols, gds, sgt.NullModelConfig(),
                               instrument=inst, device="cpu")
        assert tm.n_samples == N_SAMPLES - 4
    inst2 = {}
    got = sgt.fit_null_glmm(FORMULA, cols, gds,
                            sgt.NullModelConfig(stream_geno=True),
                            instrument=inst2, device="cpu")
    assert _rel(got.tau[1], tm.tau[1]) < 1e-12
    assert _rel(got.var_ratio["ratio"], tm.var_ratio["ratio"]) < 1e-12
    np.testing.assert_array_equal(got.sample_id, tm.sample_id)
    assert inst2["matvecs"] == inst["matvecs"]


def test_dense_oracle_fit_agrees(data, fits):
    gds, cols, _ = data
    _, tm, _ = fits
    got = sgt.fit_null_glmm(FORMULA, cols, gds,
                            sgt.NullModelConfig(grm_impl="dense"),
                            device="cpu")
    assert _rel(got.tau[1], tm.tau[1]) < RTOL_FIT
    assert _rel(got.var_ratio["ratio"], tm.var_ratio["ratio"]) < RTOL_FIT


def test_factor_covariate_and_alignment_match_jax(data):
    """A string-valued factor, an ``I()`` term, missing covariates and a
    data table in another order than the GDS file (with a sample the file
    lacks): the design matrix, its names and the fit match the JAX
    package's."""
    gds, cols, rng = data
    d = dict(cols)
    d["site"] = rng.choice(np.array(["north", "east", "south"]), N_SAMPLES)
    d["x1"] = d["x1"].copy()
    d["x1"][[3, 50, 400]] = np.nan
    d = {k: np.append(v, v[:1]) for k, v in d.items()}
    d["sample.id"][-1] = N_SAMPLES + 7               # not in the GDS file
    perm = rng.permutation(N_SAMPLES + 1)
    d = {k: v[perm] for k, v in d.items()}

    df = pd.DataFrame(d)
    terms = fitnull._parse_formula(FACTOR_FORMULA)[1]
    jX, jnames = jax_model_matrix(df, terms)
    tX, tnames = fitnull._model_matrix(
        {k: np.asarray(v) for k, v in d.items()},
        {"site": sorted(set(d["site"]))}, terms)
    assert tnames == jnames == ["(Intercept)", "x1", "site_north",
                                "site_south", "I(x2 * 2)"]
    np.testing.assert_array_equal(tX, jX)

    jm = jax_fit(FACTOR_FORMULA, df, gds,
                 saigegds_tpu.NullModelConfig(grm_impl="packed2"))
    inst = {}
    tm = sgt.fit_null_glmm(FACTOR_FORMULA, d, gds, sgt.NullModelConfig(),
                           instrument=inst, device="cpu")
    assert tm.n_samples == N_SAMPLES - 3
    _assert_models_match(tm, jm, inst)
    np.testing.assert_allclose(tm.X1, jm.X1, rtol=0, atol=1e-12)


@pytest.mark.parametrize("cfg", ["mesh"])
def test_not_ported_raises(data, fits, cfg):
    """``mesh=`` is ported now (``parallel/mesh.py``): a one-shard mesh no
    longer raises, and fits exactly as the unsharded operator does."""
    from saigegds_tpu_torch.parallel.mesh import make_mesh
    gds, cols, _ = data
    _, tm, inst = fits
    got_inst = {}
    got = sgt.fit_null_glmm(FORMULA, cols, gds, sgt.NullModelConfig(),
                            instrument=got_inst, device="cpu",
                            mesh=make_mesh(devices=["cpu"]))
    for f in ("tau", "coefficients", "fitted_values"):
        np.testing.assert_array_equal(getattr(got, f), getattr(tm, f))
    np.testing.assert_array_equal(got.var_ratio["ratio"],
                                  tm.var_ratio["ratio"])
    assert got_inst["matvecs"] == inst["matvecs"]


def test_device_is_required(data):
    gds, cols, _ = data
    with pytest.raises(TypeError):
        sgt.fit_null_glmm(FORMULA, cols, gds)
