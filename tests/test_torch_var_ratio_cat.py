"""MAC-categorized variance ratios in the PyTorch port
(``NullModelConfig.var_ratio_mac_cat``, ``fitnull.calc_var_ratio_cat``)
against the JAX package's, on the fit of ``tests/test_var_ratio_cat.py``:
500 samples x 400 GRM markers, half rare (MAF 0.002-0.01) and half common,
no MAF or missing-rate filter, ``num_marker`` 10, categories
(0, 10.5], (10.5, 20.5] and (20.5, inf).

Tolerance: the same markers in the same order in each category, their
MAF/MAC exact, ``mac_bins`` carried; tau, var1/var2 and the ratios within
1e-8 relative (every PCG solve agrees to ~1e-10 with equal iteration
counts, test_torch_pcg); the scan from each package's fitted model within
1e-7 relative (the reference contract), and from the JAX model carried
over within 1e-10.  The binary trait and the quantitative trait.
"""

import numpy as np
import pandas as pd
import pytest

import saigegds_tpu
from saigegds_tpu.io.gds_write import write_seqarray_gds
from _torch_synth import one_torch_thread  # noqa: F401 (autouse)
import saigegds_tpu_torch as sg

RTOL_VR = 1e-8
RTOL_P = 1e-7
RTOL_SCAN = 1e-10
EDGES = (10.5, 20.5)
N, M = 500, 400


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    rng = np.random.default_rng(7)
    af = np.concatenate([rng.uniform(0.002, 0.01, M // 2),     # rare
                         rng.uniform(0.05, 0.5, M - M // 2)])   # common
    rng.shuffle(af)
    codes = rng.binomial(2, af[:, None], size=(M, N)).astype(np.int8)
    path = str(tmp_path_factory.mktemp("torch_vrc") / "grm.gds")
    sid = np.asarray([f"s{i}" for i in range(N)], object)
    write_seqarray_gds(path, codes, sample_id=sid)
    x1 = rng.normal(size=N)
    g = np.where(codes == 3, 0, codes).T @ rng.normal(size=M) * 0.05
    eta = -1.0 + 0.3 * x1 + g
    y = (rng.random(N) < 1 / (1 + np.exp(-eta))).astype(float)
    yq = 3.0 + 0.5 * x1 + g + np.exp(rng.normal(size=N) * 0.5)
    cols = {"sample.id": sid, "y": y, "yq": yq, "x1": x1}
    return path, cols


@pytest.fixture(scope="module", params=["binary", "quantitative"])
def fits(request, data):
    path, cols = data
    formula = "y ~ x1" if request.param == "binary" else "yq ~ x1"
    kw = dict(trait_type=request.param, maf=0.0, missing_rate=1.0,
              num_marker=10, var_ratio_mac_cat=EDGES)
    jm = saigegds_tpu.fit_null_glmm(
        formula, pd.DataFrame(cols), path,
        saigegds_tpu.NullModelConfig(grm_impl="packed2", **kw))
    tm = sg.fit_null_glmm(formula, cols, path, sg.NullModelConfig(**kw),
                          device="cpu")
    return jm, tm


def _rel(a, b) -> float:
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.max(np.abs(a - b) / np.abs(b)))


def test_categorical_table_matches_jax(fits):
    jm, tm = fits
    jv, tv = jm.var_ratio, tm.var_ratio
    assert sorted(tv) == sorted(jv)
    np.testing.assert_array_equal(tv["mac_bins"], EDGES)
    for k in ("id", "mac_cat", "maf", "mac"):
        np.testing.assert_array_equal(tv[k], jv[k], err_msg=k)
    cat = np.asarray(tv["mac_cat"], int)
    mac = np.asarray(tv["mac"], float)
    bounds = [(0, EDGES[0]), EDGES, (EDGES[1], np.inf)]
    for c, (lo, hi) in enumerate(bounds):
        sel = mac[cat == c]
        assert sel.size >= 10 and ((sel > lo) & (sel <= hi)).all()
    assert len(np.unique(tv["id"])) == len(tv["id"])
    assert _rel(tm.tau, jm.tau) < RTOL_VR
    for k in ("var1", "var2", "ratio"):
        assert _rel(tv[k], jv[k]) < RTOL_VR, k


def test_scan_model_category_means(fits):
    _, tm = fits
    sm = tm.scan_model(device="cpu")
    vr = tm.var_ratio
    cat = np.asarray(vr["mac_cat"], int)
    rat = np.asarray(vr["ratio"], float)
    np.testing.assert_array_equal(sm.vr_edges.numpy(), EDGES)
    for c in range(3):
        np.testing.assert_allclose(sm.vr_ratios[c].item(),
                                   rat[cat == c].mean(), rtol=1e-12)


def test_scan_from_categorical_models(data, fits):
    """The port's scan from its fitted model against the JAX scan from
    the JAX model (1e-7), and from the JAX model carried over (1e-10)."""
    path, _ = data
    jm, tm = fits
    want = saigegds_tpu.assoc_spa(
        path, jm, saigegds_tpu.ScanConfig(packed_sparse=False, mac=1.0))
    cfg = sg.ScanConfig(mac=1.0)
    got = sg.assoc_spa(path, tm, cfg, device="cpu")
    carried = sg.assoc_spa(path, sg.NullModel.from_arrays(vars(jm)), cfg,
                           device="cpu")
    np.testing.assert_array_equal(got["id"], want["id"].to_numpy())
    mac = got["mac"]
    assert (mac <= EDGES[0]).any() and (mac > EDGES[1]).any()
    for c in ("pval", "beta", "SE"):
        np.testing.assert_allclose(got[c], want[c].to_numpy(), rtol=RTOL_P,
                                   err_msg=c)
        np.testing.assert_allclose(carried[c], want[c].to_numpy(),
                                   rtol=RTOL_SCAN, err_msg=c)


def test_empty_category_warns(data):
    """A category no GRM marker falls in warns, and the scan falls back to
    the overall mean there."""
    path, cols = data
    cfg = sg.NullModelConfig(maf=0.0, missing_rate=1.0, num_marker=10,
                             var_ratio_mac_cat=(10.5, 10.6, 20.5))
    with pytest.warns(UserWarning, match="matched no GRM marker"):
        tm = sg.fit_null_glmm("y ~ x1", cols, path, cfg, device="cpu")
    sm = tm.scan_model(device="cpu")
    assert sm.vr_ratios[1].item() == tm.mean_var_ratio


def test_unsorted_bounds_raise(data):
    path, cols = data
    with pytest.raises(ValueError, match="ascending"):
        sg.fit_null_glmm("y ~ x1", cols, path,
                         sg.NullModelConfig(var_ratio_mac_cat=(20.5, 10.5)),
                         device="cpu")
