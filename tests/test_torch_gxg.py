"""The PyTorch port's GxG interaction test (``gxg_spa`` on the CPU) against
the JAX package's.

One GRM GDS (N = 600 x M = 300) and an association GDS holding the same
samples in another order; three pairs of common variants.  Each mode runs
serially and with ``pair_batch`` in both packages (the JAX side with
``grm_impl="packed2"``, the port's 2-bit operator): full per-pair refits,
``use_approx_tau`` and the GLM screen.  Tolerances: beta, SE, pval and
p.norm within 1e-8 relative and tau_G within 1e-6 (the refits' PCG
solves agree to ~1e-10, test_torch_pcg); the batched approx-tau path
equals the serial one within 1e-12 (the same solves, batched).
"""

import numpy as np
import pandas as pd
import pytest
import torch

from _torch_synth import one_torch_thread  # noqa: F401 (autouse)
import saigegds_tpu
import saigegds_tpu_torch as sgt
from saigegds_tpu.io.gds_write import write_seqarray_gds
from saigegds_tpu_torch.assoc import gxg

RTOL = 1e-8
RTOL_TAU = 1e-6
RTOL_BATCH = 1e-12
N_SAMPLES, N_VARIANTS = 600, 300
FORMULA = "y ~ x1 + x2"
PAIRS = {"snp1": [11, 40, 75], "snp2": [12, 90, 150],
         "tag": ["a", "b", "c"]}
MODES = {"full": {}, "approx": dict(use_approx_tau=True),
         "glm": dict(glm_threshold=0.6)}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_gxg")
    rng = np.random.default_rng(61)
    af = rng.uniform(0.1, 0.5, size=(N_VARIANTS, 1))
    codes = rng.binomial(2, af, size=(N_VARIANTS, N_SAMPLES)).astype(np.int8)
    beta = rng.normal(size=N_VARIANTS) * np.sqrt(1.0 / N_VARIANTS) \
        / np.sqrt(2 * af[:, 0] * (1 - af[:, 0]))
    X = rng.normal(size=(N_SAMPLES, 2))
    eta = X @ np.array([0.3, -0.2]) - 0.8 + codes.T @ beta
    y = (rng.random(N_SAMPLES) < 1 / (1 + np.exp(-eta))) * 1.0
    codes[rng.random(codes.shape) < 0.004] = 3
    grm = str(tmp / "grm.gds")
    write_seqarray_gds(grm, codes)
    perm = rng.permutation(N_SAMPLES)
    assoc = str(tmp / "assoc.gds")
    write_seqarray_gds(assoc, codes[:, perm],
                       sample_id=np.arange(1, N_SAMPLES + 1)[perm])
    cols = {"sample.id": np.arange(1, N_SAMPLES + 1), "y": y,
            "x1": X[:, 0], "x2": X[:, 1]}
    return tmp, grm, assoc, cols


def _jax(data, pair_batch=0, **kw):
    _, grm, assoc, cols = data
    return saigegds_tpu.gxg_spa(
        FORMULA, pd.DataFrame(cols), grm, pd.DataFrame(PAIRS),
        gds_assoc=assoc,
        config=saigegds_tpu.NullModelConfig(grm_impl="packed2"),
        pair_batch=pair_batch, **kw)


def _port(data, pair_batch=0, **kw):
    _, grm, assoc, cols = data
    return sgt.gxg_spa(FORMULA, cols, grm, PAIRS, gds_assoc=assoc,
                       pair_batch=pair_batch, device="cpu", **kw)


def _assert_matches(got: dict, want: pd.DataFrame):
    assert list(got) == list(want.columns)
    for c in ("id1", "id2", "snp1", "snp2", "n_nonzero", "converged", "tag"):
        np.testing.assert_array_equal(got[c], want[c].to_numpy(), err_msg=c)
    for c, rtol in (("beta", RTOL), ("SE", RTOL), ("pval", RTOL),
                    ("p.norm", RTOL), ("p.glm", RTOL), ("p.glm.norm", RTOL),
                    ("maf1", RTOL), ("tau_G", RTOL_TAU)):
        if c not in got:
            continue
        w = want[c].to_numpy()
        np.testing.assert_array_equal(np.isnan(got[c]), np.isnan(w))
        ok = np.isfinite(w)
        np.testing.assert_allclose(got[c][ok], w[ok], rtol=rtol, atol=1e-300,
                                   err_msg=c)


@pytest.fixture(scope="module", params=list(MODES))
def serial(request, data):
    kw = MODES[request.param]
    return request.param, _port(data, **kw), _jax(data, **kw)


def test_serial_matches_jax(serial):
    mode, got, want = serial
    _assert_matches(got, want)
    assert ((got["pval"][np.isfinite(got["pval"])] >= 0)
            & (got["pval"][np.isfinite(got["pval"])] <= 1)).all()
    if mode == "glm":         # the screen lets some pairs through, not all
        assert 0 < np.isfinite(got["pval"]).sum() < len(got["pval"])
    else:
        assert (got["tau_G"] > 0).all()


def test_batched_matches_jax(data, serial):
    mode, got_serial, _ = serial
    kw = MODES[mode]
    got = _port(data, pair_batch=2, **kw)
    _assert_matches(got, _jax(data, pair_batch=2, **kw))
    if mode == "approx":      # the serial path's solves, batched
        for c in ("beta", "SE", "pval", "p.norm", "tau_G"):
            np.testing.assert_allclose(got[c], got_serial[c],
                                       rtol=RTOL_BATCH, err_msg=c)


def test_minor_allele_geno():
    from saigegds_tpu.assoc.gxg import _minor_allele_geno as jminor
    rng = np.random.default_rng(3)
    for af in (0.2, 0.8):
        g = rng.binomial(2, af, 50).astype(float)
        g[rng.random(50) < 0.1] = np.nan
        np.testing.assert_array_equal(gxg._minor_allele_geno(g), jminor(g))
    with np.errstate(all="ignore"), pytest.warns(RuntimeWarning):
        np.testing.assert_array_equal(gxg._minor_allele_geno([np.nan] * 3),
                                      np.zeros(3))


def test_spa_keeps_zero_pvalue():
    """``zero_noadj=False`` (GxG) keeps Saddle_Prob's pval = 0 with
    converged set, where the scan's default replaces it by pval_noadj."""
    import jax.numpy as jnp
    from saigegds_tpu.ops import spa as jspa
    from saigegds_tpu_torch.ops import spa as tspa
    rng = np.random.default_rng(5)
    B, N = 4, 64
    g = rng.normal(size=(B, N))
    mu = rng.uniform(0.02, 0.4, size=N)
    m1 = (g * mu).sum(axis=1)
    var2 = (g * g * mu * (1 - mu)).sum(axis=1)
    # far lanes: the saddle point's tail underflows (spa == 0) while the
    # unadjusted p-value is still positive
    q = m1 + np.sqrt(var2) * np.array([3.0, 10.0, 20.0, -25.0])
    args = (q, m1, var2, g, mu, np.ones((B, N), bool))
    got = {}
    for zero_noadj in (True, False):
        want = jspa.saddle_prob_batch(*map(jnp.asarray, args), cutoff=2.0,
                                      zero_noadj=zero_noadj)
        res = tspa.saddle_prob_batch(*map(torch.from_numpy, args),
                                     cutoff=2.0, zero_noadj=zero_noadj)
        np.testing.assert_array_equal(res[1].numpy(), np.asarray(want[1]))
        np.testing.assert_allclose(res[0].numpy(), np.asarray(want[0]),
                                   rtol=1e-10)
        got[zero_noadj] = (res[0].numpy(), res[1].numpy())
    zero = got[False][0] == 0
    assert zero.sum() >= 2 and got[False][1][zero].all()
    assert (got[True][0][zero] > 0).all() and not got[True][1][zero].any()
    np.testing.assert_array_equal(got[True][0][~zero], got[False][0][~zero])


def test_quantitative_raises(data):
    _, grm, _, cols = data
    with pytest.raises(NotImplementedError):
        sgt.gxg_spa(FORMULA, cols, grm, PAIRS, device="cpu",
                    config=sgt.NullModelConfig(trait_type="quantitative"))
    with pytest.raises(TypeError):
        sgt.gxg_spa(FORMULA, cols, grm, PAIRS)


def test_pair_rows_and_incremental_save(data, monkeypatch):
    """Pairs as a sequence of rows, the GRM GDS as the association file,
    and the table saved after every pair (a crash keeps the pairs done)."""
    from saigegds_tpu_torch.assoc import single
    tmp, grm, _, cols = data
    saved = []
    real = single.save_assoc
    monkeypatch.setattr(single, "save_assoc", lambda tab, path, **kw: (
        saved.append(len(tab["id1"])), real(tab, path, **kw)))
    out = str(tmp / "gxg.tsv")
    got = sgt.gxg_spa(FORMULA, cols, grm, [(11, 12), (40, 90)],
                      use_approx_tau=True, res_savefn=out, device="cpu")
    assert saved == [1, 2, 2]
    want = _port(data, use_approx_tau=True)
    for c in ("beta", "pval", "tau_G"):
        np.testing.assert_allclose(got[c], want[c][:2], rtol=1e-12)
    back = sgt.load_pval(out)
    np.testing.assert_allclose(back["pval"], got["pval"], rtol=1e-15)
