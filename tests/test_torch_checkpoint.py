"""Fit checkpoints in the PyTorch port (``NullModelConfig(checkpoint=)``):
the three cases of ``tests/test_checkpoint.py`` on synthetic data
(a polygenic binary trait, 600 samples x 500 GRM markers, 0.5% missing)
instead of the reference's fixtures, and a quantitative fit killed
mid-iteration.

The contract is the JAX package's: exact replay.  A fit killed at any
point and resumed from its checkpoint files (``{checkpoint}.fit.npz``
after every outer iteration and once done, ``{checkpoint}.vr.npz`` after
every variance-ratio chunk) gives the same model as an uninterrupted
run, bit for bit on the CPU; the files are gone once the model is
assembled; a file of another model shape is ignored with a warning.
"""

import os

import numpy as np
import pytest

from _torch_synth import one_torch_thread  # noqa: F401 (autouse)
import saigegds_tpu_torch as sg
from saigegds_tpu.io.gds_write import write_seqarray_gds
from saigegds_tpu_torch.models import fitnull

N, M = 600, 500


class _Boom(RuntimeError):
    pass


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    rng = np.random.default_rng(29)
    af = rng.uniform(0.05, 0.5, size=(M, 1))
    codes = rng.binomial(2, af, size=(M, N)).astype(np.int8)
    beta = rng.normal(size=M) * np.sqrt(0.8 / M) \
        / np.sqrt(2 * af[:, 0] * (1 - af[:, 0]))
    X = rng.normal(size=(N, 2))
    g = codes.T @ beta
    eta = X @ np.array([0.3, -0.2]) - 1.0 + g
    y = (rng.random(N) < 1 / (1 + np.exp(-eta))).astype(np.float64)
    yq = 2.0 + X @ np.array([0.3, -0.2]) + g + rng.normal(size=N)
    codes[rng.random(codes.shape) < 0.005] = 3
    path = str(tmp_path_factory.mktemp("torch_ck") / "fit.gds")
    write_seqarray_gds(path, codes)
    cols = {"sample.id": np.arange(1, N + 1), "y": y, "yq": yq,
            "x1": X[:, 0], "x2": X[:, 1]}
    return path, cols


def _fit(data, trait="binary", **kw):
    path, cols = data
    formula = "y ~ x1 + x2" if trait == "binary" else "yq ~ x1 + x2"
    inst = {}
    m = sg.fit_null_glmm(formula, cols, path,
                         sg.NullModelConfig(trait_type=trait, **kw),
                         instrument=inst, device="cpu")
    return m, inst


@pytest.fixture(scope="module")
def base(data):
    return {t: _fit(data, t) for t in ("binary", "quantitative")}


def _assert_same(m1, m2):
    np.testing.assert_array_equal(m1.tau, m2.tau)
    np.testing.assert_array_equal(m1.coefficients, m2.coefficients)
    np.testing.assert_array_equal(m1.fitted_values, m2.fitted_values)
    np.testing.assert_array_equal(m1.cov, m2.cov)
    assert m1.converged == m2.converged
    np.testing.assert_array_equal(m1.var_ratio["ratio"],
                                  m2.var_ratio["ratio"])
    np.testing.assert_array_equal(m1.var_ratio["id"], m2.var_ratio["id"])


@pytest.mark.parametrize("trait", ["binary", "quantitative"])
def test_resume_after_midfit_crash(data, base, tmp_path, monkeypatch,
                                   trait):
    """Kill the fit inside outer iteration 2; the resume is bit-identical,
    with the same iteration count, and the files are removed."""
    want, inst_want = base[trait]
    assert inst_want["outer_iterations"] >= 2
    ck = str(tmp_path / "fit_ck")
    name = "_fit_tau_binary" if trait == "binary" else "_fit_tau_quant"
    real = getattr(fitnull, name)
    calls = {"n": 0}

    def bomb(*a, **k):
        calls["n"] += 1
        if calls["n"] == 2:
            raise _Boom()
        return real(*a, **k)

    monkeypatch.setattr(fitnull, name, bomb)
    with pytest.raises(_Boom):
        _fit(data, trait, checkpoint=ck)
    assert os.path.exists(ck + ".fit.npz")      # iteration-1 state saved
    monkeypatch.setattr(fitnull, name, real)

    got, inst = _fit(data, trait, checkpoint=ck)
    _assert_same(got, want)
    assert inst["outer_iterations"] == inst_want["outer_iterations"]
    assert not os.path.exists(ck + ".fit.npz")
    assert not os.path.exists(ck + ".vr.npz")


def test_resume_after_var_ratio_crash(data, base, tmp_path, monkeypatch):
    """Kill after the first variance-ratio chunk; the resumed run skips the
    whole AI-REML fit (its done state) and continues the marker pass."""
    want, inst_want = base["binary"]
    ck = str(tmp_path / "vr_ck")
    real = fitnull._ck_save

    def bomb(path, **arrs):
        real(path, **arrs)
        if path.endswith(".vr.npz"):
            raise _Boom()

    monkeypatch.setattr(fitnull, "_ck_save", bomb)
    with pytest.raises(_Boom):
        _fit(data, checkpoint=ck)
    assert os.path.exists(ck + ".fit.npz")
    assert os.path.exists(ck + ".vr.npz")
    monkeypatch.setattr(fitnull, "_ck_save", real)

    # the fit phase must not rerun: poison the tau update to prove the
    # done state is taken
    def poison(*a, **k):
        raise AssertionError("fit phase reran despite done checkpoint")

    monkeypatch.setattr(fitnull, "_fit_tau_binary", poison)
    got, inst = _fit(data, checkpoint=ck)
    _assert_same(got, want)
    assert inst["outer_iterations"] == inst_want["outer_iterations"]
    assert not os.path.exists(ck + ".fit.npz")
    assert not os.path.exists(ck + ".vr.npz")


def test_stale_checkpoint_ignored(data, base, tmp_path):
    """A checkpoint of another model shape is ignored with a warning, not
    resumed."""
    ck = str(tmp_path / "stale_ck")
    fitnull._ck_save(ck + ".fit.npz", phase="iter", it=3, brk=False,
                     n=17, k=2, binary=True, tau=np.array([1.0, 0.5]),
                     alpha=np.zeros(2), eta=np.zeros(17),
                     alpha0=np.zeros(2), eta0=np.zeros(17))
    with pytest.warns(UserWarning, match="shape mismatch"):
        got, _ = _fit(data, checkpoint=ck)
    _assert_same(got, base["binary"][0])
    assert not os.path.exists(ck + ".fit.npz")
