"""The port's public device fitters and the PheWAS fit's lanes in groups.

* The four public fitters (``fit_glmm_binary_device``,
  ``fit_glmm_quant_device`` and their ``*_multi`` forms) against the JAX
  package's four, on the same operator carried across: the 2-bit store
  by ``Packed2GRM.from_arrays`` and the dense oracle by
  ``GRMOperator.from_arrays`` (n = 400 x m = 150, P = 3 lanes, a pool of
  40 probes).  tau, coefficients, mu and cov within 1e-8 relative (the
  tolerance ``tests/test_torch_fit_multi.py`` holds the batched fitters
  to), iterations, ``converged`` and ``trace_capped`` equal; a tau
  blow-up that runs the halving retry, and a capped trace.
* Lanes in groups: P = 5 binary and P = 3 quantitative lanes (and P = 3
  binary lanes with one design each, as GxG's refits) with the groups
  forced to 1 and 2 lanes (``fit_device._lane_groups`` monkeypatched)
  against one group: within 1e-10, equal iterations and flags, the
  probe products GRM @ U taken once per call whatever the groups;
  ``fit_null_glmm_multi`` and ``gxg_spa``'s batched refits likewise.
* The group rule: balanced groups, one group on the CPU, on a CUDA
  device (``torch.cuda.mem_get_info`` monkeypatched) the groups its free
  memory allows, and a RuntimeError with the bytes needed and free when
  not one lane fits.
"""

import numpy as np
import pytest
import torch

from _torch_synth import one_torch_thread  # noqa: F401 (autouse)
import saigegds_tpu_torch as sgt
from saigegds_tpu.io.gds_write import write_seqarray_gds
from saigegds_tpu_torch.models import fit_device
from saigegds_tpu_torch.ops.grm import GRMOperator
from saigegds_tpu_torch.ops.packed_grm import Packed2GRM, build_packed2_grm

RTOL_DEV = 1e-8
RTOL_GROUP = 1e-10
P, N, M = 3, 400, 150
TOL, TOL_PCG = 0.02, 1e-5


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def _carry_packed(jg):
    """The JAX 2-bit operator as the port's, on the CPU."""
    full = np.concatenate([np.concatenate([np.asarray(t) for t in lf], axis=1)
                           for lf in jg.packed], axis=0)
    return Packed2GRM.from_arrays(full, jg.af, jg.inv, jg.diag, jg.miss_var,
                                  jg.miss_samp, jg.miss_pad,
                                  n_samples=jg.n_samples, device="cpu")


@pytest.fixture(scope="module")
def small():
    """P binary and quantitative lanes over the n x m codes, the JAX
    package's two operators and the port's carried across."""
    from saigegds_tpu.models.glm import glm_binomial
    from saigegds_tpu.ops.grm import build_grm as jdense
    from saigegds_tpu.ops.packed_grm import build_packed2_grm as jpacked
    rng = np.random.default_rng(25)
    codes = rng.binomial(2, rng.uniform(0.1, 0.5, size=(M, 1)),
                         size=(M, N)).astype(np.int8)
    codes[rng.random(codes.shape) < 0.01] = 3
    X = np.column_stack([np.ones(N), rng.normal(size=(N, 2))])
    U = rng.choice([-1.0, 1.0], size=(N, 40))
    g = np.where(codes == 3, 0, codes).T @ rng.normal(size=M) * 0.12
    Y, E = [], []
    for p in range(5):
        eta = X @ (rng.normal(size=3) * 0.4) - 0.5 - 0.3 * p + g
        y = (rng.random(N) < 1 / (1 + np.exp(-eta))).astype(np.float64)
        Y.append(y)
        E.append(glm_binomial(X, y).linear_predictors)
    Yq = np.stack([X @ (rng.normal(size=3) * 0.4) + g + rng.normal(size=N)
                   for _ in range(P)])
    tq = np.stack([np.var(Yq[p], ddof=1) * np.array([0.5, 0.5])
                   for p in range(P)])
    jp, jd = jpacked(codes), jdense(codes)
    ops = {
        "packed": (jp, _carry_packed(jp)),
        "dense": (jd, GRMOperator.from_arrays(np.asarray(jd.std_geno),
                                              np.asarray(jd.diag),
                                              device="cpu")),
    }
    return dict(codes=codes, ops=ops, X=X, U=U, Y=np.stack(Y),
                E=np.stack(E), Yq=Yq, tq=tq, tb=np.tile([1.0, 0.5], (5, 1)))


def _assert_fits(got, want, rtol):
    for k in ("tau", "coefficients", "mu", "cov"):
        w = np.asarray(getattr(want, k))
        g = getattr(got, k).numpy()
        assert g.shape == w.shape, k
        scale = np.maximum(np.abs(w), 1e-12)
        assert np.all(np.abs(g - w) <= rtol * scale), k
    for k in ("iterations", "converged", "trace_capped"):
        g, w = getattr(got, k).numpy(), np.asarray(getattr(want, k))
        assert g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, k)


def _jax_fit(name, jop, s, lanes, **kw):
    import jax.numpy as jnp
    import saigegds_tpu
    fn = getattr(saigegds_tpu, name)
    a = jnp.asarray
    multi = name.endswith("_multi")
    pick = (lambda v: a(v[:lanes])) if multi else (lambda v: a(v[0]))
    if "binary" in name:
        return fn(jop, pick(s["Y"]), a(s["X"]), pick(s["tb"]), pick(s["E"]),
                  a(s["U"]), TOL, TOL_PCG, **kw)
    return fn(jop, pick(s["Yq"]), a(s["X"]), pick(s["tq"]), a(s["U"]), TOL,
              TOL_PCG, **kw)


def _port_fit(name, op, s, lanes, **kw):
    fn = getattr(sgt, name)
    multi = name.endswith("_multi")
    pick = (lambda v: _t(v[:lanes])) if multi else (lambda v: _t(v[0]))
    if "binary" in name:
        return fn(op, pick(s["Y"]), _t(s["X"]), pick(s["tb"]), pick(s["E"]),
                  _t(s["U"]), TOL, TOL_PCG, **kw)
    return fn(op, pick(s["Yq"]), _t(s["X"]), pick(s["tq"]), _t(s["U"]), TOL,
              TOL_PCG, **kw)


FITTERS = ["fit_glmm_binary_device", "fit_glmm_binary_device_multi",
           "fit_glmm_quant_device", "fit_glmm_quant_device_multi"]


@pytest.mark.parametrize("store", ["packed", "dense"])
@pytest.mark.parametrize("name", FITTERS)
def test_public_fitter_matches_jax(small, name, store):
    jop, op = small["ops"][store]
    want = _jax_fit(name, jop, small, P)
    got = _port_fit(name, op, small, P)
    _assert_fits(got, want, RTOL_DEV)
    assert got.pcg_iterations > 0
    assert got.lane_groups == (P if name.endswith("_multi") else 1,)


@pytest.mark.parametrize("trait", ["binary", "quant"])
def test_capped_trace_matches_jax(small, trait):
    """A pool of 12 probes and an unreachable CV cutoff: every trace
    escalates to the pool's end and is capped, as in the JAX package."""
    s = dict(small, U=small["U"][:, :12])
    jop, op = small["ops"]["packed"]
    name = f"fit_glmm_{trait}_device"
    kw = dict(nrun=10, trace_cv_cutoff=1e-12)
    want = _jax_fit(name, jop, s, 1, **kw)
    got = _port_fit(name, op, s, 1, **kw)
    assert bool(got.trace_capped)
    _assert_fits(got, want, RTOL_DEV)
    loose = _port_fit(name, op, s, 1, nrun=10, trace_cv_cutoff=1e9)
    assert not bool(loose.trace_capped)


def test_blowup_retry_matches_jax():
    """A degenerate tiny problem from an absurd tau_G: max(tau) passes
    1 / tol^2, so the iteration retries with tau_G halved (the JAX
    package's ``test_device_fit_tau_retry_on_blowup``); the port follows
    the JAX fit through it."""
    import jax.numpy as jnp
    from saigegds_tpu import fit_glmm_binary_device as jfit
    from saigegds_tpu.ops.grm import build_grm as jdense
    rng = np.random.default_rng(0)
    n = 64
    codes = rng.integers(0, 3, size=(16, n)).astype(np.int8)
    jop = jdense(codes)
    op = GRMOperator.from_arrays(np.asarray(jop.std_geno),
                                 np.asarray(jop.diag), device="cpu")
    X = np.ones((n, 1))
    y = (rng.random(n) < 0.5).astype(np.float64)
    eta = np.full(n, np.log(y.mean() / (1 - y.mean())))
    U = rng.choice([-1.0, 1.0], size=(n, 30))
    want = jfit(jop, jnp.asarray(y), jnp.asarray(X), jnp.asarray([1.0, 1e7]),
                jnp.asarray(eta), jnp.asarray(U), TOL, TOL_PCG)
    got = sgt.fit_glmm_binary_device(op, _t(y), _t(X), _t([1.0, 1e7]),
                                     _t(eta), _t(U), TOL, TOL_PCG)
    tau = got.tau.numpy()
    assert np.all(np.isfinite(tau)) and np.all(tau >= 0.0)
    assert tau[1] < 1.0 / TOL ** 2
    _assert_fits(got, want, RTOL_DEV)


def test_one_lane_fitters_reject(small):
    _, op = small["ops"]["packed"]
    s = small
    args = (op, _t(s["Y"][0]), _t(s["X"]), _t(s["tb"][0]), _t(s["E"][0]),
            _t(s["U"]), TOL, TOL_PCG)
    with pytest.raises(NotImplementedError, match="mixed"):
        sgt.fit_glmm_binary_device(*args, pcg="mixed")
    with pytest.raises(ValueError, match="pcg"):
        sgt.fit_glmm_binary_device(*args, pcg="fast")
    with pytest.raises(ValueError, match="float64"):
        sgt.fit_glmm_quant_device(op, _t(s["Yq"][0]).float(), _t(s["X"]),
                                  _t(s["tq"][0]), _t(s["U"]), TOL, TOL_PCG)
    with pytest.raises(TypeError, match="torch.Tensor"):
        sgt.fit_glmm_quant_device_multi(op, s["Yq"], _t(s["X"]),
                                        _t(s["tq"]), _t(s["U"]), TOL,
                                        TOL_PCG)


# ---------------------------------------------------------------------------
# lanes in groups


class _Spy:
    """An operator that records the columns of every product it takes."""

    def __init__(self, op):
        self.op, self.diag, self.device = op, op.diag, op.device
        self.n_samples, self.n_variants = op.n_samples, op.n_variants
        self.inputs = []

    def matvec(self, b):
        self.inputs.append(b.clone())
        return self.op.matvec(b)

    def products_of(self, cols) -> int:
        return sum(b.shape == cols.shape and bool(torch.equal(b, cols))
                   for b in self.inputs)


def _force_groups(monkeypatch, most):
    """The group rule replaced by groups of at most ``most`` lanes; the
    calls' lanes and reckoned columns are recorded."""
    calls = []

    def rule(P_, n, K, cols, *a, **k):
        calls.append((P_, cols))
        return fit_device._balanced(P_, most)

    monkeypatch.setattr(fit_device, "_lane_groups", rule)
    return calls


def _grouped_runs(small, monkeypatch, kind):
    """(one group, [(most, run)] for groups of 1 and 2 lanes, spies) of
    the ``kind`` fit over the 2-bit operator."""
    s = small
    _, base = s["ops"]["packed"]

    def run(spy):
        if kind == "binary":
            return sgt.fit_glmm_binary_device_multi(
                spy, _t(s["Y"]), _t(s["X"]), _t(s["tb"]), _t(s["E"]),
                _t(s["U"]), TOL, TOL_PCG)
        if kind == "quant":
            return sgt.fit_glmm_quant_device_multi(
                spy, _t(s["Yq"]), _t(s["X"]), _t(s["tq"]), _t(s["U"]), TOL,
                TOL_PCG)
        # one design per lane: the covariates and two dosages of its own
        rng = np.random.default_rng(9)
        Xs = np.stack([np.column_stack([s["X"], rng.binomial(2, 0.3,
                                                             (N, 2))])
                       for _ in range(P)])
        from saigegds_tpu_torch.models.glm import glm_binomial
        y = s["Y"][1]
        E = np.stack([glm_binomial(X, y).linear_predictors for X in Xs])
        return sgt.fit_glmm_binary_device_multi(
            spy, _t(np.tile(y, (P, 1))), _t(Xs), _t(s["tb"][:P]), _t(E),
            _t(s["U"]), TOL, TOL_PCG)

    one_spy = _Spy(base)
    one = run(one_spy)
    out = []
    for most in (1, 2):
        _force_groups(monkeypatch, most)
        spy = _Spy(base)
        out.append((most, run(spy), spy))
    return one, one_spy, out


@pytest.mark.parametrize("kind", ["binary", "quant", "per_lane_design"])
def test_groups_equal_one_group(small, monkeypatch, kind):
    one, one_spy, runs = _grouped_runs(small, monkeypatch, kind)
    lanes = len(one.tau)
    assert one.lane_groups == (lanes,)
    U = _t(small["U"])
    for most, got, spy in runs:
        assert got.lane_groups == tuple(
            g.stop - g.start for g in fit_device._balanced(lanes, most))
        for k in ("tau", "coefficients", "eta", "mu", "cov"):
            np.testing.assert_allclose(getattr(got, k).numpy(),
                                       getattr(one, k).numpy(),
                                       rtol=RTOL_GROUP, atol=1e-14,
                                       err_msg=f"{k}, groups of {most}")
        for k in ("iterations", "converged", "trace_capped"):
            np.testing.assert_array_equal(getattr(got, k).numpy(),
                                          getattr(one, k).numpy(), k)
        # the probe pool is shared: GRM @ U[:, :nrun] once per call, and
        # each escalation block of 10 probes at most once
        assert spy.products_of(U[:, :30]) == 1
        for r in range(30, U.shape[1], 10):
            assert spy.products_of(U[:, r:r + 10]) == \
                one_spy.products_of(U[:, r:r + 10]) <= 1
        assert got.pcg_iterations >= one.pcg_iterations
    # some trace escalated past nrun (the CV cutoff is hard to reach at
    # n = 400), so the shared pool had columns to append across groups
    assert one_spy.products_of(U[:, 30:40]) == 1 and one.trace_capped.any()


@pytest.fixture(scope="module")
def gds_data(tmp_path_factory):
    """A GDS of N_FIT samples x M_FIT variants, three binary phenotypes of
    one polygenic liability and two covariates."""
    rng = np.random.default_rng(33)
    n, m = 500, 300
    af = rng.uniform(0.1, 0.5, size=(m, 1))
    codes = rng.binomial(2, af, size=(m, n)).astype(np.int8)
    beta = rng.normal(size=m) * np.sqrt(0.8 / m) \
        / np.sqrt(2 * af[:, 0] * (1 - af[:, 0]))
    X = rng.normal(size=(n, 2))
    g = codes.T @ beta
    cols = {"sample.id": np.arange(1, n + 1), "x1": X[:, 0], "x2": X[:, 1]}
    for i, c in enumerate((-0.5, -1.0, -1.5)):
        eta = X @ np.array([0.3, -0.2]) + c + g
        cols[f"y{i}"] = (rng.random(n) < 1 / (1 + np.exp(-eta))) * 1.0
    codes[rng.random(codes.shape) < 0.005] = 3
    path = str(tmp_path_factory.mktemp("torch_device_fit") / "fit.gds")
    write_seqarray_gds(path, codes)
    return path, cols


def test_phewas_fit_in_groups(gds_data, monkeypatch):
    """``fit_null_glmm_multi`` with the AI-REML fit and the variance
    ratios in groups of one lane equals the one-group fit."""
    path, cols = gds_data
    formulas = [f"y{i} ~ x1 + x2" for i in range(3)]

    def fit():
        inst = {}
        ms = sgt.fit_null_glmm_multi(formulas, cols, path, instrument=inst,
                                     device="cpu")
        return ms, inst

    one, inst1 = fit()
    assert inst1["lane_groups"] == [3] and inst1["var_ratio_groups"] == [3]
    calls = _force_groups(monkeypatch, 1)
    got, inst = fit()
    # the AI-REML fit (1 + nrun columns a lane), the variance ratios (30
    # markers and the one column more they are reckoned at)
    assert calls == [(3, 31), (3, 31)]
    assert inst["lane_groups"] == [1, 1, 1]
    assert inst["var_ratio_groups"] == [1, 1, 1]
    assert inst["outer_iterations"] == inst1["outer_iterations"]
    for p, (a, b) in enumerate(zip(got, one)):
        assert a.converged == b.converged
        for k in ("tau", "coefficients", "fitted_values"):
            np.testing.assert_allclose(getattr(a, k), getattr(b, k),
                                       rtol=RTOL_GROUP, atol=1e-14,
                                       err_msg=k)
        np.testing.assert_array_equal(a.var_ratio["id"], b.var_ratio["id"])
        np.testing.assert_allclose(a.var_ratio["ratio"], b.var_ratio["ratio"],
                                   rtol=RTOL_GROUP)
        assert [e.get("id") for e in a.fit_log] == \
            [e.get("id") for e in b.fit_log]
        assert {e["phenotype"] for e in a.fit_log} == {p}


@pytest.mark.cuda
def test_phewas_lanes_stay_on_the_host(gds_data, monkeypatch):
    """On a card ``fit_null_glmm_multi`` hands the fitter the lanes' [P, N]
    phenotypes and starts on the host (each group's go to the card) and
    gets the fitted values back there; the models equal the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the GRM kernels have no CPU mode)")
    path, cols = gds_data
    formulas = [f"y{i} ~ x1 + x2" for i in range(3)]
    seen = []
    real = fit_device._binary_multi

    def spy(op, Y, X, tau_init, eta_init, U, *a, **k):
        seen.append((Y.device.type, eta_init.device.type, X.device.type,
                     U.device.type))
        fit = real(op, Y, X, tau_init, eta_init, U, *a, **k)
        seen.append((fit.eta.device.type, fit.mu.device.type))
        return fit

    monkeypatch.setattr(fit_device, "_binary_multi", spy)
    got = sgt.fit_null_glmm_multi(formulas, cols, path, device="cuda")
    assert seen == [("cpu", "cpu", "cuda", "cuda"), ("cpu", "cpu")]
    want = sgt.fit_null_glmm_multi(formulas, cols, path, device="cpu")
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.tau, b.tau, rtol=RTOL_DEV)


def test_gxg_refits_in_groups(gds_data, monkeypatch):
    """GxG's batched full refits (one design per pair) in groups of 1 and
    2 lanes equal one group."""
    path, cols = gds_data
    pairs = {"snp1": [11, 40, 75], "snp2": [12, 90, 150]}

    def run():
        return sgt.gxg_spa("y0 ~ x1 + x2", cols, path, pairs, pair_batch=3,
                           device="cpu")

    one = run()
    for most in (1, 2):
        calls = _force_groups(monkeypatch, most)
        got = run()
        assert calls                  # the refits went through the rule
        for c in ("tau_G", "beta", "SE", "pval"):
            np.testing.assert_allclose(got[c], one[c], rtol=RTOL_GROUP,
                                       err_msg=c)
    assert np.all(one["tau_G"] > 0)


# ---------------------------------------------------------------------------
# the group rule


def test_balanced_groups():
    sizes = lambda P_, most: [g.stop - g.start
                              for g in fit_device._balanced(P_, most)]
    assert sizes(5, 2) == [2, 2, 1]
    assert sizes(7, 4) == [4, 3]
    assert sizes(24, 22) == [12, 12]
    assert sizes(6, 6) == [6]
    assert sizes(1, 1) == [1]
    for P_ in range(1, 30):
        for most in range(1, P_ + 1):
            gs = fit_device._balanced(P_, most)
            s = [g.stop - g.start for g in gs]
            assert sum(s) == P_ and max(s) <= most
            assert len(gs) == -(-P_ // most)
            assert gs[0].start == 0 and all(
                a.stop == b.start for a, b in zip(gs, gs[1:]))


def test_lane_groups_cpu_one_group():
    assert fit_device._lane_groups(1000, 430_000, 4, 35, "cpu") == \
        [slice(0, 1000)]


def test_lane_groups_from_free_memory(monkeypatch):
    """On a CUDA device the free memory (less the margin and the padding)
    over the lane's bytes sets the group size."""
    n, K, cols = 430_000, 4, 31
    lane = fit_device._lane_bytes(n, K, cols)
    share = fit_device._PLAN_SHARE
    free_for = lambda budget: fit_device._MARGIN_BYTES + int(
        (budget + n * fit_device._PAD_BYTES) / share) + 2
    free = [free_for(5 * lane)]
    assert fit_device._group_budget(free[0], n) in range(5 * lane, 6 * lane)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (free[0], 80 << 30))
    rule = lambda P_: [g.stop - g.start for g in fit_device._lane_groups(
        P_, n, K, cols, "cuda:0")]
    assert rule(5) == [5]
    assert rule(6) == [3, 3]
    assert rule(12) == [4, 4, 4]
    free[0] = free_for(lane) - 10
    budget = fit_device._group_budget(free[0], n)
    assert 0 < budget < lane
    with pytest.raises(RuntimeError, match=f"needs {lane} bytes .* "
                                           f"{budget} are free"):
        rule(1)
    # groups planned to 92% and to all of the free memory failed on an
    # H100 (the allocator's split blocks); the rule plans two thirds of it
    assert fit_device._group_budget(80 << 30, n) < 0.67 * (80 << 30)


def test_lane_bytes_reckoning():
    """About 3.4 GB a binary lane at N = 430,000 (K = 4, 31 columns: the
    trace's probes and APY), ~256 B per sample and column; a
    variance-ratio lane is reckoned at its 30 markers and one column
    more."""
    lane = fit_device._lane_bytes(430_000, 4, 31)
    assert 3.4e9 < lane < 3.6e9
    assert fit_device._SOLVE_COL_BYTES == 256
    from saigegds_tpu_torch.models.fitnull import _var_ratio_cols
    assert _var_ratio_cols(sgt.NullModelConfig(), 4) == 31
    assert _var_ratio_cols(sgt.NullModelConfig(num_marker=5), 12) == 13
