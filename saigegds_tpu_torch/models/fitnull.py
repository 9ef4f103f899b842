"""Null GLMM fitting for a binary trait: penalized IRLS + AI-REML with PCG
solves on a torch device.

The counterpart of ``saigegds_tpu/models/fitnull.py`` (reference R driver
``seqFitNullGLMM_SPA`` R/saige_main.r:223-658; C engines
src/saige_fitnull.cpp:736-1248 and 1255-1474):

* the GRM is never materialised -- every ``Sigma^{-1} x`` runs a batched
  Jacobi-PCG (``ops/pcg.py``) on ``device`` whose products go through the
  2-bit operator (``ops/packed_grm.py``, kernels B1 and B2 on a card);
* the outer AI-REML / IRLS scalar algebra stays in host numpy float64, as
  in the JAX package, so the two agree to solver precision;
* Hutchinson trace probes and the variance-ratio marker order replay R's
  RNG streams exactly (``utils/rrandom.py``).

``data`` is any mapping from column name to a 1-D array (a dict of numpy
arrays, or a pandas DataFrame where pandas is installed); this module
never imports pandas.
"""

from __future__ import annotations

import ast
import math
import time
import warnings
from dataclasses import dataclass
from itertools import combinations

import numpy as np
import torch

from ..config import NullModelConfig
from ..io.seqarray import SeqData
from ..ops._cuda import check_device
from ..ops.grm import build_grm
from ..ops.packed_grm import build_packed2_grm, build_packed2_grm_streamed
from ..ops.pcg import pcg_solve
from ..utils.rrandom import RRandom
from .glm import GlmFit, ObjNoK, glm_binomial, obj_nok_binary, qr_transform
from .nullmodel import NullModel


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to the PyTorch port "
                               f"yet (ROADMAP Queue A, {item})")


# ---------------------------------------------------------------------------
# family callbacks (R's binomial()$linkinv, mu.eta, variance)


class _Binomial:
    name = "binomial"

    @staticmethod
    def linkinv(eta):
        return 1.0 / (1.0 + np.exp(-eta))

    @staticmethod
    def mu_eta(eta):
        m = 1.0 / (1.0 + np.exp(-eta))
        # R's make.link("logit")$mu.eta floors at .Machine$double.eps
        return np.maximum(m * (1.0 - m), np.finfo(float).eps)

    @staticmethod
    def variance(mu):
        return mu * (1.0 - mu)


# ---------------------------------------------------------------------------
# device helpers (numpy in, numpy out; the work runs on the GRM's device)


class _FitGRM:
    """One fit's handle on the GRM operator ``op`` (a
    :class:`~..ops.packed_grm.Packed2GRM` or the dense oracle): the fit's
    solves and products go through it, and it counts this fit's PCG
    iterations (the operator counts only its products)."""

    def __init__(self, op):
        self.op = op
        self.n_samples = op.n_samples
        self.pcg_iterations = 0


def _pcg(grm: _FitGRM, w, tau, B, tol, maxiter):
    """Solve Sigma X = B on the GRM's device; B [N, R] numpy -> numpy."""
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64),
                                  device=grm.op.device)
    X, iters, conv = pcg_solve(grm.op, t(w), tau, t(B), tol, maxiter)
    grm.pcg_iterations += int(iters.max()) if iters.numel() else 0
    if not bool(conv.all()):
        print("PCG does not converge (may need to increase 'maxiter').")
    return X.cpu().numpy()


def _grm_mv(grm: _FitGRM, b):
    return grm.op.matvec(torch.as_tensor(np.asarray(b, np.float64),
                                         device=grm.op.device)).cpu().numpy()


def _mat_inv(m):
    """inv_sympd with inv() fallback (src/saige_fitnull.cpp:721-733)."""
    ms = np.triu(m) + np.triu(m, 1).T  # symmatu
    try:
        c = np.linalg.cholesky(ms)
        inv_c = np.linalg.inv(c)
        return inv_c.T @ inv_c
    except np.linalg.LinAlgError:
        print("Warning: matrix is singular or not positive definite, "
              "using general inverse instead.")
        return np.linalg.inv(ms)


def _calc_cv(x):
    """stddev / (mean * n) -- the reference's calcCV
    (src/saige_fitnull.cpp:618)."""
    x = np.asarray(x, float)
    return np.std(x, ddof=1) / (np.mean(x) * len(x))


# ---------------------------------------------------------------------------
# inner IRLS (get_coeff)


@dataclass
class _CoeffState:
    Y: np.ndarray
    mu: np.ndarray
    alpha: np.ndarray
    eta: np.ndarray
    W: np.ndarray
    cov: np.ndarray
    Sigma_iY: np.ndarray
    Sigma_iX: np.ndarray


def _get_coeff(grm, y, X, tau, family, alpha0, eta0, offset, maxiter_pcg,
               maxiter, tol_pcg) -> _CoeffState:
    """Inner IRLS (src/saige_fitnull.cpp:766-813): iterate working response
    and coefficients to rel-tol 0.1, every solve via one batched PCG."""
    tol_coef = 0.1
    mu = family.linkinv(eta0)
    mu_eta = family.mu_eta(eta0)
    Y = eta0 - offset + (y - mu) / mu_eta
    W = (mu_eta * mu_eta) / family.variance(mu)

    a0 = alpha0.copy()
    st = None
    for _ in range(maxiter):
        # one batched PCG for [Y | X]  (reference solves them sequentially)
        B = np.column_stack([Y, X])
        sol = _pcg(grm, W, tau, B, tol_pcg, maxiter_pcg)
        Sigma_iY = sol[:, 0]
        Sigma_iX = sol[:, 1:]
        cov = _mat_inv(X.T @ Sigma_iX)
        alpha = cov @ (Sigma_iX.T @ Y)
        eta = Y - tau[0] * (Sigma_iY - Sigma_iX @ alpha) / W + offset

        mu = family.linkinv(eta)
        mu_eta = family.mu_eta(eta)
        Y = eta - offset + (y - mu) / mu_eta
        W = (mu_eta * mu_eta) / family.variance(mu)

        st = _CoeffState(Y=Y, mu=mu, alpha=alpha, eta=eta, W=W, cov=cov,
                         Sigma_iY=Sigma_iY, Sigma_iX=Sigma_iX)
        if np.max(np.abs(alpha - a0) / (np.abs(alpha) + np.abs(a0)
                                        + tol_coef)) < tol_coef:
            break
        a0 = alpha
    return st


# ---------------------------------------------------------------------------
# Hutchinson trace estimator


def _get_trace(grm, st: _CoeffState, tau, cfg: NullModelConfig) -> float:
    """trace(P*GRM) via Rademacher probes.

    Probes replay R's ``set.seed(seed); rbinom(n,1,0.5)`` stream and the
    +10 escalation continues the same stream (src/saige_fitnull.cpp:627-718).
    """
    rng = RRandom(cfg.seed)
    SiX, cov = st.Sigma_iX, st.cov
    n = grm.n_samples
    buf = []
    n_runs = cfg.nrun
    while True:
        need = n_runs - len(buf)
        U = np.stack([rng.rademacher(n).astype(np.float64)
                      for _ in range(need)], axis=1)  # [N, need]
        SiU = _pcg(grm, st.W, tau, U, cfg.tol_pcg, cfg.maxiter_pcg)
        PU = SiU - SiX @ (cov @ (SiX.T @ U))
        AU = _grm_mv(grm, U)
        buf.extend(np.sum(AU * PU, axis=0).tolist())
        cv = _calc_cv(buf)
        if cv <= cfg.trace_cv_cutoff:
            break
        if cfg.nrun_max and n_runs + 10 > cfg.nrun_max:
            # the reference escalates unboundedly (src/saige_fitnull.cpp:
            # 644-663); an optional cap trades trace variance for progress
            warnings.warn(
                f"trace CV {cv:.3g} > {cfg.trace_cv_cutoff:.3g} at the "
                f"nrun_max={cfg.nrun_max} probe cap; proceeding")
            break
        n_runs += 10
    return float(np.mean(buf))


# ---------------------------------------------------------------------------
# AI-REML update


def _get_ai_score_binary(grm, st, tau, cfg):
    SiX, cov, Y = st.Sigma_iX, st.cov, st.Y
    PY = st.Sigma_iY - SiX @ (cov @ (SiX.T @ Y))
    APY = _grm_mv(grm, PY)
    YPAPY = float(PY @ APY)
    trace = _get_trace(grm, st, tau, cfg)
    PAPY_1 = _pcg(grm, st.W, tau, APY[:, None], cfg.tol_pcg,
                  cfg.maxiter_pcg)[:, 0]
    PAPY = PAPY_1 - SiX @ (cov @ (SiX.T @ PAPY_1))
    AI = float(APY @ PAPY)
    return YPAPY, trace, AI


def _fit_tau_binary(grm, st, tau0, cfg):
    """fitglmmaiRPCG (src/saige_fitnull.cpp:860-890)."""
    YPAPY, trace, AI = _get_ai_score_binary(grm, st, tau0, cfg)
    score = YPAPY - trace
    Dtau = score / AI
    tau = tau0.copy()
    tau[1] = tau0[1] + Dtau
    tau[tau < cfg.tol] = 0.0
    step = 1.0
    while tau[1] < 0.0:
        step *= 0.5
        tau[1] = tau0[1] + step * Dtau
    tau[tau < cfg.tol] = 0.0
    return tau


# ---------------------------------------------------------------------------
# outer driver (saige_fit_AI_PCG_binary)


@dataclass
class GlmmFit:
    coefficients: np.ndarray
    tau: np.ndarray
    linear_predictors: np.ndarray
    fitted_values: np.ndarray
    residuals: np.ndarray
    cov: np.ndarray
    converged: bool
    iterations: int = 0       # outer AI-REML iterations run


def fit_ai_pcg(grm: _FitGRM, fit0: GlmFit, X: np.ndarray, tau: np.ndarray,
               cfg: NullModelConfig, verbose=False) -> GlmmFit:
    """The saige_fit_AI_PCG_binary outer loop
    (src/saige_fitnull.cpp:948-1099)."""
    family = _Binomial()
    y = fit0.y.astype(np.float64)
    n = len(y)
    offset = np.zeros(n)
    tol_inv_2 = 1.0 / (cfg.tol * cfg.tol)

    eta = eta0 = fit0.linear_predictors.copy()
    alpha0 = fit0.coefficients.copy()
    alpha = alpha0.copy()
    tau = np.asarray(tau, np.float64).copy()
    tau0 = tau.copy()

    st = _get_coeff(grm, y, X, tau, family, alpha0, eta0, offset,
                    cfg.maxiter_pcg, cfg.maxiter, cfg.tol_pcg)
    # first moment-based update of tau
    YPAPY, trace, _ = _get_ai_score_binary(grm, st, tau, cfg)
    tau[1] = max(0.0, tau0[1] + tau0[1] ** 2 * (YPAPY - trace) / n)

    it = 0
    brk = False
    for it in range(1, cfg.maxiter + 1):
        alpha0 = st.alpha
        if verbose:
            print(f"    Iteration {it}: tau = {tau}, coeff = {alpha}")
        tau0 = tau.copy()
        eta0 = eta.copy()

        for itry in range(1, 12):
            st = _get_coeff(grm, y, X, tau0, family, alpha0, eta0, offset,
                            cfg.maxiter_pcg, cfg.maxiter, cfg.tol_pcg)
            tau = _fit_tau_binary(grm, st, tau0, cfg)
            if np.max(tau) > tol_inv_2:
                if itry <= 10:
                    tau0[1] *= 0.5
                    continue
                raise OverflowError(
                    "Large variance estimate observed in the iterations, "
                    "model not converged!")
            break

        alpha = st.alpha
        eta = st.eta
        brk = tau[1] == 0 or bool(
            np.max(np.abs(tau - tau0) / (np.abs(tau) + np.abs(tau0)
                                         + cfg.tol)) < cfg.tol)
        if brk:
            break

    st = _get_coeff(grm, y, X, tau, family, alpha0, eta0, offset,
                    cfg.maxiter_pcg, cfg.maxiter, cfg.tol_pcg)
    # converged iff the tau loop broke on its tolerance (the reference's
    # `iter <= maxiter` works because its C loop leaves iter = maxiter+1
    # on exhaustion; Python's range leaves it = maxiter)
    return GlmmFit(coefficients=st.alpha, tau=tau, linear_predictors=st.eta,
                   fitted_values=st.mu, residuals=y - st.mu, cov=st.cov,
                   converged=bool(brk), iterations=it)


# ---------------------------------------------------------------------------
# variance ratio (saige_calc_var_ratio_binary)


def calc_var_ratio(grm: _FitGRM, codes, fit0: GlmFit, glmm: GlmmFit,
                   nok: ObjNoK,
                   cfg: NullModelConfig, marker_order: np.ndarray,
                   verbose=False):
    """Estimate var1/var2 on random markers with MAC>20, adaptively adding
    10 until CV <= ratioCVcutoff (src/saige_fitnull.cpp:1255-1474).

    ``codes`` gives int8 genotype rows by 0-based GRM variant index: an
    [M, N] array, or a :class:`_MarkerRows` cache for a streamed fit."""
    family = _Binomial()
    eta = fit0.linear_predictors
    mu = fit0.fitted_values
    mu_eta = family.mu_eta(eta)
    W = (mu_eta * mu_eta) / family.variance(mu)
    tau = glmm.tau
    X1 = nok.X1
    Sigma_iX = _pcg(grm, W, tau, X1, cfg.tol_pcg, cfg.maxiter_pcg)
    xsx_inv = _mat_inv(X1.T @ Sigma_iX)

    rows = dict(id=[], maf=[], mac=[], var1=[], var2=[], ratio=[])
    num_marker = cfg.num_marker
    snp_pos = 0
    num_tested = 0
    n_rand = len(marker_order)
    while snp_pos < n_rand:
        # gather the next chunk of markers passing the MAC filter
        pending = []
        while num_tested + len(pending) < num_marker and snp_pos < n_rand:
            i_snp = int(marker_order[snp_pos])  # 1-based
            snp_pos += 1
            g = codes[i_snp - 1].astype(np.float64)
            isnan = g >= 3
            num = int((~isnan).sum())
            if num == 0:          # all-missing marker (explicit variant_id
                continue          # panels bypass the missing-rate filter)
            ac = float(np.where(isnan, 0, g).sum())
            af = ac / (2 * num)
            g = np.where(isnan, ac / num, g)  # mean impute
            if af > 0.5:
                g = 2.0 - g
                ac = 2 * num - ac
                af = 1 - af
            if ac <= 20:  # suggested by the paper
                continue
            pending.append((i_snp, af, ac, g))
        if pending:
            G0 = np.stack([p[3] for p in pending], axis=1)   # [N, B]
            G = G0 - nok.XXVX_inv @ (nok.XV @ G0)
            SiG = _pcg(grm, W, tau, G, cfg.tol_pcg, cfg.maxiter_pcg)
            adj = Sigma_iX @ (xsx_inv @ (X1.T @ SiG))
            for k, (i_snp, af, ac, _) in enumerate(pending):
                var1 = (float(G[:, k] @ SiG[:, k]) -
                        float(G[:, k] @ adj[:, k])) / ac
                gn = G[:, k] / math.sqrt(ac)
                var2 = float(np.sum(mu * (1 - mu) * gn * gn))
                rows["id"].append(i_snp)
                rows["maf"].append(af)
                rows["mac"].append(ac)
                rows["var1"].append(var1)
                rows["var2"].append(var2)
                rows["ratio"].append(var1 / var2)
                num_tested += 1
                if verbose:
                    print(f"    marker {i_snp}: maf {af:.4g}, mac {ac:g}, "
                          f"ratio {var1 / var2:.6g}")
        if num_tested >= num_marker:
            cv = _calc_cv(rows["ratio"])
            if cv > cfg.ratio_cv_cutoff:
                num_marker += 10
            else:
                break
        elif snp_pos >= n_rand:
            break
    return rows


class _MarkerRows(dict):
    """Cached genotype rows for the variance-ratio markers (streamed fits).

    Keys are 0-based local indices into the GRM variant set; misses beyond
    the harvest cache fall back to random-access frame reads (``loader``)."""

    def __init__(self, cache_k: int, loader=None):
        super().__init__()
        self.cache_k = cache_k
        self.loader = loader

    def __missing__(self, key):
        if self.loader is not None:
            row = self.loader(key)
            self[key] = row
            return row
        raise RuntimeError(
            f"variance-ratio escalation needed marker row {key} beyond the "
            f"streamed cache of {self.cache_k}; refit with stream_geno=False "
            f"or a larger num_marker")


# ---------------------------------------------------------------------------
# formulas and the design matrix (R's model.matrix for the covariates)


def _split_top(s: str, sep: str):
    """Split ``s`` on single-char ``sep`` outside parentheses."""
    out, depth, cur = [], 0, []
    for ch in s:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == sep and depth == 0:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    out.append("".join(cur))
    return out


def _parse_formula(formula: str):
    """Parse an R-style formula into (response, term list).

    Supports additive terms, ``a:b`` interactions, ``a*b`` crossing
    (expanded to main effects + interactions, R's rule), and ``I(expr)``
    arithmetic terms -- the formula features `seqFitNullGLMM_SPA` hands to
    R's `model.matrix` (reference R/saige_main.r:345-352)."""
    lhs, rhs = formula.split("~")
    resp = lhs.strip()
    terms = []
    for t in _split_top(rhs, "+"):
        t = t.strip()
        if t in ("", "1"):
            continue
        comps = [c.strip() for c in _split_top(t, "*")]
        if len(comps) == 1:
            terms.append(t)
            continue
        # a*b*c -> all non-empty subsets, smaller interactions first
        for k in range(1, len(comps) + 1):
            for sub in combinations(comps, k):
                terms.append(":".join(sub))
    # dedupe, first appearance wins
    return resp, list(dict.fromkeys(terms))


def _term_vars(terms):
    """Base data columns referenced by a term list (for NA-dropping)."""
    names = []
    for t in terms:
        for c in _split_top(t, ":"):
            c = c.strip()
            if c.startswith("I(") and c.endswith(")"):
                tree = ast.parse(c[2:-1], mode="eval")
                called = {n.func.id for n in ast.walk(tree)
                          if isinstance(n, ast.Call)
                          and isinstance(n.func, ast.Name)}
                for node in ast.walk(tree):
                    if isinstance(node, ast.Name) and node.id not in called:
                        names.append(node.id)
            else:
                names.append(c)
    return list(dict.fromkeys(names))


_I_FUNCS = {"log": np.log, "log2": np.log2, "log10": np.log10,
            "exp": np.exp, "sqrt": np.sqrt, "abs": np.abs}


def _is_numeric(v: np.ndarray) -> bool:
    """pandas' is_numeric_dtype for a numpy column (bool counts)."""
    return v.dtype.kind in "biuf"


def _na_mask(v: np.ndarray) -> np.ndarray:
    """Rows that pandas' ``dropna`` drops: NaN, and None in object columns."""
    if v.dtype.kind in "fc":
        return np.isnan(v)
    if v.dtype.kind == "O":
        return np.array([x is None or (isinstance(x, float) and x != x)
                         for x in v], bool)
    return np.zeros(len(v), bool)


def _levels(col, v: np.ndarray) -> list:
    """Factor levels: a pandas categorical's own order, else sorted (the
    categories ``pd.get_dummies`` builds)."""
    cat = getattr(col, "cat", None)
    if cat is not None:
        return list(cat.categories)
    return sorted(set(v.tolist()))


def _component_cols(data: dict, levels: dict, c: str):
    """One formula component -> list of (name, float64 column)."""
    if c.startswith("I(") and c.endswith(")"):
        env = dict(_I_FUNCS)
        env.update({k: v.astype(np.float64) for k, v in data.items()
                    if _is_numeric(v)})
        val = eval(c[2:-1], {"__builtins__": {}}, env)  # noqa: S307
        return [(c, np.asarray(val, np.float64))]
    v = data[c]
    if c in levels:
        # pd.get_dummies(v, prefix=c, drop_first=True)
        return [(f"{c}_{lv}", (v == lv).astype(np.float64))
                for lv in levels[c][1:]]
    return [(c, v.astype(np.float64))]


def _model_matrix(data: dict, levels: dict, terms):
    n = len(next(iter(data.values())))
    cols = [np.ones(n)]
    names = ["(Intercept)"]
    for t in terms:
        comps = [c.strip() for c in _split_top(t, ":")]
        blocks = [_component_cols(data, levels, c) for c in comps]
        prod = blocks[0]
        for blk in blocks[1:]:
            prod = [(f"{na}:{nb}", va * vb) for na, va in prod
                    for nb, vb in blk]
        for nm, v in prod:
            cols.append(v)
            names.append(nm)
    return np.column_stack(cols), names


# ---------------------------------------------------------------------------
# top-level driver


def fit_null_glmm(formula: str, data, gdsfile,
                  config: NullModelConfig = NullModelConfig(),
                  model_savefn: str = "", verbose: bool = False,
                  mesh=None, variant_id=None, instrument=None, *,
                  device) -> NullModel:
    """Fit the null GLMM of a binary trait (the ``seqFitNullGLMM_SPA``
    equivalent) with the GRM and every PCG solve on ``device``.

    ``formula``: e.g. ``"y ~ x1 + x2"`` over columns of ``data``, a mapping
    from column name to a 1-D array that includes ``config.sample_col``
    (reference R/saige_main.r:223).  ``variant_id``: explicit GRM SNP panel
    -- replaces the maf/missing filter, like the reference's
    ``variant.id=`` (R/saige_main.r:314-323).  ``instrument``: optional
    dict that receives the wall seconds of ingest (``ingest_s``), AI-REML
    (``aireml_s``) and the variance ratio (``var_ratio_s``), the outer
    iterations, and the GRM products and PCG iterations run.
    """
    cfg = config
    dev = check_device(device)
    if cfg.trait_type == "quantitative":
        raise _not_ported("A quantitative-trait fit", "item 2")
    if cfg.trait_type != "binary":
        raise ValueError(f"Invalid trait type {cfg.trait_type!r}")
    if cfg.checkpoint:
        raise _not_ported("Fit checkpoints", "item 8")
    if cfg.var_ratio_mac_cat:
        raise _not_ported("MAC-categorized variance ratios", "item 8")
    if mesh is not None:
        raise _not_ported("A multi-device fit", "item 10")
    seq = gdsfile if isinstance(gdsfile, SeqData) else SeqData(gdsfile)
    resp, covs = _parse_formula(formula)

    t0 = time.perf_counter()
    prep = _prepare_fit(seq, data, cfg, resp, covs, variant_id, verbose,
                        formula, dev)
    grm = _FitGRM(prep["grm"])
    t1 = time.perf_counter()

    y_raw = prep["data"][resp].astype(np.float64)
    if set(np.unique(y_raw)) - {0.0, 1.0}:
        raise ValueError("binary trait must be coded 0/1")
    X_new = prep["X_new"]
    fit0 = glm_binomial(X_new, y_raw)
    nok = obj_nok_binary(X_new, y_raw)
    # initial tau: (1, 0.5) unless tau_init given (R/saige_main.r:489-495)
    tau = np.array([1.0, 0.5])
    ti = np.nan_to_num(np.asarray(cfg.tau_init, float))
    ti[ti < 0] = 0
    if ti[1] > 0:
        tau[1] = ti[1]
    glmm = fit_ai_pcg(grm, fit0, X_new, tau, cfg, verbose=verbose)
    t2 = time.perf_counter()

    vr = calc_var_ratio(grm, prep["codes"], fit0, glmm, nok, cfg,
                        prep["marker_order"], verbose=verbose)
    t3 = time.perf_counter()
    if instrument is not None:
        instrument.update(ingest_s=t1 - t0, aireml_s=t2 - t1,
                          var_ratio_s=t3 - t2,
                          outer_iterations=glmm.iterations,
                          matvecs=grm.op.matvecs,
                          pcg_iterations=grm.pcg_iterations)

    model = _assemble_model(cfg, glmm, vr, nok, prep["X_qrr"],
                            prep["X_names"], prep["x_transform"],
                            prep["variant_id"], prep["sample_id"],
                            len(y_raw))
    if model_savefn:
        model.save(model_savefn)
    return model


def _prepare_fit(seq: SeqData, data, cfg, resp: str, covs, variant_id,
                 verbose, formula_str, dev):
    """The fit preamble: sample alignment, variant filtering, GRM SNP
    down-sampling, covariate design + QR transform, and the GRM build on
    ``dev`` -- everything before the response enters (reference
    R/saige_main.r:303-420)."""
    # sample alignment (R/saige_main.r:303-313): complete cases of the
    # used columns, in the GDS file's sample order
    term_vars = _term_vars(covs)
    used = list(dict.fromkeys([cfg.sample_col, resp] + term_vars))
    cols = {c: np.asarray(data[c]) for c in used}
    na = np.zeros(len(cols[cfg.sample_col]), bool)
    for v in cols.values():
        na |= _na_mask(v)
    cols = {c: v[~na] for c, v in cols.items()}
    sid = cols[cfg.sample_col].astype(str)
    order = {s: i for i, s in enumerate(sid)}
    keep = [order[s] for s in seq.sample_id.astype(str) if s in order]
    cols = {c: v[keep] for c, v in cols.items()}
    if not keep:
        raise ValueError("No common sample.id between 'data' and the GDS file.")
    samp_mask = np.isin(seq.sample_id.astype(str),
                        cols[cfg.sample_col].astype(str))
    sample_id = seq.sample_id[samp_mask]
    keep_idx = None if samp_mask.all() else np.flatnonzero(samp_mask)

    def _samples(g):
        """The fit's samples of code rows ``g``, C-ordered.  (``g[:, mask]``
        comes out F-ordered, and making that contiguous is a transposing
        copy, far slower than the decode of the block.)"""
        return g if keep_idx is None else np.take(g, keep_idx, axis=-1)
    levels = {c: _levels(data[c], cols[c]) for c in term_vars
              if not _is_numeric(cols[c])
              or getattr(data[c], "cat", None) is not None}

    stream = cfg.stream_geno
    if stream == "auto":
        # stream when the host int8 matrix would top ~4 GB
        stream = seq.n_variants * seq.n_samples > 4 << 30
    impl = cfg.grm_impl
    if impl not in ("auto", "dense", "packed", "packed2", "packed2_split"):
        raise ValueError(f"grm_impl must be 'auto', 'dense', 'packed', "
                         f"'packed2' or 'packed2_split', got {impl!r}")
    # every packed form is the one 2-bit operator here (the JAX package's
    # bf16 store and split handle are the same algebra bit for bit)
    impl = "dense" if impl == "dense" else "packed2"
    streamed = impl == "packed2" and stream and seq.has_genotype()
    if streamed:
        codes = None
        if variant_id is None:
            # pass 1: streamed per-variant maf/missing for the filter
            maf = np.empty(seq.n_variants)
            miss = np.empty(seq.n_variants)
            for idx, blk in seq.iter_code_blocks(8192, streamed=True):
                blk = _samples(blk)
                valid = blk < 3
                n_valid = valid.sum(axis=1)
                ac = np.where(valid, blk, 0).sum(axis=1, dtype=np.int64)
                with np.errstate(invalid="ignore", divide="ignore"):
                    af = ac / (2.0 * n_valid)
                maf[idx] = np.minimum(af, 1 - af)
                miss[idx] = 1.0 - n_valid / blk.shape[1]
    else:
        # genotype codes for the selected samples: [M, N] int8, 3 = missing
        codes = _samples(_genotype_codes(seq))
        valid = codes < 3
        n_valid = valid.sum(axis=1)
        ac = np.where(valid, codes, 0).sum(axis=1, dtype=np.int64)
        with np.errstate(invalid="ignore", divide="ignore"):
            af = ac / (2.0 * n_valid)
        maf = np.minimum(af, 1 - af)
        miss = 1.0 - n_valid / codes.shape[1]

    if variant_id is not None:
        # explicit GRM panel: replaces the maf/missing filter
        # (R/saige_main.r:314-323 seqSetFilter(variant.id=))
        vmask = np.isin(seq.variant_id, np.asarray(variant_id))
        if not vmask.any():
            raise ValueError("variant_id matches no variants in the GDS file")
    else:
        # variant filters: maf >= maf, missing.rate <= missing.rate
        # (seqSetFilterCond, R/saige_main.r:319-320)
        vmask = np.isfinite(maf) & (maf >= cfg.maf) & \
            (miss <= cfg.missing_rate)
    variant_id = seq.variant_id[vmask]
    if codes is not None:
        codes = codes[vmask]
    n_filtered = int(vmask.sum())

    # random down-sample to max_num_snp (R/saige_main.r:328-333)
    if cfg.max_num_snp > 0 and n_filtered > cfg.max_num_snp:
        rng = RRandom(cfg.seed)
        sel = np.sort(rng.sample_int(n_filtered, cfg.max_num_snp) - 1)
        if codes is not None:
            codes = codes[sel]
        variant_id = variant_id[sel]
        selmask = np.zeros(n_filtered, bool)
        selmask[sel] = True
    else:
        selmask = np.ones(n_filtered, bool)

    n_samp = int(samp_mask.sum())
    n_var = len(variant_id)
    if verbose:
        print(f"Fit the null model: {formula_str} + var(GRM) on {dev}")
        print(f"    # of samples: {n_samp}\n    # of variants: {n_var}")

    # design matrix + QR transform (R/saige_main.r:356-387)
    X, X_names = _model_matrix(cols, levels, covs)
    x_transform = cfg.x_transform and X.shape[1] > 1
    if x_transform:
        X_new, X_qrr, keep_cols = qr_transform(X)
        if not keep_cols.all():   # collinear columns dropped: names follow
            X_names = [nm for nm, k in zip(X_names, keep_cols) if k]
    else:
        X_new, X_qrr = X, None

    # the variance-ratio marker order (1-based, seed-deterministic)
    marker_order = RRandom(cfg.seed).sample_int(n_var, n_var)
    if streamed:
        # pass 2: streamed build + harvest the rows the variance-ratio
        # estimator will touch first
        cache_k = min(n_var, max(600, cfg.num_marker * 20))
        want_rows = set(int(i) - 1 for i in marker_order[:cache_k])
        local_to_global = np.flatnonzero(vmask)[selmask]

        def _load_row(local_idx):
            row = seq.code_rows(local_to_global[local_idx:local_idx + 1])[0]
            return _samples(row)

        marker_rows = _MarkerRows(cache_k, loader=_load_row)
        full_sel = np.zeros(seq.n_variants, bool)
        full_sel[local_to_global] = True

        def blocks():
            local0 = 0
            for idx, blk in seq.iter_code_blocks(8192, streamed=True,
                                                 variant_mask=full_sel):
                blk = _samples(blk)
                for r in range(blk.shape[0]):
                    if local0 + r in want_rows:
                        marker_rows[local0 + r] = blk[r].copy()
                local0 += blk.shape[0]
                yield idx, blk

        grm = build_packed2_grm_streamed(blocks(), n_samp, n_var, device=dev)
        codes = marker_rows            # row provider for calc_var_ratio
    elif impl == "packed2":
        grm = build_packed2_grm(codes, device=dev)
    else:
        grm = build_grm(codes, device=dev)

    return dict(data=cols, sample_id=sample_id, grm=grm, codes=codes,
                marker_order=marker_order, variant_id=variant_id, X_new=X_new,
                X_qrr=X_qrr, X_names=X_names, x_transform=x_transform)


def _assemble_model(cfg, glmm, vr, nok, X_qrr, X_names, x_transform,
                    variant_id, sample_id, n_data) -> NullModel:
    # order the variance-ratio table by marker index; map ids
    # (R/saige_main.r:510-513)
    ord_ = np.argsort(np.asarray(vr["id"], dtype=np.int64), kind="stable")
    var_ratio = {k: np.asarray(v)[ord_] for k, v in vr.items()}
    var_ratio["id"] = variant_id[var_ratio["id"].astype(np.int64) - 1]

    # un-rotate coefficients through qr.R (R/saige_main.r:616-623)
    if x_transform:
        coef = np.linalg.solve(X_qrr, glmm.coefficients * np.sqrt(n_data))
        coef_names = X_names
    else:
        coef = glmm.coefficients
        coef_names = X_names[: len(coef)]

    return NullModel(
        trait_type=cfg.trait_type,
        coefficients=coef,
        coef_names=coef_names,
        tau=glmm.tau,
        linear_predictors=glmm.linear_predictors,
        fitted_values=glmm.fitted_values,
        residuals=glmm.residuals,
        cov=glmm.cov,
        converged=glmm.converged,
        y=nok.y, mu=nok.mu, res=nok.res, V=nok.V,
        X1=nok.X1, XV=nok.XV, XXVX_inv=nok.XXVX_inv,
        var_ratio=var_ratio,
        sample_id=sample_id,
        variant_id=variant_id,
    )


def _genotype_codes(seq: SeqData) -> np.ndarray:
    """[M, N] int8 genotype codes (ALT dosage 0/1/2, 3 = missing).

    A DS (imputed-dosage) source is ROUNDED to hard codes -- the reference
    fits its GRM only from integer genotype nodes, so a warning reports the
    largest rounding delta."""
    if seq.has_genotype():
        from ..io.gds import read_bit2_dosage
        return read_bit2_dosage(seq.gds.root["genotype/data"])
    ds = seq.dosage_block(0, seq.n_variants)
    out = np.where(np.isfinite(ds), np.round(ds), 3)
    out = np.where((out >= 0) & (out <= 2), out, 3)
    with np.errstate(invalid="ignore"):
        delta = np.abs(ds - out)
    max_delta = float(np.nanmax(np.where(out == 3, np.nan, delta),
                                initial=0.0))
    if max_delta > 0:
        warnings.warn(
            f"GRM built from a dosage (DS) node: fractional dosages were "
            f"rounded to 0/1/2 hard codes (max |delta| = {max_delta:.4g}). "
            f"The reference fits only from integer genotype nodes.",
            RuntimeWarning, stacklevel=2)
    return out.astype(np.int8)
