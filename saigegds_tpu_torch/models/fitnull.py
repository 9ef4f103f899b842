"""Null GLMM fitting for a binary or a quantitative trait: penalized IRLS +
AI-REML with PCG solves on a torch device.

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
import os
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
from .glm import GlmFit, ObjNoK, glm_binomial, glm_gaussian, \
    obj_nok_binary, obj_nok_quant, qr_transform, rank_norm
from .nullmodel import NullModel


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to the PyTorch port "
                               f"yet (ROADMAP Queue A, {item})")


# ---------------------------------------------------------------------------
# family callbacks (R family objects: linkinv, mu.eta, variance)


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


class _Gaussian:
    name = "gaussian"

    @staticmethod
    def linkinv(eta):
        return eta

    @staticmethod
    def mu_eta(eta):
        return np.ones_like(eta)

    @staticmethod
    def variance(mu):
        return np.ones_like(mu)


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
# Hutchinson trace estimators


def _get_trace(grm, st: _CoeffState, tau, cfg: NullModelConfig,
               quant: bool = False):
    """trace(P*GRM), and for a quantitative trait also trace(P), via
    Rademacher probes: ``float`` for a binary trait, ``(trace(P),
    trace(P*GRM))`` for a quantitative one, whose escalation waits for
    both CVs.

    Probes replay R's ``set.seed(seed); rbinom(n,1,0.5)`` stream and the
    +10 escalation continues the same stream (src/saige_fitnull.cpp:627-718).
    """
    rng = RRandom(cfg.seed)
    SiX, cov = st.Sigma_iX, st.cov
    n = grm.n_samples
    buf, buf0 = [], []
    n_runs = cfg.nrun
    while True:
        need = n_runs - len(buf)
        U = np.stack([rng.rademacher(n).astype(np.float64)
                      for _ in range(need)], axis=1)  # [N, need]
        SiU = _pcg(grm, st.W, tau, U, cfg.tol_pcg, cfg.maxiter_pcg)
        PU = SiU - SiX @ (cov @ (SiX.T @ U))
        AU = _grm_mv(grm, U)
        buf.extend(np.sum(AU * PU, axis=0).tolist())
        if quant:
            buf0.extend(np.sum(U * PU, axis=0).tolist())
        cv = _calc_cv(buf)
        cv0 = _calc_cv(buf0) if quant else 0.0
        if cv <= cfg.trace_cv_cutoff and cv0 <= cfg.trace_cv_cutoff:
            break
        if cfg.nrun_max and n_runs + 10 > cfg.nrun_max:
            # the reference escalates unboundedly (src/saige_fitnull.cpp:
            # 644-663); an optional cap trades trace variance for progress
            warnings.warn(
                f"trace CV {max(cv, cv0):.3g} > {cfg.trace_cv_cutoff:.3g} "
                f"at the nrun_max={cfg.nrun_max} probe cap; proceeding")
            break
        n_runs += 10
    if quant:
        return float(np.mean(buf0)), float(np.mean(buf))
    return float(np.mean(buf))


# ---------------------------------------------------------------------------
# AI-REML updates


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


def _get_ai_score_quant(grm, st, tau, cfg):
    """The quantitative AI-REML score: both right-hand sides (PY for
    tau_E, GRM*PY for tau_G) solved in one batched PCG, and the 2x2
    average information."""
    SiX, cov, Y = st.Sigma_iX, st.cov, st.Y
    PY = st.Sigma_iY - SiX @ (cov @ (SiX.T @ Y))
    A0PY = PY
    APY = _grm_mv(grm, PY)
    YPAPY = float(PY @ APY)
    YPA0PY = float(PY @ A0PY)
    trace0, trace1 = _get_trace(grm, st, tau, cfg, quant=True)
    B = np.column_stack([A0PY, APY])
    sol = _pcg(grm, st.W, tau, B, cfg.tol_pcg, cfg.maxiter_pcg)
    PA0PY = sol[:, 0] - SiX @ (cov @ (SiX.T @ sol[:, 0]))
    PAPY = sol[:, 1] - SiX @ (cov @ (SiX.T @ sol[:, 1]))
    AI = np.empty((2, 2))
    AI[0, 0] = A0PY @ PA0PY
    AI[1, 1] = APY @ PAPY
    AI[0, 1] = AI[1, 0] = A0PY @ PAPY
    return (YPAPY, YPA0PY), (trace0, trace1), AI


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


def _fit_tau_quant(grm, st, tau0, cfg):
    """fitglmmaiRPCG_q (src/saige_fitnull.cpp:893-928): a Newton step on
    both taus, halved while either is negative; a tau that started below
    ``tol`` stays at 0."""
    zero_v = tau0 < cfg.tol
    (YPAPY, YPA0PY), (trace0, trace1), AI = _get_ai_score_quant(
        grm, st, tau0, cfg)
    score = np.array([YPA0PY - trace0, YPAPY - trace1])
    Dtau = np.linalg.solve(AI, score)
    tau = tau0 + Dtau
    tau[zero_v & (tau < cfg.tol)] = 0.0
    step = 1.0
    while tau[0] < 0.0 or tau[1] < 0.0:
        step *= 0.5
        tau = tau0 + step * Dtau
        tau[zero_v & (tau < cfg.tol)] = 0.0
    tau[tau < cfg.tol] = 0.0
    return tau


# ---------------------------------------------------------------------------
# checkpoints: ``{cfg.checkpoint}.fit.npz`` (AI-REML) and ``.vr.npz`` (the
# variance-ratio markers), the JAX package's files


def _ck_path(cfg: NullModelConfig, tag: str) -> str:
    return f"{cfg.checkpoint}.{tag}.npz" if cfg.checkpoint else ""


def _ck_save(path: str, **arrs):
    """Atomic checkpoint write (tmp + rename)."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrs)
    os.replace(tmp, path)


def _ck_load(path: str):
    if path and os.path.exists(path):
        with np.load(path, allow_pickle=False) as z:
            return {k: z[k] for k in z.files}
    return None


def clear_checkpoint(cfg: NullModelConfig):
    """Remove the fit and variance-ratio checkpoint files (called once the
    model is assembled)."""
    for tag in ("fit", "vr"):
        p = _ck_path(cfg, tag)
        if p and os.path.exists(p):
            os.remove(p)


# ---------------------------------------------------------------------------
# outer loop (saige_fit_AI_PCG_{binary,quant})


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
               cfg: NullModelConfig, binary: bool,
               verbose=False) -> GlmmFit:
    """The saige_fit_AI_PCG_{binary,quant} outer loop
    (src/saige_fitnull.cpp:948-1099, 1102-1248).

    With ``cfg.checkpoint`` the state after every outer iteration, and the
    finished fit, go to ``{checkpoint}.fit.npz``; a later call resumes from
    that file.  Replay is exact on the CPU: each iteration is Markov in
    (tau, alpha, eta), since the trace estimate restarts its R-RNG stream
    per call.  On a card the missing-pair corrections of the GRM product
    are f64 atomics, so a resumed fit there agrees with an uninterrupted
    one to the solver's precision rather than bit for bit.  A file of
    another model shape is ignored with a warning."""
    family = _Binomial() if binary else _Gaussian()
    y = fit0.y.astype(np.float64)
    n = len(y)
    offset = np.zeros(n)
    tol_inv_2 = 1.0 / (cfg.tol * cfg.tol)

    eta = eta0 = fit0.linear_predictors.copy()
    alpha0 = fit0.coefficients.copy()
    alpha = alpha0.copy()
    tau = np.asarray(tau, np.float64).copy()
    tau0 = tau.copy()

    ckp = _ck_path(cfg, "fit")
    state = _ck_load(ckp)
    if state is not None and (int(state["n"]) != n
                              or int(state["k"]) != X.shape[1]
                              or bool(state["binary"]) != binary):
        warnings.warn(f"ignoring checkpoint {ckp}: model shape mismatch")
        state = None
    if state is not None and str(state["phase"]) == "done":
        mu_d = state["mu"]
        return GlmmFit(coefficients=state["alpha"], tau=state["tau"],
                       linear_predictors=state["eta"], fitted_values=mu_d,
                       residuals=y - mu_d, cov=state["cov"],
                       converged=bool(state["converged"]),
                       iterations=int(state["it"]) if "it" in state else 0)
    start_it = 1
    resume_alpha = None
    it = 0
    brk = False
    if state is not None:
        tau = state["tau"].copy()
        eta = state["eta"].copy()
        alpha = resume_alpha = state["alpha"].copy()
        it = int(state["it"])
        brk = bool(state["brk"])
        if brk or it >= cfg.maxiter:
            # crashed between the last saved iteration and the final
            # solve: skip the loop and restore the final solve's warm
            # start as the uninterrupted run has it
            start_it = cfg.maxiter + 1
            alpha0 = state["alpha0"].copy()
            eta0 = state["eta0"].copy()
        else:
            start_it = it + 1
        st = None
    else:
        st = _get_coeff(grm, y, X, tau, family, alpha0, eta0, offset,
                        cfg.maxiter_pcg, cfg.maxiter, cfg.tol_pcg)
        # first moment-based update of tau (both taus for a quantitative
        # trait)
        if binary:
            YPAPY, trace, _ = _get_ai_score_binary(grm, st, tau, cfg)
            tau[1] = max(0.0, tau0[1] + tau0[1] ** 2 * (YPAPY - trace) / n)
        else:
            (YPAPY, YPA0PY), (trace0, trace1), _ = _get_ai_score_quant(
                grm, st, tau, cfg)
            tau[0] = max(0.0,
                         tau0[0] + tau0[0] ** 2 * (YPA0PY - trace0) / n)
            tau[1] = max(0.0, tau0[1] + tau0[1] ** 2 * (YPAPY - trace1) / n)

    for it in range(start_it, cfg.maxiter + 1):
        alpha0 = resume_alpha if st is None else st.alpha
        if verbose:
            print(f"    Iteration {it}: tau = {tau}, coeff = {alpha}")
        tau0 = tau.copy()
        eta0 = eta.copy()

        for itry in range(1, 12):
            st = _get_coeff(grm, y, X, tau0, family, alpha0, eta0, offset,
                            cfg.maxiter_pcg, cfg.maxiter, cfg.tol_pcg)
            tau = (_fit_tau_binary if binary else _fit_tau_quant)(
                grm, st, tau0, cfg)
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
        if not binary and tau[0] <= 0:
            raise OverflowError("Sigma_E = 0, model not converged!")
        brk = (binary and tau[1] == 0) or bool(
            np.max(np.abs(tau - tau0) / (np.abs(tau) + np.abs(tau0)
                                         + cfg.tol)) < cfg.tol)
        if ckp:
            _ck_save(ckp, phase="iter", it=it, brk=brk, n=n, k=X.shape[1],
                     binary=binary, tau=tau, alpha=alpha, eta=eta,
                     alpha0=alpha0, eta0=eta0)
        if brk:
            break

    st = _get_coeff(grm, y, X, tau, family, alpha0, eta0, offset,
                    cfg.maxiter_pcg, cfg.maxiter, cfg.tol_pcg)
    # converged iff the tau loop broke on its tolerance (the reference's
    # `iter <= maxiter` works because its C loop leaves iter = maxiter+1
    # on exhaustion; Python's range leaves it = maxiter)
    fit = GlmmFit(coefficients=st.alpha, tau=tau, linear_predictors=st.eta,
                  fitted_values=st.mu, residuals=y - st.mu, cov=st.cov,
                  converged=bool(brk), iterations=it)
    if ckp:
        _ck_save(ckp, phase="done", n=n, k=X.shape[1], binary=binary,
                 tau=tau, alpha=st.alpha, eta=st.eta, mu=st.mu,
                 cov=st.cov, converged=fit.converged, it=it)
    return fit


# ---------------------------------------------------------------------------
# variance ratio (saige_calc_var_ratio_{binary,quant})


class _VarRatio:
    """The projection state shared by every variance-ratio marker chunk
    (src/saige_fitnull.cpp:1255-1474): the GLM's weights, Sigma^-1 X1 and
    (X1' Sigma^-1 X1)^-1."""

    def __init__(self, grm: _FitGRM, fit0: GlmFit, glmm: GlmmFit,
                 nok: ObjNoK, cfg: NullModelConfig, binary: bool):
        family = _Binomial() if binary else _Gaussian()
        mu_eta = family.mu_eta(fit0.linear_predictors)
        self.mu = fit0.fitted_values
        self.W = (mu_eta * mu_eta) / family.variance(self.mu)
        self.grm, self.nok, self.cfg, self.binary = grm, nok, cfg, binary
        self.Sigma_iX = _pcg(grm, self.W, glmm.tau, nok.X1, cfg.tol_pcg,
                             cfg.maxiter_pcg)
        self.xsx_inv = _mat_inv(nok.X1.T @ self.Sigma_iX)
        self.tau = glmm.tau

    @staticmethod
    def marker(codes, i_snp: int):
        """(af, ac, g) of marker ``i_snp`` (1-based) after mean imputation
        and the minor-allele flip, or None for an all-missing marker
        (explicit variant_id panels bypass the missing-rate filter)."""
        g = codes[i_snp - 1].astype(np.float64)
        isnan = g >= 3
        num = int((~isnan).sum())
        if num == 0:
            return None
        ac = float(np.where(isnan, 0, g).sum())
        af = ac / (2 * num)
        g = np.where(isnan, ac / num, g)  # mean impute
        if af > 0.5:
            g = 2.0 - g
            ac = 2 * num - ac
            af = 1 - af
        return af, ac, g

    def ratios(self, pending):
        """[(i_snp, af, ac, g)] -> [(var1, var2)]: one batched PCG solve of
        the covariate-projected markers."""
        nok, cfg = self.nok, self.cfg
        G0 = np.stack([p[3] for p in pending], axis=1)   # [N, B]
        G = G0 - nok.XXVX_inv @ (nok.XV @ G0)
        SiG = _pcg(self.grm, self.W, self.tau, G, cfg.tol_pcg,
                   cfg.maxiter_pcg)
        adj = self.Sigma_iX @ (self.xsx_inv @ (nok.X1.T @ SiG))
        out = []
        for k, (_, _, ac, _) in enumerate(pending):
            var1 = (float(G[:, k] @ SiG[:, k]) -
                    float(G[:, k] @ adj[:, k])) / ac
            gn = G[:, k] / math.sqrt(ac)
            if self.binary:
                var2 = float(np.sum(self.mu * (1 - self.mu) * gn * gn))
            else:
                var2 = float(gn @ gn)
            out.append((var1, var2))
        return out


def calc_var_ratio(grm: _FitGRM, codes, fit0: GlmFit, glmm: GlmmFit,
                   nok: ObjNoK,
                   cfg: NullModelConfig, marker_order: np.ndarray,
                   binary: bool, verbose=False):
    """Estimate var1/var2 on random markers with MAC>20, adaptively adding
    10 until CV <= ratioCVcutoff (src/saige_fitnull.cpp:1255-1474).

    ``codes`` gives int8 genotype rows by 0-based GRM variant index: an
    [M, N] array, or a :class:`_MarkerRows` cache for a streamed fit.
    With ``cfg.checkpoint`` the table after every marker chunk goes to
    ``{checkpoint}.vr.npz``, and a later call resumes from it (the marker
    order is fixed, so replay is exact)."""
    vr = _VarRatio(grm, fit0, glmm, nok, cfg, binary)
    rows = dict(id=[], maf=[], mac=[], var1=[], var2=[], ratio=[])
    num_marker = cfg.num_marker
    snp_pos = 0
    num_tested = 0
    n_rand = len(marker_order)
    ckp = _ck_path(cfg, "vr")
    state = _ck_load(ckp)
    if state is not None and int(state["n_rand"]) != n_rand:
        warnings.warn(f"ignoring checkpoint {ckp}: marker-set mismatch")
        state = None
    if state is not None:
        rows = {k: list(state["r_" + k]) for k in rows}
        snp_pos = int(state["snp_pos"])
        num_tested = int(state["num_tested"])
        num_marker = int(state["num_marker"])
    while snp_pos < n_rand:
        # gather the next chunk of markers passing the MAC filter
        pending = []
        while num_tested + len(pending) < num_marker and snp_pos < n_rand:
            i_snp = int(marker_order[snp_pos])  # 1-based
            snp_pos += 1
            m = vr.marker(codes, i_snp)
            if m is not None and m[1] > 20:     # MAC > 20, as the paper
                pending.append((i_snp,) + m)
        if pending:
            for (i_snp, af, ac, _), (var1, var2) in zip(pending,
                                                        vr.ratios(pending)):
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
            if ckp:
                _ck_save(ckp, n_rand=n_rand, snp_pos=snp_pos,
                         num_tested=num_tested, num_marker=num_marker,
                         **{"r_" + k: np.asarray(v)
                            for k, v in rows.items()})
        if num_tested >= num_marker:
            cv = _calc_cv(rows["ratio"])
            if cv > cfg.ratio_cv_cutoff:
                num_marker += 10
            else:
                break
        elif snp_pos >= n_rand:
            break
    return rows


def calc_var_ratio_cat(grm: _FitGRM, codes, fit0: GlmFit, glmm: GlmmFit,
                       nok: ObjNoK, cfg: NullModelConfig,
                       marker_order: np.ndarray, binary: bool,
                       verbose=False):
    """Variance ratios per MAC category (``cfg.var_ratio_mac_cat``, a
    feature of SAIGEgds releases after v1.12.5, whose reference estimates
    one pooled ratio over markers with MAC > 20, src/saige_fitnull.cpp:1316).

    Category ``c`` spans minor-allele counts in ``(edges[c-1], edges[c]]``,
    plus a trailing open ``(edges[-1], inf)`` category.  Each category runs
    the loop of :func:`calc_var_ratio` -- ``num_marker`` markers first,
    then 10 more until the ratio CV is under ``ratio_cv_cutoff`` -- with
    the category's MAC range in place of the fixed ``mac > 20`` cut, in
    one walk of the shared ``marker_order``; a marker falls in exactly one
    category, so none is tested twice.  Rows carry ``mac_cat`` (the
    category index).  An empty or short category warns."""
    edges = [float(e) for e in cfg.var_ratio_mac_cat]
    if not edges or edges != sorted(edges):
        raise ValueError("var_ratio_mac_cat must be ascending MAC bounds")
    vr = _VarRatio(grm, fit0, glmm, nok, cfg, binary)
    bounds = [(0.0 if c == 0 else edges[c - 1],
               edges[c] if c < len(edges) else math.inf)
              for c in range(len(edges) + 1)]
    rows = dict(id=[], maf=[], mac=[], var1=[], var2=[], ratio=[],
                mac_cat=[])
    n_rand = len(marker_order)
    for c, (lo, hi) in enumerate(bounds):
        num_marker = cfg.num_marker
        snp_pos = 0
        cat_ratio = []
        while snp_pos < n_rand:
            pending = []
            while len(cat_ratio) + len(pending) < num_marker \
                    and snp_pos < n_rand:
                i_snp = int(marker_order[snp_pos])  # 1-based
                snp_pos += 1
                m = vr.marker(codes, i_snp)
                if m is not None and lo < m[1] <= hi and m[1] > 0:
                    pending.append((i_snp,) + m)
            if pending:
                for (i_snp, af, ac, _), (var1, var2) in zip(
                        pending, vr.ratios(pending)):
                    rows["id"].append(i_snp)
                    rows["maf"].append(af)
                    rows["mac"].append(ac)
                    rows["var1"].append(var1)
                    rows["var2"].append(var2)
                    rows["ratio"].append(var1 / var2)
                    rows["mac_cat"].append(c)
                    cat_ratio.append(var1 / var2)
                    if verbose:
                        print(f"    marker {i_snp} (MAC category {c}): maf "
                              f"{af:.4g}, mac {ac:g}, ratio "
                              f"{var1 / var2:.6g}")
            if len(cat_ratio) >= num_marker:
                if _calc_cv(cat_ratio) > cfg.ratio_cv_cutoff:
                    num_marker += 10
                else:
                    break
            elif snp_pos >= n_rand:
                break
        if not cat_ratio:
            warnings.warn(
                f"variance-ratio MAC category ({lo}, {hi}] matched no GRM "
                f"marker; the scan falls back to the overall mean there")
        elif len(cat_ratio) < cfg.num_marker:
            warnings.warn(
                f"variance-ratio MAC category ({lo}, {hi}] found only "
                f"{len(cat_ratio)}/{cfg.num_marker} markers")
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
    """Fit the null GLMM of a binary or a quantitative trait
    (``config.trait_type``; the ``seqFitNullGLMM_SPA`` equivalent) with
    the GRM and every PCG solve on ``device``.

    ``formula``: e.g. ``"y ~ x1 + x2"`` over columns of ``data``, a mapping
    from column name to a 1-D array that includes ``config.sample_col``
    (reference R/saige_main.r:223).  ``variant_id``: explicit GRM SNP panel
    -- replaces the maf/missing filter, like the reference's
    ``variant.id=`` (R/saige_main.r:314-323).  ``instrument``: optional
    dict that receives the wall seconds of ingest (``ingest_s``), AI-REML
    (``aireml_s``) and the variance ratio (``var_ratio_s``), the outer
    iterations, and the GRM products and PCG iterations run.

    ``config.checkpoint`` makes the fit resumable (see :func:`fit_ai_pcg`
    and :func:`calc_var_ratio`; the files are removed once the model is
    assembled); ``config.var_ratio_mac_cat`` estimates a variance ratio
    per MAC category (:func:`calc_var_ratio_cat`).
    """
    cfg = config
    dev = check_device(device)
    if cfg.trait_type not in ("binary", "quantitative"):
        raise ValueError(f"Invalid trait type {cfg.trait_type!r}")
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
    glmm, fit0, nok, binary = _fit_trait(grm, y_raw, prep["X_new"], cfg,
                                         verbose)
    t2 = time.perf_counter()

    vr_fn = calc_var_ratio_cat if cfg.var_ratio_mac_cat else calc_var_ratio
    vr = vr_fn(grm, prep["codes"], fit0, glmm, nok, cfg,
               prep["marker_order"], binary=binary, verbose=verbose)
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
    clear_checkpoint(cfg)   # fit + variance ratio complete: drop the state
    if model_savefn:
        model.save(model_savefn)
    return model


def _fit_trait(grm: _FitGRM, y_raw: np.ndarray, X_new: np.ndarray,
               cfg: NullModelConfig, verbose):
    """The trait's GLM start, SA_NULL projection and AI-REML fit ->
    (glmm, fit0, nok, binary)."""
    if cfg.trait_type == "binary":
        if set(np.unique(y_raw)) - {0.0, 1.0}:
            raise ValueError("binary trait must be coded 0/1")
        fit0 = glm_binomial(X_new, y_raw)
        nok = obj_nok_binary(X_new, y_raw)
        # initial tau: (1, 0.5) unless tau_init given (R/saige_main.r:489-495)
        tau = np.array([1.0, 0.5])
        ti = np.nan_to_num(np.asarray(cfg.tau_init, float))
        ti[ti < 0] = 0
        if ti[1] > 0:
            tau[1] = ti[1]
        glmm = fit_ai_pcg(grm, fit0, X_new, tau, cfg, binary=True,
                          verbose=verbose)
        return glmm, fit0, nok, True
    yq = y_raw.copy()
    if cfg.inv_norm:
        # rank-based inverse normal of the covariate residuals, rescaled
        # to their SD
        fit_pre = glm_gaussian(X_new, yq)
        resid_sd = np.std(fit_pre.residuals, ddof=1)
        yq = rank_norm(fit_pre.residuals) * resid_sd
    fit0 = glm_gaussian(X_new, yq)
    nok = obj_nok_quant(X_new, fit0)
    # initial tau: var(y) split by tau_init, or evenly; the gaussian
    # working response is y itself
    ti = np.nan_to_num(np.asarray(cfg.tau_init, float))
    ti[ti < 0] = 0
    tau = ti if ti.sum() > 0 else np.array([0.5, 0.5])
    tau = np.var(fit0.y, ddof=1) * tau / tau.sum()
    glmm = fit_ai_pcg(grm, fit0, nok.X1, tau, cfg, binary=False,
                      verbose=verbose)
    return glmm, fit0, nok, False


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
    if cfg.var_ratio_mac_cat:
        # category bin bounds travel with the model (not per-row data)
        var_ratio["mac_bins"] = np.asarray(cfg.var_ratio_mac_cat, float)

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
