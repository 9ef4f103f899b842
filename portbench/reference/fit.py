"""The AI-REML null GLMM fit of ONE phenotype, plainly (the algorithm of
the reference R package's ``glmmkin.ai_PCG``, src/saige_fitnull.cpp:
948-1110 for a binary trait, 893-928 and 1160-1170 for a quantitative
one): every solve of Sigma = tau0 diag(1/W) + tau1 GRM by a Jacobi-
preconditioned conjugate gradient per right-hand side, Hutchinson traces
over the probe pool's columns with the +10 escalation while their CV
exceeds the cutoff, the moment-based first tau update, tau[1] halved on
a blow-up.  ``op`` gives ``matvec`` and ``diag`` of the GRM in the dtype
of the computation."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Params(NamedTuple):
    tol: float
    tol_pcg: float
    maxiter: int
    maxiter_pcg: int
    maxiter_coef: int
    nrun: int
    trace_cv_cutoff: float


class Fit(NamedTuple):
    tau: torch.Tensor           # [2]
    coefficients: torch.Tensor  # [K]
    eta: torch.Tensor           # [n]
    converged: bool
    iterations: int


def pcg(op, w, tau, B, tol: float, maxiter: int) -> torch.Tensor:
    """Sigma X = B column by column: each column stops when its own
    sum(r^2) <= tol (or at ``maxiter``), as its solve alone would; the
    preconditioner diag(Sigma) floored at 1e-4.  ``w`` [n], ``B`` [n, C]."""
    t0, t1 = float(tau[0]), float(tau[1])
    inv_w = (1.0 / w)[:, None]
    minv = 1.0 / torch.clamp_min(t0 * inv_w + t1 * op.diag[:, None], 1e-4)
    x = torch.zeros_like(B)
    r = B.clone()
    z = minv * r
    p = z.clone()
    rr = (r * r).sum(0)
    live = rr > tol
    it = 0
    while it < maxiter and bool(live.any()):
        cols = torch.nonzero(live)[:, 0]
        pc, rc, zc = p[:, cols], r[:, cols], z[:, cols]
        Ap = t0 * inv_w * pc + t1 * op.matvec(pc)
        rz = (rc * zc).sum(0)
        a = rz / (pc * Ap).sum(0)
        x[:, cols] += a * pc
        r1 = rc - a * Ap
        z1 = minv * r1
        p[:, cols] = z1 + ((z1 * r1).sum(0) / rz) * pc
        r[:, cols], z[:, cols] = r1, z1
        rr1 = (r1 * r1).sum(0)
        live[cols] = rr1 > tol
        it += 1
    return x


def _inv(m: torch.Tensor) -> torch.Tensor:
    return torch.cholesky_inverse(torch.linalg.cholesky((m + m.T) / 2.0))


def _proj(Si_X, cov, v, Siv):
    """P v = Sigma^-1 v - Sigma^-1 X cov X' Sigma^-1 v, with ``Siv`` =
    Sigma^-1 v given; ``v`` [n] or [n, c]."""
    return Siv - Si_X @ (cov @ (Si_X.T @ v))


def _cv(t: np.ndarray) -> float:
    """The reference's calcCV: sd / (mean * count)."""
    r = len(t)
    return float(np.std(t, ddof=1) / (np.mean(t) * r))


class _Probes:
    """The probe pool U [n, R] and GRM @ U, its columns computed as the
    traces reach them."""

    def __init__(self, op, U, nrun):
        self.op, self.U = op, U
        self.R, self.nrun = U.shape[1], min(nrun, U.shape[1])
        self.AU = op.matvec(U[:, :self.nrun])

    def AU_cols(self, r):
        if self.AU.shape[1] < r:
            self.AU = torch.cat([self.AU, self.op.matvec(
                self.U[:, self.AU.shape[1]:r])], 1)
        return self.AU[:, :r]

    def traces(self, solve, Si_X, cov, Si_U, cutoff, quant):
        """(trace(P GRM), trace(P), capped) from the first ``nrun`` probes
        solved (``Si_U``), escalating by 10 probes (``solve(U_cols)``)
        while the CV is above ``cutoff`` and the pool has them."""
        def est(k0, SiU):
            Uc = self.U[:, k0:k0 + SiU.shape[1]]
            PU = _proj(Si_X, cov, Uc, SiU)
            AUc = self.AU_cols(k0 + SiU.shape[1])[:, k0:]
            return ((AUc * PU).sum(0).cpu().numpy(),
                    (Uc * PU).sum(0).cpu().numpy())

        t1, t0 = est(0, Si_U)
        r = self.nrun

        def cv():
            c = _cv(t1)
            return max(c, _cv(t0)) if quant else c

        while cv() > cutoff and r + 10 <= self.R:
            e1, e0 = est(r, solve(self.U[:, r:r + 10]))
            t1, t0 = np.concatenate([t1, e1]), np.concatenate([t0, e0])
            r += 10
        return float(np.mean(t1)), float(np.mean(t0)), cv() > cutoff


def fit_binary(op, y, X, tau_init, eta_init, U, p: Params) -> Fit:
    """A binary trait's fit: logistic link, the inner IRLS to a 10% rule
    on the coefficients (get_coeff), the AI step on tau[1] alone."""
    n, K = X.shape
    dt = y.dtype
    probes = _Probes(op, U, p.nrun)

    def solve(W, tau, B):
        return pcg(op, W, tau, B, p.tol_pcg, p.maxiter_pcg)

    def get_coeff(tau, eta, alpha):
        for _ in range(p.maxiter_coef):
            mu = torch.sigmoid(eta)
            W = mu * (1.0 - mu)
            Yw = eta + (y - mu) / W
            sol = solve(W, tau, torch.cat([Yw[:, None], X], 1))
            Si_Y, Si_X = sol[:, 0], sol[:, 1:]
            cov = _inv(X.T @ Si_X)
            alpha1 = cov @ (Si_X.T @ Yw)
            eta1 = Yw - tau[0] * (Si_Y - Si_X @ alpha1) / W
            delta = float(torch.max(torch.abs(alpha1 - alpha) / (
                torch.abs(alpha1) + torch.abs(alpha) + 0.1)))
            eta, alpha = eta1, alpha1
            if delta < 0.1:
                break
        return eta, alpha, Yw, W, cov, Si_Y, Si_X

    def ai_update(tau, Yw, W, cov, Si_Y, Si_X, moment):
        PY = _proj(Si_X, cov, Yw, Si_Y)
        APY = op.matvec(PY)
        YPAPY = float(PY @ APY)
        sol = solve(W, tau, torch.cat([APY[:, None],
                                       U[:, :probes.nrun]], 1))
        PAPY = _proj(Si_X, cov, sol[:, 0], sol[:, 0])
        AI = float(APY @ PAPY)
        trace, _, capped = probes.traces(
            lambda Uc: solve(W, tau, Uc), Si_X, cov, sol[:, 1:],
            p.trace_cv_cutoff, quant=False)
        score = YPAPY - trace
        t0, t1 = float(tau[0]), float(tau[1])
        if moment:
            new = max(t1 + t1 * t1 * score / n, 0.0)
        else:
            new = t1 + score / AI
            new = 0.0 if new < p.tol else new
        return torch.tensor([t0, new], dtype=dt, device=y.device), capped

    alpha = torch.zeros(K, dtype=dt, device=y.device)
    _, alpha, Yw, W, cov, Si_Y, Si_X = get_coeff(tau_init, eta_init, alpha)
    tau, _ = ai_update(tau_init, Yw, W, cov, Si_Y, Si_X, True)
    eta = eta_init
    it = retries = 0
    done = failed = False
    while not done and it < p.maxiter:
        t0 = tau
        eta1, alpha1, Yw, W, cov, Si_Y, Si_X = get_coeff(t0, eta, alpha)
        tau1, _ = ai_update(t0, Yw, W, cov, Si_Y, Si_X, False)
        blow = float(tau1.max()) > 1.0 / (p.tol * p.tol)
        delta = float(torch.max(torch.abs(tau1 - t0) / (
            torch.abs(tau1) + torch.abs(t0) + p.tol)))
        if blow and retries < 10:
            # a retry of the iteration from its start, tau[1] halved
            tau = torch.stack([t0[0], t0[1] * 0.5])
            retries += 1
            continue
        failed = blow
        done = blow or delta < p.tol or float(tau1[1]) == 0.0
        tau, eta, alpha = tau1, eta1, alpha1
        it += 1
        retries = 0
    eta, alpha, _, _, _, _, _ = get_coeff(tau, eta, alpha)
    return Fit(tau, alpha, eta, done and not failed, it)


def fit_quant(op, y, X, tau_init, U, p: Params) -> Fit:
    """A quantitative trait's fit: identity link, unit weights, the 2x2
    AI step on both taus, halved while a tau is negative."""
    n, K = X.shape
    dt = y.dtype
    ones = torch.ones(n, dtype=dt, device=y.device)
    probes = _Probes(op, U, p.nrun)

    def solve(tau, B):
        return pcg(op, ones, tau, B, p.tol_pcg, p.maxiter_pcg)

    def coeff(tau, with_probes=True):
        parts = [y[:, None], X] + ([U[:, :probes.nrun]] if with_probes
                                   else [])
        sol = solve(tau, torch.cat(parts, 1))
        Si_Y, Si_X, Si_U = sol[:, 0], sol[:, 1:1 + K], sol[:, 1 + K:]
        cov = _inv(X.T @ Si_X)
        alpha = cov @ (Si_X.T @ y)
        eta = y - tau[0] * (Si_Y - Si_X @ alpha)
        return alpha, eta, cov, Si_Y, Si_X, Si_U

    def scores(tau, cov, Si_Y, Si_X, Si_U):
        PY = _proj(Si_X, cov, y, Si_Y)
        APY = op.matvec(PY)
        tr1, tr0, _ = probes.traces(lambda Uc: solve(tau, Uc), Si_X, cov,
                                    Si_U, p.trace_cv_cutoff, quant=True)
        return PY, APY, tr0, tr1

    def ai_step(tau):
        _, _, cov, Si_Y, Si_X, Si_U = coeff(tau)
        PY, APY, tr0, tr1 = scores(tau, cov, Si_Y, Si_X, Si_U)
        sol2 = solve(tau, torch.stack([PY, APY], 1))
        PA0PY = _proj(Si_X, cov, sol2[:, 0], sol2[:, 0])
        PAPY = _proj(Si_X, cov, sol2[:, 1], sol2[:, 1])
        a00, a01 = float(PY @ PA0PY), float(PY @ PAPY)
        a10, a11 = float(APY @ PA0PY), float(APY @ PAPY)
        s01 = (a01 + a10) / 2.0
        det = a00 * a11 - s01 * s01
        sc0 = float(PY @ PY) - tr0
        sc1 = float(PY @ APY) - tr1
        dtau = torch.tensor([(a11 * sc0 - s01 * sc1) / det,
                             (a00 * sc1 - s01 * sc0) / det], dtype=dt,
                            device=y.device)
        zero_v = tau < p.tol

        def clamp(t):
            return torch.where(zero_v & (t < p.tol), 0.0, t)

        t1 = clamp(tau + dtau)
        step = 1.0
        while bool((t1 < 0.0).any()):
            step *= 0.5
            t1 = clamp(tau + step * dtau)
        return torch.where(t1 < p.tol, 0.0, t1)

    _, _, cov, Si_Y, Si_X, Si_U = coeff(tau_init)
    PY, APY, tr0, tr1 = scores(tau_init, cov, Si_Y, Si_X, Si_U)
    s = torch.tensor([float(PY @ PY) - tr0, float(PY @ APY) - tr1],
                     dtype=dt, device=y.device)
    tau = torch.clamp_min(tau_init + tau_init ** 2 * s / n, 0.0)
    del cov, Si_Y, Si_X, Si_U, PY, APY
    it = 0
    done = False
    while not done and it < p.maxiter:
        t0 = tau
        tau = ai_step(t0)
        done = float(torch.max(torch.abs(tau - t0) / (
            torch.abs(tau) + torch.abs(t0) + p.tol))) < p.tol
        it += 1
    alpha, eta, _, _, _, _ = coeff(tau, with_probes=False)
    return Fit(tau, alpha, eta, done, it)
