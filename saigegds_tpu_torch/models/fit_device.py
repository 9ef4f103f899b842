"""Batched null-GLMM fits: P fits over ONE resident GRM, lane by lane.

The counterpart of the PheWAS machinery of
``saigegds_tpu/models/fit_device.py`` (``fit_glmm_binary_device_multi``,
``fit_glmm_quant_device_multi``).  P phenotypes (a PheWAS fit) or P
designs of one phenotype (the per-pair refits of GxG, ``X`` [P, N, K])
run the AI-REML algorithm of the JAX package's device fitter lock-step:
every stage stacks the right-hand sides of all lanes still running into
one per-column PCG (``ops/pcg.py``), so each GRM product serves every
lane, and each lane performs the arithmetic of its own fit (the PCG
freezes columns one by one, and every column of a product is
independent of the others).

The JAX package compiles each fit into one ``lax.while_loop`` program;
here the loops are driven from the host, as ``fit_ai_pcg`` is, with the
state on the GRM's device.  ``bsel(keep, old, new)`` becomes updates of
the running lanes only: a lane that has converged (or reached its
iteration cap) freezes and its columns leave the later products.

Host-path semantics carried over (src/saige_fitnull.cpp):

* first moment-based tau update before the Newton loop (:1024);
* trace-CV escalation (:644-665) within a fixed Rademacher probe pool
  ``U`` [N, R] drawn once by the caller: the trace uses the first ``r``
  probes, ``r = nrun, nrun + 10, ...`` while the CV exceeds
  ``trace_cv_cutoff`` and the pool has 10 more; ``trace_capped`` flags a
  pool that ran out.  Probes beyond ``nrun`` are solved only when a lane
  escalates to them (a column's solve does not depend on the others, so
  this is the JAX package's all-R solve, column for column);
* tau blow-up retry (:1039-1066): tau[1] halves, up to 10 times per
  iteration; the 11th failure ends the lane with ``converged=False``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.pcg import pcg_solve


class DeviceFit(NamedTuple):
    """A batched fit's result; every field has a leading lane axis P."""

    coefficients: torch.Tensor   # [P, K]
    tau: torch.Tensor            # [P, 2]
    eta: torch.Tensor            # [P, N] linear predictor
    mu: torch.Tensor             # [P, N] fitted values
    cov: torch.Tensor            # [P, K, K]
    iterations: torch.Tensor     # [P] outer iterations taken
    converged: torch.Tensor      # [P] bool
    # True when a Hutchinson trace of the lane exhausted the probe pool
    # with its CV still above trace_cv_cutoff
    trace_capped: torch.Tensor   # [P] bool
    pcg_iterations: int = 0      # over the fit's solves, each solve's most


def _sym_inv(m: torch.Tensor) -> torch.Tensor:
    """Inverse of symmetric positive definite [..., K, K] by Cholesky and a
    triangular solve, as the JAX package does it."""
    c = torch.linalg.cholesky((m + m.transpose(-1, -2)) / 2.0)
    eye = torch.eye(m.shape[-1], dtype=m.dtype, device=m.device)
    ic = torch.linalg.solve_triangular(c, eye.expand_as(c), upper=False)
    return ic.transpose(-1, -2) @ ic


def _trace_stats(t: np.ndarray, r: int):
    """(mean, cv) of the first ``r`` probe estimates; cv = sd / (mean * r),
    the reference's calcCV (:618-623)."""
    m = float(np.sum(t[:r])) / r
    var = float(np.sum((t[:r] - m) ** 2)) / (r - 1)
    return m, np.sqrt(var) / (m * r)


def _stack_cols(A: torch.Tensor) -> torch.Tensor:
    """[P, N, C] per-lane right-hand sides -> [N, P*C] stacked columns."""
    P, N, C = A.shape
    return A.permute(1, 0, 2).reshape(N, P * C)


def _pcg_multi(op, W, tau, B, tol_pcg, maxiter_pcg, count=None):
    """Solve P lanes' systems in ONE per-column PCG: ``W`` [P, N], ``tau``
    [P, 2], ``B`` [P, N, C] -> [P, N, C].  ``count`` (a one-element list)
    accumulates the solve's iterations (its slowest column's)."""
    P, N, C = B.shape
    Wc = W.T.repeat_interleave(C, dim=1)            # [N, P*C]
    tc = tau.T.repeat_interleave(C, dim=1)          # [2, P*C]
    sol, iters, _ = pcg_solve(op, Wc, tc, _stack_cols(B), tol_pcg,
                              maxiter_pcg)
    if count is not None:
        count[0] += int(iters.max())
    return sol.reshape(N, P, C).permute(1, 0, 2)


def _proj(Si_X, cov, v, Siv):
    """P v = Sigma^-1 v - Sigma^-1 X cov X' Sigma^-1 v per lane: ``v``,
    ``Siv`` [L, N] -> [L, N]."""
    return Siv - torch.einsum(
        "pnk,pk->pn", Si_X,
        torch.einsum("pkj,pj->pk", cov, torch.einsum("pnj,pn->pj", Si_X, v)))


class _Probes:
    """The shared probe pool ``U`` [N, R] and GRM @ U, whose columns are
    taken (and their products computed) only as far as a trace needs."""

    def __init__(self, op, U: torch.Tensor, nrun: int):
        self.op, self.U = op, U
        self.R = U.shape[1]
        self.nrun = min(nrun, self.R)
        self.AU = op.matvec(U[:, :self.nrun])        # tau-invariant

    def AU_cols(self, r: int) -> torch.Tensor:
        if self.AU.shape[1] < r:
            self.AU = torch.cat([self.AU, self.op.matvec(
                self.U[:, self.AU.shape[1]:r])], dim=1)
        return self.AU[:, :r]

    def _estimates(self, Si_X, cov, Si_U, k0: int):
        """Probe estimates of probe columns ``k0 .. k0 + c`` of every lane
        (``Si_U`` [L, N, c]): (U'P A U, U'P U) diagonals, host [L, c]."""
        c = Si_U.shape[2]
        Uc = self.U[:, k0:k0 + c]
        PU = Si_U - torch.einsum(
            "pnk,pkr->pnr", Si_X,
            torch.einsum("pkj,pjr->pkr", cov,
                         torch.einsum("pnj,nr->pjr", Si_X, Uc)))
        t1 = torch.einsum("nr,pnr->pr", self.AU_cols(k0 + c)[:, k0:], PU)
        t0 = torch.einsum("nr,pnr->pr", Uc, PU)
        return t1.cpu().numpy(), t0.cpu().numpy()

    def traces(self, solve, Si_X, cov, Si_U, cutoff, quant=False):
        """Per-lane CV-escalated traces from the first ``nrun`` probes
        solved (``Si_U`` [L, N, nrun]); ``solve(lanes, U_cols)`` solves 10
        more probe columns for the lanes that escalate.  Returns host
        arrays ``(trace1 [L], trace0 [L], capped [L])``: trace(P GRM) and
        trace(P); a quantitative trait's escalation waits for both CVs
        (the host loop checks both), a binary one's for trace(P GRM)."""
        L = Si_U.shape[0]
        t1, t0 = self._estimates(Si_X, cov, Si_U, 0)
        r = self.nrun
        lanes = np.arange(L)
        r_fin = np.full(L, r)

        def cv(p, r):
            c = _trace_stats(t1[p], r)[1]
            return max(c, _trace_stats(t0[p], r)[1]) if quant else c

        while True:
            esc = lanes[[cv(p, r) > cutoff and r + 10 <= self.R
                         for p in lanes]]
            if len(esc) == 0:
                break
            sol = solve(torch.as_tensor(esc, device=Si_U.device),
                        self.U[:, r:r + 10])
            e1, e0 = self._estimates(Si_X[esc], cov[esc], sol, r)
            t1 = np.concatenate([t1, np.full((L, 10), np.nan)], axis=1)
            t0 = np.concatenate([t0, np.full((L, 10), np.nan)], axis=1)
            t1[esc, r:], t0[esc, r:] = e1, e0
            r += 10
            r_fin[esc] = r
            lanes = esc
        out1, out0, capped = np.empty(L), np.empty(L), np.zeros(L, bool)
        for p in range(L):
            out1[p] = _trace_stats(t1[p], r_fin[p])[0]
            out0[p] = _trace_stats(t0[p], r_fin[p])[0]
            capped[p] = cv(p, r_fin[p]) > cutoff
        return out1, out0, capped


def _lane_design(X: torch.Tensor, P: int) -> torch.Tensor:
    """One X [N, K] shared by the lanes, or one per lane [P, N, K]."""
    return X if X.dim() == 3 else X.expand(P, *X.shape)


def fit_glmm_binary_device_multi(op, Y, X, tau_init, eta_init, U, tol,
                                 tol_pcg, maxiter: int = 20,
                                 maxiter_pcg: int = 500,
                                 maxiter_coef: int = 20, nrun: int = 30,
                                 trace_cv_cutoff: float = 0.0025
                                 ) -> DeviceFit:
    """Fit P binary null GLMMs over ONE GRM operator ``op``, lock-step.

    ``Y`` [P, N] phenotypes, ``tau_init`` [P, 2], ``eta_init`` [P, N],
    ``X`` [N, K] shared covariates (PheWAS) or [P, N, K] one design per
    lane (GxG refits), ``U`` [N, R] the shared probe pool; tensors f64 on
    ``op.device``.  Each lane reproduces the JAX package's
    ``fit_glmm_binary_device`` on its own phenotype and design
    (src/saige_fitnull.cpp:948-1110)."""
    P, N = Y.shape
    Xl = _lane_design(X, P)
    K = Xl.shape[2]
    dev, f64 = Y.device, Y.dtype
    tol_inv_2 = 1.0 / (tol * tol)
    probes = _Probes(op, U, nrun)
    its = [0]

    def pcg(W, tau, B):
        return _pcg_multi(op, W, tau, B, tol_pcg, maxiter_pcg, its)

    def get_coeff(ix, tau, eta, alpha):
        """Inner IRLS (get_coeff, :766-813) of lanes ``ix``, lock-step."""
        L = len(ix)
        Yl, Xs = Y[ix], Xl[ix]
        eta, alpha = eta.clone(), alpha.clone()
        mu0 = torch.sigmoid(eta)
        aux = [eta.clone(), mu0 * (1.0 - mu0),
               torch.eye(K, dtype=f64, device=dev).repeat(L, 1, 1),
               eta.clone(), torch.zeros(L, N, K, dtype=f64, device=dev)]
        done = torch.zeros(L, dtype=torch.bool, device=dev)
        for _ in range(maxiter_coef):
            a = torch.nonzero(~done)[:, 0]
            if len(a) == 0:
                break
            e = eta[a]
            mu = torch.sigmoid(e)
            W = mu * (1.0 - mu)
            Yw = e + (Yl[a] - mu) / W
            sol = pcg(W, tau[a], torch.cat([Yw[:, :, None], Xs[a]], dim=2))
            Si_Y, Si_X = sol[:, :, 0], sol[:, :, 1:]
            cov = _sym_inv(torch.einsum("pnk,pnj->pkj", Xs[a], Si_X))
            alpha1 = torch.einsum("pkj,pj->pk", cov,
                                  torch.einsum("pnk,pn->pk", Si_X, Yw))
            eta1 = Yw - tau[a, 0:1] * \
                (Si_Y - torch.einsum("pnk,pk->pn", Si_X, alpha1)) / W
            delta = torch.amax(torch.abs(alpha1 - alpha[a]) /
                               (torch.abs(alpha1) + torch.abs(alpha[a]) + 0.1),
                               dim=1)
            eta[a], alpha[a] = eta1, alpha1
            for slot, v in zip(aux, (Yw, W, cov, Si_Y, Si_X)):
                slot[a] = v
            done[a] = delta < 0.1
        return (eta, alpha, *aux)

    def ai_update(ix, tau, Yw, W, cov, Si_Y, Si_X, moment: bool):
        """AI-REML tau step (:816-890) of lanes ``ix``, one batched PCG
        for APY and the first ``nrun`` probes of every lane."""
        L = len(ix)
        PY = _proj(Si_X, cov, Yw, Si_Y)
        APY = op.matvec(PY.T).T                       # [L, N], one product
        YPAPY = torch.sum(PY * APY, dim=1)
        B = torch.cat([APY[:, :, None],
                       U[:, :probes.nrun].expand(L, N, probes.nrun)], dim=2)
        sol = pcg(W, tau, B)
        PAPY = _proj(Si_X, cov, sol[:, :, 0], sol[:, :, 0])
        AI = torch.sum(APY * PAPY, dim=1)

        def solve(lanes, Uc):
            return pcg(W[lanes], tau[lanes],
                       Uc.expand(len(lanes), *Uc.shape))

        trace, _, capped = probes.traces(solve, Si_X, cov, sol[:, :, 1:],
                                         trace_cv_cutoff)
        score = YPAPY - torch.as_tensor(trace, dtype=f64, device=dev)
        t1n = tau[:, 1] + score / AI
        t1n = torch.where(t1n < tol, 0.0, t1n)
        t1m = torch.clamp_min(tau[:, 1] + tau[:, 1] ** 2 * score / N, 0.0)
        tau1 = torch.stack([tau[:, 0], t1m if moment else t1n], dim=1)
        return tau1, torch.as_tensor(capped, device=dev)

    every = torch.arange(P, device=dev)
    tau_init = tau_init.to(f64)
    _, alpha, Yw, W, cov, Si_Y, Si_X = get_coeff(
        every, tau_init, eta_init, torch.zeros(P, K, dtype=f64, device=dev))
    tau, capped = ai_update(every, tau_init, Yw, W, cov, Si_Y, Si_X, True)
    eta = eta_init.clone()
    it = torch.zeros(P, dtype=torch.int64, device=dev)
    retries = torch.zeros_like(it)
    done = torch.zeros(P, dtype=torch.bool, device=dev)
    failed = torch.zeros_like(done)
    while True:
        ix = torch.nonzero(~done & (it < maxiter))[:, 0]
        if len(ix) == 0:
            break
        t0 = tau[ix]
        eta1, alpha1, Yw, W, cov, Si_Y, Si_X = get_coeff(ix, t0, eta[ix],
                                                         alpha[ix])
        tau1, cap1 = ai_update(ix, t0, Yw, W, cov, Si_Y, Si_X, False)
        blow = torch.amax(tau1, dim=1) > tol_inv_2
        can_retry = blow & (retries[ix] < 10)
        fail = blow & (retries[ix] >= 10)
        delta = torch.amax(torch.abs(tau1 - t0) /
                           (torch.abs(tau1) + torch.abs(t0) + tol), dim=1)
        done[ix] = (~blow & ((delta < tol) | (tau1[:, 1] == 0.0))) | fail
        # a retry restarts the iteration from its starting eta/alpha with
        # tau[1] halved (the host's itry loop, :1039-1066)
        r = can_retry[:, None]
        tau[ix] = torch.where(r, torch.stack([t0[:, 0], t0[:, 1] * 0.5], 1),
                              tau1)
        eta[ix] = torch.where(r, eta[ix], eta1)
        alpha[ix] = torch.where(r, alpha[ix], alpha1)
        it[ix] += (~can_retry).to(it.dtype)
        # the reference's itry budget is per iteration (:1039-1066)
        retries[ix] = torch.where(can_retry, retries[ix] + 1, 0)
        failed[ix] |= fail
        capped[ix] |= cap1
    eta_f, alpha_f, _, _, cov, _, _ = get_coeff(every, tau, eta, alpha)
    return DeviceFit(coefficients=alpha_f, tau=tau, eta=eta_f,
                     mu=torch.sigmoid(eta_f), cov=cov, iterations=it,
                     converged=done & ~failed, trace_capped=capped,
                     pcg_iterations=its[0])


def fit_glmm_quant_device_multi(op, Y, X, tau_init, U, tol, tol_pcg,
                                maxiter: int = 20, maxiter_pcg: int = 500,
                                nrun: int = 30,
                                trace_cv_cutoff: float = 0.0025
                                ) -> DeviceFit:
    """Fit P quantitative null GLMMs over ONE GRM operator, lock-step.

    ``Y`` [P, N] (gaussian working responses), ``tau_init`` [P, 2], ``X``
    [N, K] or [P, N, K], ``U`` [N, R].  Gaussian weights are ones, so the
    inner IRLS is one solve per stage; the 2x2 AI step halves while a tau
    is negative, with the zero_v clamps, and a lane stops at the 2% rule
    (src/saige_fitnull.cpp:893-928, 1160-1170), as the JAX package's
    ``fit_glmm_quant_device`` does for one lane."""
    P, N = Y.shape
    Xl = _lane_design(X, P)
    K = Xl.shape[2]
    dev, f64 = Y.device, Y.dtype
    ones = torch.ones(P, N, dtype=f64, device=dev)
    probes = _Probes(op, U, nrun)
    its = [0]

    def pcg(ix, tau, B):
        return _pcg_multi(op, ones[ix], tau, B, tol_pcg, maxiter_pcg, its)

    def coeff(ix, tau, with_probes=True):
        L = len(ix)
        parts = [Y[ix][:, :, None], Xl[ix]]
        if with_probes:
            parts.append(U[:, :probes.nrun].expand(L, N, probes.nrun))
        sol = pcg(ix, tau, torch.cat(parts, dim=2))
        Si_Y, Si_X, Si_U = sol[:, :, 0], sol[:, :, 1:1 + K], sol[:, :, 1 + K:]
        cov = _sym_inv(torch.einsum("pnk,pnj->pkj", Xl[ix], Si_X))
        alpha = torch.einsum("pkj,pj->pk", cov,
                             torch.einsum("pnk,pn->pk", Si_X, Y[ix]))
        eta = Y[ix] - tau[:, 0:1] * \
            (Si_Y - torch.einsum("pnk,pk->pn", Si_X, alpha))
        return alpha, eta, cov, Si_Y, Si_X, Si_U

    def scores(ix, tau, cov, Si_Y, Si_X, Si_U):
        def solve(lanes, Uc):
            return pcg(ix[lanes], tau[lanes],
                       Uc.expand(len(lanes), *Uc.shape))

        PY = _proj(Si_X, cov, Y[ix], Si_Y)
        APY = op.matvec(PY.T).T
        trace1, trace0, capped = probes.traces(solve, Si_X, cov, Si_U,
                                               trace_cv_cutoff, quant=True)
        t = lambda a: torch.as_tensor(a, dtype=f64, device=dev)
        return PY, APY, t(trace0), t(trace1), t(capped).bool()

    def ai_step(ix, tau):
        alpha, eta, cov, Si_Y, Si_X, Si_U = coeff(ix, tau)
        PY, APY, trace0, trace1, capped = scores(ix, tau, cov, Si_Y, Si_X,
                                                 Si_U)
        YPAPY = torch.sum(PY * APY, dim=1)
        YPA0PY = torch.sum(PY * PY, dim=1)
        sol2 = pcg(ix, tau, torch.stack([PY, APY], dim=2))
        PA0PY = _proj(Si_X, cov, sol2[:, :, 0], sol2[:, :, 0])
        PAPY = _proj(Si_X, cov, sol2[:, :, 1], sol2[:, :, 1])
        a00 = torch.sum(PY * PA0PY, dim=1)
        a01 = torch.sum(PY * PAPY, dim=1)
        a10 = torch.sum(APY * PA0PY, dim=1)
        a11 = torch.sum(APY * PAPY, dim=1)
        s01 = (a01 + a10) / 2.0          # the serial fit's (AI + AI.T) / 2
        det = a00 * a11 - s01 * s01
        sc0 = YPA0PY - trace0
        sc1 = YPAPY - trace1
        dtau = torch.stack([(a11 * sc0 - s01 * sc1) / det,
                            (a00 * sc1 - s01 * sc0) / det], dim=1)
        zero_v = tau < tol

        def clamp(t):
            return torch.where(zero_v & (t < tol), 0.0, t)

        t1 = clamp(tau + dtau)
        step = torch.ones(len(ix), dtype=f64, device=dev)
        while bool((t1 < 0.0).any()):
            neg = (t1 < 0.0).any(dim=1)
            step = torch.where(neg, step * 0.5, step)
            t1 = torch.where(neg[:, None], clamp(tau + step[:, None] * dtau),
                             t1)
        t1 = torch.where(t1 < tol, 0.0, t1)
        return t1, alpha, eta, cov, capped

    every = torch.arange(P, device=dev)
    tau_init = tau_init.to(f64)
    # the moment-based first update (saige_fit_AI_PCG_quant :1160-1170)
    _, _, cov, Si_Y, Si_X, Si_U = coeff(every, tau_init)
    PY, APY, trace0, trace1, capped = scores(every, tau_init, cov, Si_Y,
                                             Si_X, Si_U)
    s = torch.stack([torch.sum(PY * PY, 1) - trace0,
                     torch.sum(PY * APY, 1) - trace1], dim=1)
    tau = torch.clamp_min(tau_init + tau_init ** 2 * s / N, 0.0)
    it = torch.zeros(P, dtype=torch.int64, device=dev)
    done = torch.zeros(P, dtype=torch.bool, device=dev)
    while True:
        ix = torch.nonzero(~done & (it < maxiter))[:, 0]
        if len(ix) == 0:
            break
        t0 = tau[ix]
        tau1, _, _, _, cap1 = ai_step(ix, t0)
        delta = torch.amax(torch.abs(tau1 - t0) /
                           (torch.abs(tau1) + torch.abs(t0) + tol), dim=1)
        done[ix] = delta < tol
        tau[ix] = tau1
        it[ix] += 1
        capped[ix] |= cap1
    alpha_f, eta_f, cov_f, *_ = coeff(every, tau, with_probes=False)
    return DeviceFit(coefficients=alpha_f, tau=tau, eta=eta_f, mu=eta_f,
                     cov=cov_f, iterations=it, converged=done,
                     trace_capped=capped, pcg_iterations=its[0])
