"""Batched null-GLMM fits: P fits over ONE resident GRM, lane by lane.

The counterpart of ``saigegds_tpu/models/fit_device.py``: the public
device fitters ``fit_glmm_binary_device_multi``,
``fit_glmm_quant_device_multi`` and their one-lane forms
``fit_glmm_binary_device``, ``fit_glmm_quant_device`` (the multi fitters
at P = 1, without the lane axis).  P phenotypes (a PheWAS fit) or P
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

The lanes run in groups sized to the card's free memory
(:func:`_lane_groups`): each group runs the lock-step loop on its own and
the results go back in lane order.  A lane's arithmetic does not depend
on the other lanes, so the groups change no model; the probe pool and
GRM @ U are shared by every group of a call.  The f32/f64 PCG of the
JAX package (``pcg="mixed"``) exists because the TPU emulates f64 and is
not ported.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.pcg import pcg_solve


class DeviceFit(NamedTuple):
    """A batched fit's result; every field but the counts has a leading
    lane axis P (a one-lane fit's, none)."""

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
    # over the fit's solves, each solve's most, summed over the groups
    pcg_iterations: int = 0
    lane_groups: tuple = ()      # lanes per group, in lane order


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
        # GRM @ U is tau-invariant; its columns are filled as the traces
        # reach them, into one tensor allocated before any group runs
        self.AU = torch.empty_like(U)
        self.AU[:, :self.nrun] = op.matvec(U[:, :self.nrun])
        self.filled = self.nrun

    def AU_cols(self, r: int) -> torch.Tensor:
        if self.filled < r:
            self.AU[:, self.filled:r] = self.op.matvec(
                self.U[:, self.filled:r])
            self.filled = r
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


# ---------------------------------------------------------------------------
# the lanes in groups

# Device memory the group rule leaves unplanned: the CUDA libraries'
# workspaces, the caching allocator's rounding and the host loop's small
# tensors.
_MARGIN_BYTES = 2 << 30
# The share of the free memory beyond the margin that a group may plan to
# fill.  PyTorch's caching allocator cuts the PCG's arrays out of the
# multi-GB blocks that a product frees, so a later product's block finds
# no segment whole: on an H100 at n = 430,000, groups planned to all of
# the free memory beyond the margin (22 binary lanes, 22 variance-ratio
# lanes) and to 92% of it (21 variance-ratio lanes) failed on 17.2-17.6
# GiB blocks with 16.4-16.7 GiB reserved but unallocated; with the
# allocator's expandable segments all of it served.  The share costs no
# time there: 15 binary lanes took 15.1 s of AI-REML in one group and
# 15.0 s in two (tools/phewas_groups_card.py), the products' cost growing
# with their width.
_PLAN_SHARE = 2 / 3
# Bytes per sample of one f64 column of a stacked solve, at its peak (the
# GRM product inside a PCG iteration): the PCG's state (``ops/pcg.py``:
# the right-hand sides and their stacked copy, the weights, 1 / w,
# diag(Sigma) and its inverse, x, r, z, p, Ap, r1, z1 and tau0 p / w: 14
# arrays of 8 B) and the product's temporaries
# (``ops/packed_grm.sharded_product`` at its widest: kernel B2's rows as
# f64 and their weighted copy, 8 slices of 8 B each, 128 B; the 8 int8
# slices of the column, 8 B; the recombined column, 8 B).
_SOLVE_COL_BYTES = 14 * 8 + 128 + 8 + 8
# Bytes per sample of the columns a product pads its slices with
# (``packed_grm.kernel_cols``: up to 127), as B2's int32 and f64 rows
# (only the f64 rows are alive at the product's peak).
_PAD_BYTES = 127 * (4 + 8)


def _lane_bytes(n: int, K: int, cols: int) -> int:
    """Device bytes one lane adds to its group's peak: ``cols`` columns of
    the widest stacked solve over ``n`` samples (:data:`_SOLVE_COL_BYTES`
    each), and the lane's own state beside it (its design, the IRLS and
    AI-REML vectors, the solutions kept from the stage before, its
    phenotype and starting eta brought to the device, and 4 vectors of
    headroom: 4K + 18 vectors of n f64).  On an H100 at n = 430,000 the
    slopes of the peak allocated from 2 to 4 and from 4 to 6 lanes came
    within 1% below this count (``chip_smoke.py`` phase 16 prints both)."""
    return n * (_SOLVE_COL_BYTES * cols + 8 * (4 * K + 18))


def _balanced(P: int, most: int) -> list:
    """The fewest groups of at most ``most`` lanes, ``ceil(P / g)`` lanes
    each (the last may hold fewer), as slices in lane order."""
    g = -(-P // most)
    size = -(-P // g)
    return [slice(i, min(i + size, P)) for i in range(0, P, size)]


def _groups_within(P: int, lane: int, budget: int, where: str) -> list:
    """Groups of lanes of ``lane`` bytes each within ``budget`` bytes; a
    RuntimeError when not even one lane fits."""
    most = budget // lane if budget > 0 else 0
    if most < 1:
        raise RuntimeError(
            f"one lane of the fit needs {lane} bytes of device memory and "
            f"{max(budget, 0)} are free for it on {where}: free device "
            f"memory, or fit fewer samples")
    return _balanced(P, min(most, P))


def _group_budget(free: int, n: int) -> int:
    """The bytes a group's lanes may take of ``free`` device bytes:
    :data:`_PLAN_SHARE` of what :data:`_MARGIN_BYTES` leaves, less the
    slice padding of one product over ``n`` samples."""
    return int(_PLAN_SHARE * (free - _MARGIN_BYTES)) - n * _PAD_BYTES


def _lane_groups(P: int, n: int, K: int, cols: int, device) -> list:
    """The groups a call's P lanes run in, as slices in lane order.

    On a CUDA device the budget is :func:`_group_budget` of the free
    memory at entry (``torch.cuda.mem_get_info`` after ``empty_cache``);
    each lane takes :func:`_lane_bytes` for its widest stacked solve of
    ``cols`` columns.  On the CPU every lane goes in one group."""
    device = torch.device(device)
    if device.type != "cuda":
        return [slice(0, P)]
    torch.cuda.empty_cache()
    free, _total = torch.cuda.mem_get_info(device)
    return _groups_within(P, _lane_bytes(n, K, cols),
                          _group_budget(free, n), str(device))


_FIELDS = ("coefficients", "tau", "eta", "mu", "cov", "iterations",
           "converged", "trace_capped")


def _check_inputs(op, **tensors):
    """Every input a float64 tensor on the operator's device."""
    where = op.diag.device
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got "
                            f"{type(t).__name__}")
        if t.dtype != torch.float64 or t.device != where:
            raise ValueError(f"{name} must be float64 on the operator's "
                             f"device {where}, got {t.dtype} on {t.device}")


def _grouped(probes: _Probes, P: int, N: int, K: int, cols: int,
             like: torch.Tensor, run) -> DeviceFit:
    """A call's P lanes group by group: its outputs allocated first, where
    ``like`` (the phenotypes) lies, then the groups of :func:`_lane_groups`
    on the operator's device for a widest solve of ``cols`` columns a
    lane, each run by ``run(g)`` (the DeviceFit of lanes ``g``) and
    copied into the outputs in lane order."""
    dev, f64 = like.device, like.dtype
    out = DeviceFit(
        coefficients=torch.empty(P, K, dtype=f64, device=dev),
        tau=torch.empty(P, 2, dtype=f64, device=dev),
        eta=torch.empty(P, N, dtype=f64, device=dev),
        mu=torch.empty(P, N, dtype=f64, device=dev),
        cov=torch.empty(P, K, K, dtype=f64, device=dev),
        iterations=torch.empty(P, dtype=torch.int64, device=dev),
        converged=torch.empty(P, dtype=torch.bool, device=dev),
        trace_capped=torch.empty(P, dtype=torch.bool, device=dev))
    groups = _lane_groups(P, N, K, cols, probes.U.device)
    its = 0
    for g in groups:
        fit = run(g)
        for k in _FIELDS:
            getattr(out, k)[g].copy_(getattr(fit, k))
        its += fit.pcg_iterations
        del fit
    return out._replace(pcg_iterations=its, lane_groups=tuple(
        g.stop - g.start for g in groups))


def _one_lane(fit: DeviceFit) -> DeviceFit:
    """A one-lane fit without its lane axis."""
    return fit._replace(**{k: getattr(fit, k)[0] for k in _FIELDS})


def _binary_lanes(op, probes: _Probes, Y, Xl, tau_init, eta_init, tol,
                  tol_pcg, maxiter: int, maxiter_pcg: int,
                  maxiter_coef: int, trace_cv_cutoff: float) -> DeviceFit:
    """One group of :func:`fit_glmm_binary_device_multi`: its P lanes
    (``Y`` [P, N], ``Xl`` [P, N, K], ``tau_init`` [P, 2], ``eta_init``
    [P, N]) lock-step over the call's probe pool."""
    P, N = Y.shape
    K = Xl.shape[2]
    dev, f64 = Y.device, Y.dtype
    tol_inv_2 = 1.0 / (tol * tol)
    U = probes.U
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


def _quant_lanes(op, probes: _Probes, Y, Xl, tau_init, tol, tol_pcg,
                 maxiter: int, maxiter_pcg: int,
                 trace_cv_cutoff: float) -> DeviceFit:
    """One group of :func:`fit_glmm_quant_device_multi`: its P lanes
    (``Y`` [P, N], ``Xl`` [P, N, K], ``tau_init`` [P, 2]) lock-step over
    the call's probe pool."""
    P, N = Y.shape
    K = Xl.shape[2]
    dev, f64 = Y.device, Y.dtype
    U = probes.U
    ones = torch.ones(P, N, dtype=f64, device=dev)
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
    # the first solve's columns would stay alive beside every later one
    del cov, Si_Y, Si_X, Si_U, PY, APY
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


def fit_glmm_binary_device_multi(op, Y, X, tau_init, eta_init, U, tol,
                                 tol_pcg, maxiter: int = 20,
                                 maxiter_pcg: int = 500,
                                 maxiter_coef: int = 20, nrun: int = 30,
                                 trace_cv_cutoff: float = 0.0025
                                 ) -> DeviceFit:
    """Fit P binary null GLMMs over ONE GRM operator ``op``, lock-step.

    ``op`` is a GRM operator on one device (``Packed2GRM``, the dense
    ``GRMOperator`` or a ``ShardedGrmHandle`` within one process); ``Y``
    [P, N] phenotypes, ``tau_init`` [P, 2], ``eta_init`` [P, N], ``X``
    [N, K] shared covariates (PheWAS) or [P, N, K] one design per lane
    (GxG refits), ``U`` [N, R] the shared probe pool; tensors f64 on the
    operator's device.  Each lane reproduces the JAX package's
    ``fit_glmm_binary_device`` on its own phenotype and design
    (src/saige_fitnull.cpp:948-1110).  The lanes run in the groups of
    :func:`_lane_groups`, the probe pool shared by all of them; the
    outputs' [P, N] eta and mu are allocated on the device beside the
    inputs."""
    _check_inputs(op, Y=Y, X=X, tau_init=tau_init, eta_init=eta_init, U=U)
    return _binary_multi(op, Y, X, tau_init, eta_init, U, tol, tol_pcg,
                         maxiter, maxiter_pcg, maxiter_coef, nrun,
                         trace_cv_cutoff)


def _binary_multi(op, Y, X, tau_init, eta_init, U, tol, tol_pcg,
                  maxiter: int = 20, maxiter_pcg: int = 500,
                  maxiter_coef: int = 20, nrun: int = 30,
                  trace_cv_cutoff: float = 0.0025) -> DeviceFit:
    """:func:`fit_glmm_binary_device_multi` with the lanes' ``Y``,
    ``tau_init``, ``eta_init`` (and ``X`` [P, N, K]) on the device of
    ``U`` or on the host: each group's are brought to ``U``'s device, and
    the outputs lie where ``Y`` does (``fit_null_glmm_multi`` keeps them
    on the host, so the device holds one group's lanes at a time)."""
    P, N = Y.shape
    K = X.shape[-1]
    dev = U.device
    probes = _Probes(op, U, nrun)

    def run(g):
        return _binary_lanes(op, probes, Y[g].to(dev),
                             _lane_design(X, P)[g].to(dev),
                             tau_init[g].to(dev), eta_init[g].to(dev), tol,
                             tol_pcg, maxiter, maxiter_pcg, maxiter_coef,
                             trace_cv_cutoff)

    return _grouped(probes, P, N, K, 1 + max(K, probes.nrun), Y, run)


def fit_glmm_quant_device_multi(op, Y, X, tau_init, U, tol, tol_pcg,
                                maxiter: int = 20, maxiter_pcg: int = 500,
                                nrun: int = 30,
                                trace_cv_cutoff: float = 0.0025
                                ) -> DeviceFit:
    """Fit P quantitative null GLMMs over ONE GRM operator, lock-step.

    ``op`` as for :func:`fit_glmm_binary_device_multi`; ``Y`` [P, N]
    (gaussian working responses), ``tau_init`` [P, 2], ``X`` [N, K] or
    [P, N, K], ``U`` [N, R].  Gaussian weights are ones, so the inner IRLS
    is one solve per stage; the 2x2 AI step halves while a tau is
    negative, with the zero_v clamps, and a lane stops at the 2% rule
    (src/saige_fitnull.cpp:893-928, 1160-1170), as the JAX package's
    ``fit_glmm_quant_device`` does for one lane.  The lanes run in the
    groups of :func:`_lane_groups`."""
    _check_inputs(op, Y=Y, X=X, tau_init=tau_init, U=U)
    return _quant_multi(op, Y, X, tau_init, U, tol, tol_pcg, maxiter,
                        maxiter_pcg, nrun, trace_cv_cutoff)


def _quant_multi(op, Y, X, tau_init, U, tol, tol_pcg, maxiter: int = 20,
                 maxiter_pcg: int = 500, nrun: int = 30,
                 trace_cv_cutoff: float = 0.0025) -> DeviceFit:
    """:func:`fit_glmm_quant_device_multi` with the lanes' inputs on the
    device of ``U`` or on the host, as :func:`_binary_multi` takes them."""
    P, N = Y.shape
    K = X.shape[-1]
    dev = U.device
    probes = _Probes(op, U, nrun)

    def run(g):
        return _quant_lanes(op, probes, Y[g].to(dev),
                            _lane_design(X, P)[g].to(dev),
                            tau_init[g].to(dev), tol, tol_pcg, maxiter,
                            maxiter_pcg, trace_cv_cutoff)

    return _grouped(probes, P, N, K, 1 + K + probes.nrun, Y, run)


def fit_glmm_binary_device(op, y, X, tau_init, eta_init, U, tol, tol_pcg,
                           maxiter: int = 20, maxiter_pcg: int = 500,
                           maxiter_coef: int = 20, nrun: int = 30,
                           trace_cv_cutoff: float = 0.0025,
                           pcg: str = "exact") -> DeviceFit:
    """Binary-trait null GLMM fit of one phenotype: ``y`` [N], ``X`` [N,
    K], ``tau_init`` [2], ``eta_init`` [N], ``U`` [N, R] the probe pool
    (R >= nrun; the extra columns feed the trace-CV escalation), tensors
    f64 on the operator's device.  :func:`fit_glmm_binary_device_multi` at
    P = 1; the DeviceFit has no lane axis (tau [2], coefficients [K], eta
    and mu [N], cov [K, K], 0-d iterations, converged and trace_capped).
    ``pcg="mixed"`` (the JAX package's f32/f64 PCG, a cure for the TPU's
    emulated f64) raises NotImplementedError."""
    if pcg == "mixed":
        raise NotImplementedError(
            "pcg='mixed' is not ported: the f32/f64 PCG exists because the "
            "TPU emulates f64; the card runs the f64 PCG (pcg='exact')")
    if pcg != "exact":
        raise ValueError(f"pcg must be 'exact' or 'mixed', got {pcg!r}")
    return _one_lane(fit_glmm_binary_device_multi(
        op, y[None], X, tau_init[None], eta_init[None], U, tol, tol_pcg,
        maxiter=maxiter, maxiter_pcg=maxiter_pcg, maxiter_coef=maxiter_coef,
        nrun=nrun, trace_cv_cutoff=trace_cv_cutoff))


def fit_glmm_quant_device(op, y, X, tau_init, U, tol, tol_pcg,
                          maxiter: int = 20, maxiter_pcg: int = 500,
                          nrun: int = 30,
                          trace_cv_cutoff: float = 0.0025) -> DeviceFit:
    """Quantitative-trait (gaussian identity-link) null GLMM fit of one
    phenotype: ``y`` [N] (the working response), ``X`` [N, K],
    ``tau_init`` [2], ``U`` [N, R], tensors f64 on the operator's device.
    :func:`fit_glmm_quant_device_multi` at P = 1, without the lane axis."""
    return _one_lane(fit_glmm_quant_device_multi(
        op, y[None], X, tau_init[None], U, tol, tol_pcg, maxiter=maxiter,
        maxiter_pcg=maxiter_pcg, nrun=nrun, trace_cv_cutoff=trace_cv_cutoff))
