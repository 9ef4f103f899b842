"""Preconditioned conjugate gradient for Sigma x = b, batched over RHS.

The counterpart of ``saigegds_tpu/ops/pcg.py``.  Sigma = tau0 * diag(1/W)
+ tau1 * GRM applied matrix-free (the reference's ``PCG_diag_sigma``,
src/saige_fitnull.cpp:581-614): Jacobi preconditioner with a 1e-4 floor on
diag(Sigma) (:553), stop when sum(r^2) <= tolPCG or maxiterPCG.  R
right-hand sides run as one batch with per-column freezing, so each column
performs exactly the iterations its sequential solve would -- the
arithmetic of the JAX package's ``_pcg_body``.  The weights ``w`` and the
variance components ``tau`` may also be given per column (``[N, R]`` and
``[2, R]``), so systems of different models (the lanes of a PheWAS fit,
the pairs of a GxG batch) share one solve and one GRM product per
iteration, each column with the arithmetic of its own solve.

The loop is driven from the host, like the JAX package's ``pcg_host``,
with all state on the operator's device; it reads ``any(active)`` after
every iteration, so no GRM product is spent on a finished solve.
Non-convergence is reported, not raised (:610-611).
"""

from __future__ import annotations

import torch


def pcg_solve(op, w: torch.Tensor, tau, B: torch.Tensor, tol: float,
              maxiter: int):
    """Solve Sigma X = B.

    ``op`` has ``.matvec([N, R])`` and ``.diag`` [N] (a
    :class:`~.packed_grm.Packed2GRM` or :class:`~.grm.GRMOperator`); ``w``
    working weights, [N] shared or [N, R] per column; ``tau`` (tau0, tau1)
    shared, or a [2, R] tensor per column; ``B`` [N] or [N, R]; all f64 on
    the operator's device.  Returns ``(X, iters [R], converged [R])``
    (``X`` [N] and scalars for a 1-D ``B``)."""
    squeeze = B.dim() == 1
    if squeeze:
        B = B[:, None]
    if isinstance(tau, torch.Tensor) and tau.dim() == 2:
        tau0, tau1 = tau[0][None, :], tau[1][None, :]      # [1, R]
    else:
        tau0, tau1 = float(tau[0]), float(tau[1])
    inv_w = 1.0 / w
    if inv_w.dim() == 1:
        inv_w = inv_w[:, None]

    d = torch.clamp_min(tau0 * inv_w + tau1 * op.diag[:, None], 1e-4)
    minv = (1.0 / d).expand(B.shape)

    x = torch.zeros_like(B)
    r = B
    z = minv * r
    p = z
    rr = torch.sum(r * r, dim=0)
    act = rr > tol
    iters = torch.zeros(B.shape[1], dtype=torch.int32, device=B.device)
    it = 0
    while it < maxiter and bool(act.any()):
        Ap = tau0 * inv_w * p + tau1 * op.matvec(p)
        rz = torch.sum(r * z, dim=0)
        pAp = torch.sum(p * Ap, dim=0)
        a = torch.where(act, rz / pAp, 0.0)
        x = x + a * p
        r1 = r - a * Ap
        z1 = minv * r1
        rz1 = torch.sum(z1 * r1, dim=0)
        bet = torch.where(act, rz1 / rz, 0.0)
        p = torch.where(act, z1 + bet * p, p)
        rr1 = torch.sum(r1 * r1, dim=0)
        it += 1
        iters = torch.where(act, it, iters)
        rr = torch.where(act, rr1, rr)
        r = torch.where(act, r1, r)
        z = torch.where(act, z1, z)
        act = act & (rr1 > tol)
    converged = rr <= tol
    if squeeze:
        return x[:, 0], iters[0], converged[0]
    return x, iters, converged
