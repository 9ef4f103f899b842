"""Covariates, phenotypes and null-model starts, made on the device from
the seed and batched over the lanes of a call.

The binary traits follow ``chip_smoke.py``'s ``case_fraction_pheno``
(the intercept set by bisection to a case share) at the case shares of
its ``spread_pct`` (van der Corput order over a range); the quantitative
traits follow ``make_fit_data``'s ``yq`` (log-normal noise) and are
inverse-normal transformed as ``fit_null_glmm``'s default does.  The
starts (``eta_init`` of a binary lane, ``tau_init``) come from the
benchmark's own GLM, not the program's."""

from __future__ import annotations

import torch

from ..seeds import device_gen, host_rng

F64 = torch.float64


def spread(k: int, lo: float, hi: float, base: int = 2) -> float:
    """The k-th value (k >= 0) of [lo, hi] in van der Corput order in
    ``base``, so that any first few cover the range (two bases give two
    sequences that do not move together)."""
    v, f, i = 0.0, 1.0 / base, k + 1
    while i:
        v += f * (i % base)
        i //= base
        f /= base
    return lo + (hi - lo) * v


def covariates(n: int, k: int, seed: int, device,
               binary: int = 0) -> torch.Tensor:
    """X [n, k + 1]: the intercept and ``k`` covariates, the first
    ``binary`` of them 0/1 indicators of share one half (such as sex),
    the others standard normal (a standardised birth year, ancestry
    principal components)."""
    gen = device_gen(seed, "covariates", device)
    x = torch.randn(n, k, generator=gen, device=device, dtype=F64)
    x[:, :binary] = (x[:, :binary] > 0).to(F64)
    return torch.cat([torch.ones(n, 1, device=device, dtype=F64), x], 1)


def case_intercepts(L: torch.Tensor, pct: torch.Tensor,
                    iters: int = 50) -> torch.Tensor:
    """Per-row intercepts c so that mean(sigmoid(L + c)) = pct / 100."""
    lo = torch.full_like(pct, -20.0)
    hi = torch.full_like(pct, 20.0)
    for _ in range(iters):
        c = (lo + hi) / 2
        low = torch.sigmoid(L + c[:, None]).mean(1) < pct / 100
        lo = torch.where(low, c, lo)
        hi = torch.where(low, hi, c)
    return (lo + hi) / 2


def glm_logistic(X: torch.Tensor, Y: torch.Tensor, maxit: int = 25):
    """R's glm(binomial) IRLS for each row of Y [P, n] over X [n, K]:
    (beta [P, K], eta [P, n], mu [P, n])."""
    mu = (Y + 0.5) / 2.0
    eta = torch.log(mu / (1.0 - mu))
    beta = None
    for _ in range(maxit):
        W = torch.clamp_min(mu * (1.0 - mu), torch.finfo(F64).eps)
        z = eta + (Y - mu) / W
        A = torch.einsum("nk,pn,nj->pkj", X, W, X)
        b = torch.einsum("nk,pn->pk", X, W * z)
        new = torch.linalg.solve(A, b)
        eta = new @ X.T
        mu = torch.sigmoid(torch.clamp(eta, -30.0, 30.0))
        done = beta is not None and bool(
            (torch.abs(new - beta) <= 1e-10 * (1.0 + torch.abs(new))).all())
        beta = new
        if done:
            break
    return beta, eta, mu


def least_squares(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """beta [P, K] of each row of Y [P, n] on X [n, K]."""
    return torch.linalg.solve(X.T @ X, (Y @ X).T).T


def rank_normal(r: torch.Tensor) -> torch.Tensor:
    """qnorm((rank - 0.5) / n) of each row of r [P, n] (ranks from 1)."""
    n = r.shape[1]
    ranks = torch.empty_like(r)
    order = torch.argsort(r, dim=1)
    ar = torch.arange(1, n + 1, device=r.device, dtype=r.dtype)
    ranks.scatter_(1, order, ar.expand_as(r).contiguous())
    return torch.special.ndtri((ranks - 0.5) / n)


def lane_genetics(bases: torch.Tensor, P: int, gen) -> torch.Tensor:
    """[P, n]: for each lane a random mix of the [n, B] polygenic
    ``bases`` (itself a polygenic score), centred and scaled to unit
    variance."""
    w = torch.randn(bases.shape[1], P, generator=gen, device=bases.device,
                    dtype=F64)
    g = (bases @ w).T
    g = g - g.mean(1, keepdim=True)
    return g / g.std(1, keepdim=True)


def fit_lanes(X: torch.Tensor, bases: torch.Tensor, trait: dict, mix: dict,
              call: int, seed: int):
    """The inputs of call ``call`` of a fit mix: ``(Y [P, n], tau_init
    [P, 2], eta_init [P, n] or None, info)``, on X's device.

    A lane's design is fixed by its slot j in the call, the same in every
    call and under every seed, so that every call does alike work: a
    binary lane's case share
    ``spread(j, *mix["case_pct"])`` and genetic variance on the logit
    scale ``spread(j, *trait["genetic_var_logit"], base=3)``, a
    quantitative lane's heritability ``spread(j, *trait["h2"])``, and
    the covariates' effects; the seed draws the genotypes, the lanes'
    genetic values and noise.  A quantitative trait's noise is
    log-normal, and its covariate residuals are inverse-normal
    transformed."""
    P = int(mix["phenotypes_per_call"])
    n, K = X.shape
    dev = X.device
    gen = device_gen(seed, f"lanes.{call}", dev)
    lanes = range(P)
    g = lane_genetics(bases, P, gen)
    alpha = torch.stack([torch.as_tensor(
        host_rng(0, f"design.{j}").normal(size=K - 1)) for j in lanes]).to(
            dev, F64) * trait["covariate_effect_sd"]
    fixed = alpha @ X[:, 1:].T
    if trait["type"] == "binary":
        var_g = torch.as_tensor([spread(j, *trait["genetic_var_logit"],
                                        base=3) for j in lanes], dtype=F64,
                                device=dev)
        L = fixed + torch.sqrt(var_g)[:, None] * g
        pct = torch.as_tensor([spread(j, *mix["case_pct"]) for j in lanes],
                              dtype=F64, device=dev)
        c = case_intercepts(L, pct)
        u = torch.rand(P, n, generator=gen, device=dev, dtype=F64)
        Y = (u < torch.sigmoid(L + c[:, None])).to(F64)
        _beta, eta, _mu = glm_logistic(X, Y)
        tau = torch.tensor([[1.0, 0.5]], dtype=F64, device=dev).repeat(P, 1)
        return Y, tau, eta, {"case_pct": pct.tolist(),
                             "genetic_var": var_g.tolist()}
    h2 = torch.as_tensor([spread(j, *trait["h2"]) for j in lanes],
                         dtype=F64, device=dev)
    e = torch.exp(torch.randn(P, n, generator=gen, device=dev, dtype=F64)
                  * trait["lognormal_sigma"])
    e = (e - e.mean(1, keepdim=True)) / e.std(1, keepdim=True)
    yq = fixed + torch.sqrt(h2)[:, None] * g + \
        torch.sqrt(1.0 - h2)[:, None] * e
    resid = yq - least_squares(X, yq) @ X.T
    Y = rank_normal(resid) * resid.std(1, keepdim=True)
    tau = (Y.var(1, keepdim=True) * 0.5).repeat(1, 2)
    return Y, tau, None, {"h2": h2.tolist()}
