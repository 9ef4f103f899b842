"""What decides ``correct`` in a fit cell: the reference's answers to what
the window's calls answered, and the gaps between the two.

The program's answers (``prog``): the store's derived state (``af``,
``inv``, ``diag``, the missing pairs as ``pairs_samp`` and
``pairs_start``), a few GRM products of the window (``products``: the
columns kept of an input and the program's output), and the fits of
sampled lanes (``lanes``: each lane's inputs and its tau, coefficients,
eta and convergence)."""

from __future__ import annotations

import torch

from .fit import Params, fit_binary, fit_quant
from .grm import PlainGRM


def reference_answers(code_blocks, n: int, m: int, prog: dict, X, U,
                      trait: str, params: Params, dtype, device) -> dict:
    """The answers of the plain references, computed in ``dtype`` on
    ``device`` for the same inputs: the GRM from the codes of
    ``code_blocks``, its products at the kept inputs, and each lane's fit
    from its phenotype and starts, ``X`` and the probe pool ``U``."""
    grm = PlainGRM(code_blocks, n, m, dtype, device)
    out = {k: getattr(grm, k).cpu() for k in
           ("af", "inv", "diag", "pairs_samp", "pairs_start")}
    out["products"] = [grm.matvec(b.to(device, dtype)).cpu()
                       for b, _o in prog["products"]]
    Xd, Ud = X.to(device, dtype), U.to(device, dtype)
    out["lanes"] = []
    for lane in prog["lanes"]:
        y = lane["y"].to(device, dtype)
        tau = lane["tau_init"].to(device, dtype)
        if trait == "binary":
            fit = fit_binary(grm, y, Xd, tau, lane["eta_init"].to(
                device, dtype), Ud, params)
        else:
            fit = fit_quant(grm, y, Xd, tau, Ud, params)
        out["lanes"].append(dict(
            tau=fit.tau.cpu(), coefficients=fit.coefficients.cpu(),
            eta=fit.eta.cpu(), converged=bool(fit.converged),
            iterations=int(fit.iterations)))
    del grm
    return out


def _rel(a, r) -> float:
    """max |a - r| over max |r|: a gap on the scale of the answer."""
    a, r = a.double(), r.double()
    return float((a - r).abs().max() / r.abs().max().clamp_min(1e-300))


def _rel_each(a, r) -> float:
    """max over entries of |a - r| / max(|a|, |r|) (0 where both are 0)."""
    a, r = a.double(), r.double()
    den = torch.maximum(a.abs(), r.abs())
    g = torch.where(den > 0, (a - r).abs() / den.clamp_min(1e-300), 0.0)
    g = torch.where(a == r, 0.0, g)          # equal, infinities included
    return float(g.max())


def _mismatch(a, r) -> int:
    a, r = a.long(), r.long()
    k = min(len(a), len(r))
    return abs(len(a) - len(r)) + int((a[:k] != r[:k]).sum())


def gaps(got: dict, ref: dict) -> dict:
    """The numbers compared, each against its limit: the largest gap of
    the store's moments, the missing pairs that differ, the largest gap
    of a product column (``got["products"]``: the outputs, in the order
    of ``ref``'s), and over the sampled lanes the largest gaps of tau,
    the coefficients and eta and the lanes whose convergence differs."""
    out = dict(
        store_gap=max(_rel(got[k], ref[k]) for k in ("af", "inv", "diag")),
        pairs_mismatch=_mismatch(got["pairs_samp"], ref["pairs_samp"])
        + _mismatch(got["pairs_start"], ref["pairs_start"]),
        product_gap=max(max(_rel(o[:, j], r[:, j]) for j in range(
            r.shape[1])) for o, r in zip(got["products"], ref["products"])))
    lanes = list(zip(got["lanes"], ref["lanes"]))
    out.update(
        tau_gap=max(_rel_each(g["tau"], r["tau"]) for g, r in lanes),
        coefficient_gap=max(_rel(g["coefficients"], r["coefficients"])
                            for g, r in lanes),
        eta_gap=max(_rel(g["eta"], r["eta"]) for g, r in lanes),
        converged_mismatch=sum(bool(g["converged"]) != r["converged"]
                               for g, r in lanes))
    return out

