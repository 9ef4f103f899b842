"""What decides ``correct`` in a scan cell: the reference's tables of
sampled (call, model) pairs of the window, and the gaps between them and
the program's tables."""

from __future__ import annotations

import numpy as np
import torch

from .scan import scan_table

COLUMNS = ("AF.alt", "mac", "num", "SE", "pval", "p.norm")


def reference_tables(codes, kept: list, params: dict, dtype,
                     device) -> list:
    """The plain scan of ``codes`` [V, n] (the model's samples) for each
    kept model (its ``y``, ``mu``, ``XV``, ``XXVX_inv``, ``var_ratio``)."""
    return [scan_table(codes, k["y"], k["mu"], k["XV"], k["XXVX_inv"],
                       k["var_ratio"], params["spa_pval"], params["mac"],
                       params["missing"], dtype, device) for k in kept]


def _rel_each(a, r) -> float:
    a, r = torch.as_tensor(a).double(), torch.as_tensor(r).double()
    if a.numel() == 0:
        return 0.0
    den = torch.maximum(a.abs(), r.abs())
    g = torch.where(den > 0, (a - r).abs() / den.clamp_min(1e-300), 0.0)
    g = torch.where(a == r, 0.0, g)          # equal, infinities included
    g = torch.where(torch.isnan(a) & torch.isnan(r), 0.0, g)
    return float(torch.nan_to_num(g, nan=np.inf).max())


def gaps(got: list, ref: list) -> dict:
    """The numbers compared over the sampled tables (``got[i]`` the
    program's table as a dict of columns, with the variant indices of
    its rows under ``idx``): the rows tested by one side only, the
    largest relative gap of each column that the reference's table
    carries on the rows both tested (of beta on the scale of the
    reference's |beta| + SE), and the rows whose ``converged`` differs.
    Only a binary model's table carries ``p.norm`` and ``converged``."""
    out = dict(rows_mismatch=0)
    worst = {k: 0.0 for k in COLUMNS}
    beta = 0.0
    for g, r in zip(got, ref):
        gi, ri = np.asarray(g["idx"]), r["idx"].numpy()
        both, gj, rj = np.intersect1d(gi, ri, return_indices=True)
        out["rows_mismatch"] += len(gi) + len(ri) - 2 * len(both)
        for k in COLUMNS:
            if k not in r:
                continue
            worst[k] = max(worst[k], _rel_each(
                np.asarray(g[k], np.float64)[gj], r[k].numpy()[rj]))
        # beta on the scale of |beta| + SE: a beta near 0 has no relative
        # precision of its own, and a p-value that underflows has SE 0
        rb = r["beta"].double().numpy()[rj]
        d = np.abs(np.asarray(g["beta"], np.float64)[gj] - rb)
        scale = np.abs(rb) + r["SE"].double().numpy()[rj]
        d = np.where(d == 0, 0.0, d / np.where(scale > 0, scale, 1e-300))
        if len(d):
            beta = max(beta, float(np.nan_to_num(d, nan=np.inf).max()))
        if "converged" in r:
            out["converged_mismatch"] = out.get("converged_mismatch", 0) + \
                int((np.asarray(g["converged"], bool)[gj]
                     != r["converged"].numpy().astype(bool)[rj]).sum())
    out["stats_gap"] = max(worst[k] for k in ("AF.alt", "mac", "num"))
    out["beta_gap"] = beta
    out["se_gap"] = worst["SE"]
    out["pval_gap"] = max(worst["pval"], worst["p.norm"])
    return out
