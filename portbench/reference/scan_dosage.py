"""The single-variant score test with the saddlepoint correction over
imputed dosages, plainly (the reference R package's ``seqAssocGLMM_SPA``
reading ``annotation/format/DS``, R/assoc_single.r:69-85, for a binary
trait: src/saige_main.cpp:103-150 and 355-400, the SPA of
src/SPATest.cpp:42-374 with its nonzero-dosage split, as in
``scan.py``): per variant of the model's samples, the ALT dosage sum and
frequency, the mean imputation of missing dosages and the flip to the
minor allele, the covariate-adjusted dosage, the score and its variance
times the variance ratio, the chi-square p-value, and where it is at
most ``spa_pval`` the saddlepoint p-value over the samples whose dosage
after the flip is not zero.

Departures from SAIGEgds: the dosages come from the benchmark's own
arrays (the stored float32 values widened, NaN missing), never from the
GDS file; the MAF filter is not applied (the scan cells set none); the
sums over samples run in torch's order, not SAIGEgds's (sums of dosages
that are float32 multiples of 1/255 are exact in float64 either way);
SPA's split is ``g != 0`` after the flip, as SAIGE's
``Saddle_Prob_Fast`` splits its samples, on every flagged row."""

from __future__ import annotations

import torch

from .scan import _chi2_sf, spa_pvalue

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def dosage_rows(D, mac_min: float, missing_max: float, dtype):
    """Float dosage rows ``D`` [B, n] (NaN missing) as a test takes them:
    the ALT dosage sum ``ac``, frequency ``af`` and non-missing count
    ``num``, the dosages ``g`` with missing ones mean-imputed and flipped
    to the minor allele where ``flip``, the minor allele count ``mac``,
    and ``valid``, the rows that pass the filters:
    (g, af, ac, num, mac, flip, valid)."""
    n = D.shape[1]
    D = D.to(dtype)
    miss = torch.isnan(D)
    raw = torch.where(miss, 0.0, D)
    num = (~miss).sum(1).to(dtype)
    ac = raw.sum(1)
    af = ac / (2.0 * num)
    g = torch.where(miss, (ac / num)[:, None], raw)
    flip = af > 0.5
    g = torch.where(flip[:, None], 2.0 - g, g)
    mac = torch.minimum(ac, 2.0 * num - ac)
    maf = torch.minimum(af, 1.0 - af)
    valid = (num > 0) & (maf > 0) & (mac >= mac_min) & \
        ((n - num) / n <= missing_max)
    return g, af, ac, num, mac, flip, valid


def scan_table(dosages, y, mu, XV, XXVX_inv, var_ratio: float,
               spa_pval: float, mac_min: float, missing_max: float, dtype,
               device, rows: int = 128) -> dict:
    """The table of one binary model over float dosages [V, n] (NaN
    missing; the model's samples in the model's order), in blocks of
    ``rows`` variants: the tested variants' indices ``idx`` and their
    ``AF.alt``, ``mac``, ``num``, ``beta``, ``SE``, ``pval``, ``p.norm``,
    ``converged``, in ``dtype``."""
    c = lambda a: torch.as_tensor(a).to(device, dtype)
    y, mu, XV, XXVX_inv = c(y), c(mu), c(XV), c(XXVX_inv)
    mu2 = mu * (1.0 - mu)
    cols = {k: [] for k in ("idx", "AF.alt", "mac", "num", "beta", "SE",
                            "pval", "p.norm", "converged")}
    for s0 in range(0, dosages.shape[0], rows):
        D = torch.as_tensor(dosages[s0:s0 + rows]).to(device)
        g, af, ac, num, mac, flip, valid = dosage_rows(
            D, mac_min, missing_max, dtype)
        gt = g - (g @ XV.T) @ XXVX_inv.T
        S = gt @ (y - mu)
        var1 = ((gt * gt) @ mu2) * var_ratio
        p = _chi2_sf(S * S / var1)
        beta = torch.where(flip, -1.0, 1.0) * S / var1
        p_norm = p.clone()
        conv = torch.isfinite(p)
        need = torch.nonzero(valid & torch.isfinite(p) & (p <= spa_pval))[:, 0]
        if len(need):
            ac2 = torch.where(flip, 2.0 * num - ac, ac)[need]
            ps, cs = spa_pvalue(gt[need] / torch.sqrt(ac2)[:, None],
                                g[need] != 0, y, mu, var_ratio)
            p[need], conv[need] = ps, cs
        se = torch.abs(beta / torch.special.ndtri(p / 2.0))
        keep = torch.nonzero(valid)[:, 0]
        for k, v in (("idx", keep + s0), ("AF.alt", af), ("mac", mac),
                     ("num", num), ("beta", beta), ("SE", se), ("pval", p),
                     ("p.norm", p_norm), ("converged", conv)):
            cols[k].append((v if k == "idx" else v[keep]).cpu())
    return {k: torch.cat(v) for k, v in cols.items()}


def reference_tables(dosages, kept: list, params: dict, dtype,
                     device) -> list:
    """The plain scan of ``dosages`` [V, n] (the model's samples) for
    each kept model (its ``y``, ``mu``, ``XV``, ``XXVX_inv``,
    ``var_ratio``), compared by ``scan_check.gaps``."""
    return [scan_table(dosages, k["y"], k["mu"], k["XV"], k["XXVX_inv"],
                       k["var_ratio"], params["spa_pval"], params["mac"],
                       params["missing"], dtype, device) for k in kept]
