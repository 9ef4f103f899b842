"""The single-variant score test of a quantitative trait, plainly (the
reference R package's ``seqAssocGLMM_SPA`` for a quantitative trait:
``single_test_quant``, src/saige_main.cpp:189-276): per variant of the
model's samples, the ALT frequency, the mean imputation of missing calls
and the flip to the minor allele, the covariate-adjusted genotype
g~ = g - XXVX_inv (XV g), the score S = g~ . (y - mu), the statistic
T = S / (sqrt(mac) tau0) against the variance r (g~ . g~) / mac, the
chi-square p-value, beta = T / var / sqrt(mac) and its SE.  No SPA.

The variance carries no 1 / tau0: SAIGE's quantitative variance ratio r
is the ratio of the full model's variance to g~ . g~ (without tau0), so
it absorbs it."""

from __future__ import annotations

import torch

from .scan import _chi2_sf, genotype_rows


def quant_table(codes, y, mu, XV, XXVX_inv, tau0: float, var_ratio: float,
                mac_min: float, missing_max: float, dtype, device,
                rows: int = 128) -> dict:
    """The table of one quantitative model over int8 codes [V, n] (3
    missing; the model's samples in the model's order): the tested
    variants' indices ``idx`` and their ``AF.alt``, ``mac``, ``num``,
    ``beta``, ``SE``, ``pval``, in ``dtype``."""
    c = lambda a: torch.as_tensor(a).to(device, dtype)
    y_mu, XV, XXVX_inv = c(y) - c(mu), c(XV), c(XXVX_inv)
    cols = {k: [] for k in ("idx", "AF.alt", "mac", "num", "beta", "SE",
                            "pval")}
    for s0 in range(0, codes.shape[0], rows):
        G = torch.as_tensor(codes[s0:s0 + rows]).to(device)
        g, af, _ac, num, mac, flip, valid = genotype_rows(
            G, mac_min, missing_max, dtype)
        gt = g - (g @ XV.T) @ XXVX_inv.T
        root_mac = torch.sqrt(mac)
        T = (gt @ y_mu) / root_mac / tau0
        var1 = (gt * gt).sum(1) / mac * var_ratio
        p = _chi2_sf(T * T / var1)
        beta = torch.where(flip, -1.0, 1.0) * T / var1 / root_mac
        se = torch.abs(beta / torch.special.ndtri(p / 2.0))
        keep = torch.nonzero(valid)[:, 0]
        for k, v in (("idx", keep + s0), ("AF.alt", af), ("mac", mac),
                     ("num", num), ("beta", beta), ("SE", se), ("pval", p)):
            cols[k].append((v if k == "idx" else v[keep]).cpu())
    return {k: torch.cat(v) for k, v in cols.items()}


def quant_tables(codes, kept: list, params: dict, dtype, device) -> list:
    """The plain scan of ``codes`` [V, n] (the model's samples) for each
    kept model (its ``y``, ``mu``, ``XV``, ``XXVX_inv``, ``tau0``,
    ``var_ratio``)."""
    return [quant_table(codes, k["y"], k["mu"], k["XV"], k["XXVX_inv"],
                        k["tau0"], k["var_ratio"], params["mac"],
                        params["missing"], dtype, device) for k in kept]
