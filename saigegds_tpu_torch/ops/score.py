"""Batched single-variant score-test state and the phase-2 SPA refinement.

The counterpart of ``saigegds_tpu/ops/score.py``: the model state mirrors
``saige_score_test_init`` (reference src/saige_main.cpp:103-150) and
``.init_nullmod`` (R/assoc_single.r:17-67); a binary trait's phase 1
flags the variants with ``p_noadj <= spa.pval`` for
:func:`spa_refine_binary` (src/saige_main.cpp:355-400), a quantitative
trait's (:func:`score_stats_quant`) is final.  Every statistic is float64.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .special import pchisq1_sf, qnorm
from .spa import saddle_prob_batch

_F64 = torch.float64


class ScanModel(NamedTuple):
    """Null-model state needed by the variant scan (float64 tensors on the
    scan's device)."""

    trait_binary: bool
    tau: torch.Tensor          # [2]
    y: torch.Tensor            # [N]
    mu: torch.Tensor           # [N]
    y_mu: torch.Tensor         # [N] y - mu
    mu2: torch.Tensor          # [N] mu*(1-mu)
    XV: torch.Tensor           # [K, N]
    XXVX_inv: torch.Tensor     # [N, K]
    var_ratio: float
    # MAC-categorized variance ratios: category c spans MAC in
    # (vr_edges[c-1], vr_edges[c]] with a trailing open category
    vr_edges: Optional[torch.Tensor] = None    # [C-1] ascending MAC bounds
    vr_ratios: Optional[torch.Tensor] = None   # [C] per-category ratios


def variant_var_ratio(model: ScanModel, mac):
    """Per-variant variance ratio: the model's scalar, or a MAC-category
    lookup when the model carries categorized ratios."""
    if model.vr_edges is None:
        return model.var_ratio
    return model.vr_ratios[torch.searchsorted(model.vr_edges, mac,
                                              right=False)]


class ScanParams(NamedTuple):
    maf: float
    mac: float
    missing: float
    spa_pval: float


class ScoreStats(NamedTuple):
    valid: torch.Tensor       # [B] passed filters
    af: torch.Tensor          # [B] ALT allele frequency
    mac: torch.Tensor         # [B] minor allele count
    num: torch.Tensor         # [B] non-missing samples
    beta: torch.Tensor        # [B]
    se: torch.Tensor          # [B]
    pval: torch.Tensor        # [B] (chi-square, pre-SPA for binary)
    need_spa: torch.Tensor    # [B] flagged for SPA refinement


def stack_stats(res: ScoreStats) -> torch.Tensor:
    """Pack a ScoreStats into one [8, B] f64 tensor, so a drain reads the
    results back in a single device-to-host copy."""
    return torch.stack([res.valid.to(_F64), res.af, res.mac,
                        res.num.to(_F64), res.beta, res.se, res.pval,
                        res.need_spa.to(_F64)])


def unstack_stats(arr) -> ScoreStats:
    """Host-side inverse of :func:`stack_stats` (numpy fields)."""
    a = np.asarray(arr)
    return ScoreStats(valid=a[0] != 0, af=a[1], mac=a[2], num=a[3],
                      beta=a[4], se=a[5], pval=a[6], need_spa=a[7] != 0)


def prep_dosage(G: torch.Tensor):
    """Per-variant AF/AC/missing + mean imputation + minor-allele flip.

    G: [B, N] raw ALT dosages with NaN for missing.  Mirrors
    ``f64_af_ac_impute`` + flip (src/vectorization.cpp:303-354,
    src/saige_main.cpp:291-299).
    """
    G = G.to(_F64)
    isnan = torch.isnan(G)
    num = (~isnan).sum(dim=1).to(_F64)   # exact; keeps the algebra in f64
    ac = torch.where(isnan, 0.0, G).sum(dim=1)
    af = ac / (2.0 * num)
    mean = ac / num
    g = torch.where(isnan, mean[:, None], G)
    flip = af > 0.5
    g = torch.where(flip[:, None], 2.0 - g, g)
    mac = torch.minimum(ac, 2.0 * num - ac)
    maf = torch.minimum(af, 1.0 - af)
    miss = (G.shape[1] - num) / G.shape[1]
    return g, af, ac, num, mac, maf, miss, flip


def _valid_mask(params: ScanParams, num, maf, mac, miss):
    return (num > 0) & (maf > 0) & (maf >= params.maf) & \
        (mac >= params.mac) & (miss <= params.missing)


def _adjusted_genotype(model: ScanModel, g):
    """coeff = XV @ g; g_tilde = g - XXVX_inv @ coeff."""
    coeff = g @ model.XV.T                     # [B, K]
    return g - coeff @ model.XXVX_inv.T        # [B, N]


def score_stats_binary(model: ScanModel, params: ScanParams,
                       G: torch.Tensor) -> ScoreStats:
    """Dense phase-1 binary score test on f64 rows G [R, N] (NaN = missing;
    the aggregate tests' burden rows): chi-square p-values + SPA flags."""
    g, af, ac, num, mac, maf, miss, flip = prep_dosage(G)
    valid = _valid_mask(params, num, maf, mac, miss)
    g_tilde = _adjusted_genotype(model, g)
    S = torch.sum(model.y_mu[None, :] * g_tilde, dim=1)
    var = torch.sum(model.mu2[None, :] * g_tilde * g_tilde, dim=1)
    return binary_stats(model, params, valid, af, mac, num, flip, S, var)


def binary_stats(model: ScanModel, params: ScanParams, valid, af, mac, num,
                 flip, S, var) -> ScoreStats:
    """Score S and variance var -> chi-square p-values, beta, SE and SPA
    flags (the tail of every phase-1 route)."""
    var1 = var * variant_var_ratio(model, mac)
    pval_noadj = pchisq1_sf(S * S / var1)
    beta = S / var1
    beta = torch.where(flip, -beta, beta)
    se = torch.abs(beta / qnorm(pval_noadj / 2.0))
    need_spa = valid & torch.isfinite(pval_noadj) & \
        (pval_noadj <= params.spa_pval)
    return ScoreStats(valid=valid, af=af, mac=mac, num=num, beta=beta, se=se,
                      pval=pval_noadj, need_spa=need_spa)


def score_stats_quant(model: ScanModel, params: ScanParams,
                      G: torch.Tensor) -> ScoreStats:
    """Dense quantitative-trait score test on f64 rows G [R, N] (NaN =
    missing; the aggregate tests' burden rows): chi-square p-values, no
    SPA (``single_test_quant``, src/saige_main.cpp:189-276)."""
    g, af, ac, num, mac, maf, miss, flip = prep_dosage(G)
    valid = _valid_mask(params, num, maf, mac, miss)
    g_tilde = _adjusted_genotype(model, g)
    S = torch.sum(model.y_mu[None, :] * g_tilde, dim=1)
    var2 = torch.sum(g_tilde * g_tilde, dim=1)
    return quant_stats(model, valid, af, mac, num, flip, S, var2)


def quant_stats(model: ScanModel, valid, af, mac, num, flip, S,
                var2) -> ScoreStats:
    """Score S and unit-weight variance var2 -> chi-square p-values, beta
    and SE of a quantitative trait: Tstat = S / sqrt(mac) / tau_E; nothing
    is flagged for SPA."""
    inv_mac = 1.0 / mac
    inv_sqrt_mac = torch.sqrt(inv_mac)
    var1 = var2 * inv_mac * variant_var_ratio(model, mac)
    Tstat = S * inv_sqrt_mac / model.tau[0]
    pval = pchisq1_sf(Tstat * Tstat / var1)
    beta = Tstat / var1 * inv_sqrt_mac
    beta = torch.where(flip, -beta, beta)
    se = torch.abs(beta / qnorm(pval / 2.0))
    return ScoreStats(valid=valid, af=af, mac=mac, num=num, beta=beta, se=se,
                      pval=pval, need_spa=torch.zeros_like(valid))


def unpack_codes_2bit_f64(packed: torch.Tensor, n_samples: int):
    """Inverse of ``ops.packed_grm.pack_codes_2bit`` on the scan's device:
    uint8 [B, N4] planar bytes -> f64 [B, n] dosages with NaN missing."""
    pi = packed.to(torch.int32)
    planes = torch.cat([(pi >> (2 * p)) & 3 for p in range(4)],
                       dim=1)[:, :n_samples]
    return torch.where(planes == 3, torch.nan, planes.to(_F64))


def spa_refine_binary(model: ScanModel, G: torch.Tensor, cap: int = 0,
                      packed_n: int = 0):
    """Phase-2 SPA refinement for a compact batch of flagged variants.

    G: [Bs, N] raw dosages (NaN = missing) of variants that passed filters
    and had p_noadj <= spa.pval — or, with ``packed_n`` = N, planar 2-bit
    packed uint8 [Bs, ceil(N/4)] codes decoded here.  ``cap`` > 0 runs the
    CGF over the top-``cap`` nonzero lanes of each variant only (exact
    when cap >= the batch's largest nonzero count, which the caller
    guarantees).  Returns (pval, converged, beta, se).
    """
    if packed_n:
        G = unpack_codes_2bit_f64(G, packed_n)
    g, af, ac, num, mac, maf, miss, flip = prep_dosage(G)
    g_tilde = _adjusted_genotype(model, g)
    ac2 = torch.where(flip, 2.0 * num - ac, ac)   # minor allele count
    g_norm = g_tilde / torch.sqrt(ac2)[:, None]
    q = torch.sum(model.y[None, :] * g_norm, dim=1)
    m1 = torch.sum(model.mu[None, :] * g_norm, dim=1)
    var2 = torch.sum(model.mu2[None, :] * g_norm * g_norm, dim=1)
    var1 = var2 * variant_var_ratio(model, ac2)
    Tstat = q - m1
    qtilde = Tstat / torch.sqrt(var1) * torch.sqrt(var2) + m1

    live = num > 0  # padding lanes are all-NaN -> num == 0
    nzmask = (g != 0.0) & live[:, None]
    q_ = torch.where(live, qtilde, 0.0)
    m1_ = torch.where(live, m1, 0.0)
    v2_ = torch.where(live, var2, 1.0)
    gn_ = torch.where(live[:, None], g_norm, 0.0)
    if cap and cap < G.shape[1]:
        # rare-variant compaction (Saddle_Prob_Fast's nonzero-index
        # gather, src/SPATest.cpp:299-374): the CGF loops run over the
        # top-`cap` nonzero lanes only
        keys = torch.where(nzmask, torch.abs(gn_), 0.0).to(torch.float32)
        idx = torch.topk(keys, cap, dim=1).indices              # [Bs, cap]
        gl = torch.gather(gn_, 1, idx)
        ml = torch.gather(nzmask, 1, idx)
        mul = model.mu[idx]
        # range bounds must still use the FULL vector
        pval, conv = saddle_prob_batch(
            q_, m1_, v2_, gl, mul, ml, cutoff=2.0,
            g_bounds=(torch.where(gn_ > 0, gn_, 0.0).sum(dim=1),
                      torch.where(gn_ < 0, gn_, 0.0).sum(dim=1)))
    else:
        pval, conv = saddle_prob_batch(
            q_, m1_, v2_, gn_, model.mu, nzmask, cutoff=2.0)

    beta = (Tstat / var1) / torch.sqrt(ac2)
    beta = torch.where(flip, -beta, beta)
    se = torch.abs(beta / qnorm(pval / 2.0))
    return pval, conv, beta, se
