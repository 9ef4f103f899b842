"""Saddlepoint approximation (SPA) of score-statistic p-values, batched.

The counterpart of ``saigegds_tpu/ops/spa.py`` (itself the reference's CGF
machinery, ``src/SPATest.cpp:42-374``, derived from the SPAtest R package /
Dey et al. 2017).  The CGF sums run as masked ``[B, N]`` reductions and the
Newton root-finding runs as a lane-masked Python loop: every lane steps
until all have finished, finished lanes keep their state.

Semantics reproduced exactly (they are part of the output contract):

* "fast" split: samples with nonzero raw dosage contribute exact Bernoulli
  CGF terms; the zero-dosage remainder is approximated as a Gaussian with
  moments ``NAmu``/``NAsigma`` (``src/SPATest.cpp:299-374``).
* Newton iteration with sign-change jump damping (``getroot_K1``,
  ``src/SPATest.cpp:92-135``), tolerance ``eps^0.25``, at most
  ``_MAX_ITER`` steps.
* Barndorff-Nielsen tail formula ``z = w + log(v/w)/w``
  (``src/SPATest.cpp:188-207``).
* std-dev cutoff (initial 2.0 in the scan) with doubling escalation when
  ``p_noadj / p_spa > 1000`` (``src/SPATest.cpp:286-290``), in closed form
  (``_resolve_cutoff``).

Every sum over samples goes through :func:`row_sum`, so a variant's
p-value does not depend on the batch it is refined in.
"""

import torch
import torch.nn.functional as F

from .special import pchisq1_sf, pnorm_sf

_ROOT_TOL = torch.finfo(torch.float64).eps ** 0.25
_MAX_ITER = 1000
SUM_CHUNK = 32      # columns per stage of row_sum


def row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sums over the last axis of ``x`` [..., L] whose bits depend on a
    row's own values alone, not on how many rows are summed at once.

    A plain reduction over a long axis picks its threads per row, and may
    split a row over thread blocks, by the number of rows (on a card), so
    a variant's sum could change with the batch it lies in.  Here the rows
    reduce in stages of exactly SUM_CHUNK columns (zero-padded), a width
    that a reduction spreads over the same threads at any row count, on
    the CPU as on a card; zeros appended to a row leave its sum as it
    is."""
    while True:
        pad = (-x.shape[-1]) % SUM_CHUNK or (SUM_CHUNK if x.shape[-1] == 0
                                              else 0)
        if pad:
            x = F.pad(x, (0, pad))
        if x.shape[-1] == SUM_CHUNK:
            return x.sum(dim=-1)
        x = x.reshape(*x.shape[:-1], -1, SUM_CHUNK).sum(dim=-1)


def pad_lanes(x: torch.Tensor, L: int, value=0) -> torch.Tensor:
    """``x`` [B, n] padded on its last axis to ``L`` lanes."""
    return x if x.shape[-1] == L else F.pad(x, (0, L - x.shape[-1]),
                                            value=value)


def _cgf_terms(t, g, mu, mask):
    """Masked CGF of sum_i g_i X_i with X_i ~ Bernoulli(mu_i).

    t: [B] lane parameter; g, mu, mask: [B, N].
    Returns K0, K1, K2 each [B].
    """
    gt = g * t[:, None]
    # log(1 - mu + mu * exp(g t)) — the reference's LITERAL Korg
    # arithmetic (src/SPATest.cpp:42-53) including its overflow: g t past
    # ~709 drives exp to inf, K to inf, and get_saddle_prob to 0, which
    # the caller reports as pval_noadj + converged=False
    K0 = row_sum(torch.where(mask, torch.log(1.0 - mu + mu * torch.exp(gt)),
                             0.0))
    # mu g / ((1-mu) exp(-g t) + mu)
    e_neg = torch.exp(-gt)
    denom = (1.0 - mu) * e_neg + mu
    K1 = row_sum(torch.where(mask, mu * g / denom, 0.0))
    # (1-mu) mu g^2 exp(-g t) / ((1-mu) exp(-g t) + mu)^2, non-finite skipped
    k2_raw = (1.0 - mu) * mu * g * g * e_neg / (denom * denom)
    K2 = row_sum(torch.where(mask & torch.isfinite(k2_raw), k2_raw, 0.0))
    return K0, K1, K2


def _getroot_K1(q, g, mu, mask, NAmu, NAsigma, g_pos, g_neg):
    """Vectorized Newton root-find of K1(t) = q with jump damping.

    All args are [B] lanes except g/mu/mask [B, N].  Returns (root,
    converged).  Mirrors ``getroot_K1_fast`` (src/SPATest.cpp:139-183);
    with NAmu=NAsigma=0 and a full mask it is the plain ``getroot_K1``.
    """
    out_of_range = (q >= g_pos) | (q <= g_neg)

    def k1_adj(t):
        _, K1, _ = _cgf_terms(t, g, mu, mask)
        return K1 + NAmu + NAsigma * t - q

    def k2(t):
        _, _, K2 = _cgf_terms(t, g, mu, mask)
        return K2 + NAsigma

    t = torch.zeros_like(q)
    root = torch.zeros_like(q)
    K1v = k1_adj(t)
    prevJump = torch.full_like(q, torch.inf)
    conv = torch.zeros_like(out_of_range)
    done = out_of_range.clone()      # lanes finished (or never started)
    it = 0
    while it < _MAX_ITER and bool((~done).any()):
        K2v = k2(t)
        tnew = t - K1v / K2v
        nonfinite = ~torch.isfinite(tnew)
        tnew_safe = torch.where(nonfinite, t, tnew)
        small_step = torch.abs(tnew_safe - t) < _ROOT_TOL
        newK1 = k1_adj(tnew_safe)
        flip = torch.sign(K1v) != torch.sign(newK1)
        over = torch.abs(tnew_safe - t) > (prevJump - _ROOT_TOL)
        damped_t = t + torch.sign(newK1 - K1v) * prevJump * 0.5
        use_damp = flip & over
        t2 = torch.where(use_damp, damped_t, tnew_safe)
        # re-evaluate K1 only when some lane actually damped (rare)
        K1_2 = torch.where(use_damp, k1_adj(t2), newK1) \
            if bool(use_damp.any()) else newK1
        prevJump2 = torch.where(
            use_damp, prevJump * 0.5,
            torch.where(flip, torch.abs(tnew_safe - t), prevJump))

        active = ~done
        finish_conv = active & ~nonfinite & small_step
        finish_fail = active & nonfinite
        cont = active & ~nonfinite & ~small_step
        root = torch.where(cont, t2, torch.where(finish_conv, t, root))
        t = torch.where(cont, t2, t)
        K1v = torch.where(cont, K1_2, K1v)
        prevJump = torch.where(cont, prevJump2, prevJump)
        conv = conv | finish_conv
        done = done | finish_conv | finish_fail
        it += 1
    root = torch.where(out_of_range, torch.inf, root)
    conv = torch.where(out_of_range, True, conv)
    return root, conv


def _saddle_prob(t, g, mu, mask, NAmu, NAsigma, q):
    """|one-sided saddlepoint tail probability| for root t (0 if invalid)."""
    K0, _, K2v = _cgf_terms(t, g, mu, mask)
    K = K0 + NAmu * t + 0.5 * NAsigma * t * t
    k2 = K2v + NAsigma
    w = torch.sign(t) * torch.sqrt(torch.clamp(2.0 * (t * q - K), min=0.0))
    v = t * torch.sqrt(torch.clamp(k2, min=0.0))
    z = w + torch.log(v / w) / w
    pval = torch.where(z > 0, pnorm_sf(z), -pnorm_sf(-z))
    ok = torch.isfinite(t) & torch.isfinite(K) & torch.isfinite(k2) & \
        torch.isfinite(z)
    return torch.where(ok, torch.abs(pval), 0.0)


def saddle_prob_batch(q, m1, var2, g, mu, mask, cutoff=2.0, g_bounds=None,
                      zero_noadj=True):
    """Batched Saddle_Prob_Fast / Saddle_Prob.

    Parameters
    ----------
    q, m1, var2 : [B] statistics (q possibly the var-ratio-tilted qtilde)
    g : [B, N] covariate-adjusted, AC-normalised genotypes
    mu : [N] or [B, N] fitted probabilities
    mask : [B, N] bool; True lanes use the exact CGF, the complement is
        folded into the Gaussian NAmu/NAsigma remainder.  Pass all-True for
        the full (non-fast) method.
    cutoff : initial std-dev cutoff (the scan uses 2.0)
    g_bounds : (g_pos, g_neg) range bounds over the FULL adjusted vector,
        for callers that pass a compacted ``g``.
    zero_noadj : replace an SPA p-value of 0 by pval_noadj (the
        single-variant caller's rule); GxG passes False (see
        :func:`_resolve_cutoff`).

    Returns (pval, converged) each [B].
    """
    if mu.dim() == 1:
        mu = mu[None, :].expand(g.shape)
    # lanes padded once to a multiple of SUM_CHUNK (masked out), so that
    # no sum of the Newton loop pads again
    L = -(-g.shape[1] // SUM_CHUNK) * SUM_CHUNK
    g, mu, mask = pad_lanes(g, L), pad_lanes(mu, L), pad_lanes(mask, L)
    s = q - m1
    qinv = m1 - s
    pval_noadj = pchisq1_sf(s * s / var2)

    gm = torch.where(mask, g, 0.0)     # masking established here once
    NAmu = m1 - row_sum(gm * mu)
    NAsigma = var2 - row_sum(gm * gm * mu * (1.0 - mu))
    # range bounds use the FULL adjusted genotype vector, not only the
    # exact-CGF subset (reference src/SPATest.cpp:325-331 sums over n_g)
    if g_bounds is not None:
        g_pos, g_neg = g_bounds
    else:
        g_pos = row_sum(torch.where(g > 0, g, 0.0))
        g_neg = row_sum(torch.where(g < 0, g, 0.0))

    root1, conv1 = _getroot_K1(q, g, mu, mask, NAmu, NAsigma, g_pos, g_neg)
    root2, conv2 = _getroot_K1(qinv, g, mu, mask, NAmu, NAsigma, g_pos,
                               g_neg)
    both_conv = conv1 & conv2
    p1 = _saddle_prob(root1, g, mu, mask, NAmu, NAsigma, q)
    p2 = _saddle_prob(root2, g, mu, mask, NAmu, NAsigma, qinv)
    spa = p1 + p2

    return _resolve_cutoff(pval_noadj, spa, both_conv, s, var2, cutoff,
                           zero_noadj)


def _resolve_cutoff(pval_noadj, spa, both_conv, s, var2, cutoff,
                    zero_noadj=True):
    """Closed form of the reference's cutoff-doubling loop.

    The loop (src/SPATest.cpp:286-290) only toggles between the SPA value
    and pval_noadj; doubling ends at the first branch giving a consistent
    answer, which is:
      * stat < cutoff            -> pval_noadj (converged)
      * root-finding failed      -> pval_noadj, converged = False
      * spa != 0 & ratio <= 1000 -> spa
      * spa != 0 & ratio  > 1000 -> pval_noadj (escalated past stat)
      * spa == 0                 -> pval_noadj, converged = False
        (caller semantics: pval==0 && pval_noadj>0, src/saige_main.cpp:389-391)
    """
    cutoff = max(cutoff, 0.1)
    stat = torch.abs(s) / torch.sqrt(var2)
    below = stat < cutoff
    ratio_big = (spa != 0) & (pval_noadj / spa > 1000.0)
    # the pval==0 -> pval_noadj substitution belongs to the single-variant
    # caller (src/saige_main.cpp:390-391); Saddle_Prob itself breaks out of
    # the doubling loop with pval=0 and converged still true, which is what
    # the GxG caller reports (src/saige_fitnull.cpp:1540): zero_noadj=False
    spa_zero = (spa == 0) & (pval_noadj > 0) & zero_noadj

    pval = torch.where(
        below | ~both_conv, pval_noadj,
        torch.where(ratio_big, pval_noadj,
                    torch.where(spa_zero, pval_noadj, spa)))
    converged = torch.where(below, True, both_conv & ~spa_zero)
    return pval, converged
