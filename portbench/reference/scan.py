"""The single-variant score test with the saddlepoint correction, plainly
(the reference R package's ``seqAssocGLMM_SPA`` for a binary trait:
src/saige_main.cpp:103-150 and 355-400, the SPA of src/SPATest.cpp:42-374
with its nonzero-dosage split): per variant of the model's samples, the
ALT frequency, the mean imputation of missing calls and the flip to the
minor allele, the covariate-adjusted genotype, the score and its
variance times the variance ratio, the chi-square p-value, and where it
is at most ``spa_pval`` the saddlepoint p-value."""

from __future__ import annotations

import math

import torch

_SQRT2 = math.sqrt(2.0)
ROOT_TOL = 2.0 ** -13      # the root's tolerance: float64's eps ** 0.25


def _chi2_sf(x):
    return torch.special.erfc(torch.sqrt(torch.clamp(x, min=0.0) / 2.0))


def _norm_sf(z):
    return 0.5 * torch.special.erfc(z / _SQRT2)


class _Cgf:
    """The CGF of sum_i g_i B_i, B_i ~ Bernoulli(mu_i), over the samples
    of ``mask`` (rows [B, n]), plus the normal approximation of the other
    samples (``NAmu``, ``NAsigma``)."""

    def __init__(self, g, mu, mask, NAmu, NAsigma):
        self.g, self.mu, self.mask = g, mu, mask
        self.NAmu, self.NAsigma = NAmu, NAsigma

    def terms(self, t):
        gt = self.g * t[:, None]
        mu = self.mu
        K0 = torch.where(self.mask, torch.log(1.0 - mu + mu * torch.exp(gt)),
                         0.0).sum(1)
        e = torch.exp(-gt)
        den = (1.0 - mu) * e + mu
        K1 = torch.where(self.mask, mu * self.g / den, 0.0).sum(1)
        k2 = (1.0 - mu) * mu * self.g * self.g * e / (den * den)
        K2 = torch.where(self.mask & torch.isfinite(k2), k2, 0.0).sum(1)
        return K0, K1, K2

    def k1(self, t, q):
        return self.terms(t)[1] + self.NAmu + self.NAsigma * t - q

    def k2(self, t):
        return self.terms(t)[2] + self.NAsigma


def _root(cgf: _Cgf, q, g_pos, g_neg, tol: float, max_iter: int = 1000):
    """Newton's root of K1(t) = q with the jump damping of getroot_K1
    (a step that changes the sign of K1 by more than the last such jump
    is halved); (root, converged); a q outside (g_neg, g_pos) has the
    root inf and counts as converged."""
    out = (q >= g_pos) | (q <= g_neg)
    t = torch.zeros_like(q)
    root = torch.zeros_like(q)
    K1 = cgf.k1(t, q)
    jump = torch.full_like(q, math.inf)
    conv = torch.zeros_like(out)
    done = out.clone()
    for _ in range(max_iter):
        if bool(done.all()):
            break
        tn = t - K1 / cgf.k2(t)
        bad = ~torch.isfinite(tn)
        tn = torch.where(bad, t, tn)
        small = torch.abs(tn - t) < tol
        K1n = cgf.k1(tn, q)
        sign_change = torch.sign(K1) != torch.sign(K1n)
        damp = sign_change & (torch.abs(tn - t) > jump - tol)
        t2 = torch.where(damp, t + torch.sign(K1n - K1) * jump * 0.5, tn)
        if bool(damp.any()):
            K1n = torch.where(damp, cgf.k1(t2, q), K1n)
        jump2 = torch.where(damp, jump * 0.5, torch.where(
            sign_change, torch.abs(tn - t), jump))
        live = ~done
        fin = live & ~bad & small
        go = live & ~bad & ~small
        root = torch.where(go, t2, torch.where(fin, t, root))
        t = torch.where(go, t2, t)
        K1 = torch.where(go, K1n, K1)
        jump = torch.where(go, jump2, jump)
        conv = conv | fin
        done = done | fin | (live & bad)
    return torch.where(out, math.inf, root), torch.where(out, True, conv)


def _tail(cgf: _Cgf, t, q):
    """The Barndorff-Nielsen tail probability at the root ``t`` (0 where
    it is not finite)."""
    K0, _, K2 = cgf.terms(t)
    K = K0 + cgf.NAmu * t + 0.5 * cgf.NAsigma * t * t
    k2 = K2 + cgf.NAsigma
    w = torch.sign(t) * torch.sqrt(torch.clamp(2.0 * (t * q - K), min=0.0))
    v = t * torch.sqrt(torch.clamp(k2, min=0.0))
    z = w + torch.log(v / w) / w
    p = torch.where(z > 0, _norm_sf(z), -_norm_sf(-z))
    ok = torch.isfinite(t) & torch.isfinite(K) & torch.isfinite(k2) & \
        torch.isfinite(z)
    return torch.where(ok, torch.abs(p), 0.0)


def spa_pvalue(g_norm, nonzero, y, mu, var_ratio, cutoff: float = 2.0):
    """Saddlepoint p-values of rows ``g_norm`` [B, n] (adjusted genotypes
    over the minor allele count's root), the exact CGF over the samples
    of ``nonzero``: (pval, converged)."""
    mu2 = mu * (1.0 - mu)
    q = g_norm @ y
    m1 = g_norm @ mu
    var2 = (g_norm * g_norm) @ mu2
    var1 = var2 * var_ratio
    qt = (q - m1) / torch.sqrt(var1) * torch.sqrt(var2) + m1
    gm = torch.where(nonzero, g_norm, 0.0)
    cgf = _Cgf(g_norm, mu[None, :].expand_as(g_norm), nonzero,
               m1 - gm @ mu, var2 - (gm * gm) @ mu2)
    g_pos = torch.where(g_norm > 0, g_norm, 0.0).sum(1)
    g_neg = torch.where(g_norm < 0, g_norm, 0.0).sum(1)
    s = qt - m1
    qinv = m1 - s
    p_noadj = _chi2_sf(s * s / var2)
    r1, c1 = _root(cgf, qt, g_pos, g_neg, ROOT_TOL)
    r2, c2 = _root(cgf, qinv, g_pos, g_neg, ROOT_TOL)
    spa = _tail(cgf, r1, qt) + _tail(cgf, r2, qinv)
    both = c1 & c2
    below = torch.abs(s) / torch.sqrt(var2) < cutoff
    zero = (spa == 0) & (p_noadj > 0)
    big = (spa != 0) & (p_noadj / spa > 1000.0)
    p = torch.where(below | ~both | big | zero, p_noadj, spa)
    conv = torch.where(below, True, both & ~zero)
    return p, conv


def genotype_rows(G, mac_min: float, missing_max: float, dtype):
    """Int8 code rows ``G`` [B, n] (3 missing) as a test takes them: the
    ALT allele count ``ac``, frequency ``af`` and non-missing count
    ``num``, the dosages ``g`` with missing calls mean-imputed and
    flipped to the minor allele where ``flip``, the minor allele count
    ``mac``, and ``valid``, the rows that pass the filters:
    (g, af, ac, num, mac, flip, valid)."""
    n = G.shape[1]
    miss = G == 3
    raw = torch.where(miss, 0, G).to(dtype)
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


def scan_table(codes, y, mu, XV, XXVX_inv, var_ratio: float,
               spa_pval: float, mac_min: float, missing_max: float, dtype,
               device, rows: int = 128) -> dict:
    """The table of one binary model over int8 codes [V, n] (3 missing;
    the model's samples in the model's order): the tested variants'
    indices ``idx`` and their ``AF.alt``, ``mac``, ``num``, ``beta``,
    ``SE``, ``pval``, ``p.norm``, ``converged``, in ``dtype``."""
    c = lambda a: torch.as_tensor(a).to(device, dtype)
    y, mu, XV, XXVX_inv = c(y), c(mu), c(XV), c(XXVX_inv)
    mu2 = mu * (1.0 - mu)
    cols = {k: [] for k in ("idx", "AF.alt", "mac", "num", "beta", "SE",
                            "pval", "p.norm", "converged")}
    for s0 in range(0, codes.shape[0], rows):
        G = torch.as_tensor(codes[s0:s0 + rows]).to(device)
        g, af, ac, num, mac, flip, valid = genotype_rows(
            G, mac_min, missing_max, dtype)
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
