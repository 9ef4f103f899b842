"""Cauchy-combination (ACAT) p-value and the aggregate tests' beta weights.

The counterpart of ``saigegds_tpu/ops/acat.py``: the same host numpy
arithmetic, returning a numpy array where the original wraps its result
for jax.  ``acat_pval`` reimplements the reference's ``acat_pval``
(src/saige_main.cpp:989-1051, Liu & Xie 2020): T = sum_i w_i tan(pi (0.5 -
p_i)) / sum w, with a Taylor-series branch for p < 1e-15 and the Cauchy
tail formula 1/(pi T) for huge T.  Supports a batch axis.
"""

import math

import numpy as np

_ROUND_ZERO = 1e-300
_ROUND_ONE = 1.0 - 1e-16


def acat_pval(pvals, weights=None, axis=-1) -> np.ndarray:
    """Cauchy combination of p-values along `axis` (NaN entries skipped).

    Returns NaN when no finite (pval, weight) pair exists or weights sum
    to <= 0, mirroring the reference's non-throwing path.  libm's tan is
    what R's tanpi calls, so this is the reference's arithmetic.
    """
    p = np.asarray(pvals, dtype=np.float64)
    w = np.ones_like(p) if weights is None else \
        np.broadcast_to(np.asarray(weights, dtype=np.float64), p.shape)
    ok = np.isfinite(p) & np.isfinite(w)
    # a finite p outside [0, 1] is bad input: the whole combination is
    # NaN like the reference (src/saige_main.cpp:1024-1030), NOT clipped
    bad = (ok & ((p < 0.0) | (p > 1.0))).any(axis=axis)
    sumw = np.where(ok, w, 0.0).sum(axis=axis)

    pc = np.clip(p, _ROUND_ZERO, _ROUND_ONE)
    # tan(pi*(0.5-p)) exactly as Rmath's tanpi evaluates it; the series
    # 1/(pi p) for p < 1e-15 (src/saige_main.cpp:1035-1043)
    with np.errstate(divide="ignore", invalid="ignore"):
        t_big = np.tan(np.pi * (0.5 - pc))
        t_small = 1.0 / pc / np.pi
        terms = np.where(pc >= 1e-15, t_big, t_small)
        Tstat = np.where(ok, w * terms, 0.0).sum(axis=axis) / sumw

        out = np.where(Tstat <= 5e14,
                       0.5 - np.arctan(Tstat) / np.pi,
                       1.0 / Tstat / np.pi)
    return np.where(bad | ~(sumw > 0), np.nan, out)


def beta_weights(maf, b1, b2):
    """dbeta(maf, b1, b2) weights used by the aggregate tests, host-side
    in full double precision.  Matches R's dbeta at the boundaries: x=0 is
    b2/B-finite when b1 == 1 (NOT the 0*log(0) NaN of the log form) —
    monomorphic SNPs carry a finite weight in the reference and rescale
    the unit's normalization."""
    maf = np.asarray(maf, dtype=np.float64)
    lbeta = math.lgamma(b1) + math.lgamma(b2) - math.lgamma(b1 + b2)
    with np.errstate(divide="ignore", invalid="ignore"):
        logpdf = (b1 - 1.0) * np.log(maf) \
            + (b2 - 1.0) * np.log1p(-maf) - lbeta
        out = np.exp(logpdf)

    def _edge(shape, other):   # R dbeta density at the boundary
        if shape < 1.0:
            return np.inf
        return float(other) if shape == 1.0 else 0.0

    out = np.where(maf == 0.0, _edge(b1, b2), out)
    out = np.where(maf == 1.0, _edge(b2, b1), out)
    return out
