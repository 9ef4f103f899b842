"""User-facing Cauchy-combination helpers ``pACAT``/``pACAT2``
(reference R/saige_main.r:145-156), the counterparts of
``saigegds_tpu/utils/stats.py::acat_p`` and ``acat_p_maf``."""

from __future__ import annotations

import numpy as np

from ..ops.acat import acat_pval, beta_weights


def acat_p(pvals, weights=None) -> float:
    """Cauchy-combination p-value (pACAT)."""
    p = np.atleast_1d(np.asarray(pvals, dtype=np.float64))
    if p.size == 1:
        return float(p[0])
    return float(acat_pval(p, weights))


def acat_p_maf(pvals, maf, wbeta=(1.0, 25.0)) -> float:
    """pACAT2: weights dbeta(maf; b1, b2)^2 * maf * (1 - maf)."""
    maf = np.asarray(maf, dtype=np.float64)
    w = np.asarray(beta_weights(maf, wbeta[0], wbeta[1])) ** 2 * maf * (1.0 - maf)
    return acat_p(pvals, w)
