"""The least time an NVIDIA H100 SXM could take for the scan's dense
phase 1 of one block (``ops/score.py`` ``score_stats_binary`` over
dosage rows, every model of a call): the larger of the bytes it must
move at the memory rate and the float64 operations it must do at the
FP64 tensor cores' rate.

At ``rows`` dosage rows of ``n`` samples, P models and K covariate
columns (the intercept with them):

* bytes: the block's payload as shipped (``payload_bytes``, float32 or
  float64 rows), read once, and each model's ``y - mu``, ``mu (1 - mu)``,
  ``XV`` [K, n] and ``XXVX_inv`` [n, K] in float64:
  ``payload_bytes + P * n * (2K + 2) * 8``;
* operations: ``P * rows * n * (4K + 6)`` (per dosage and model: the K
  covariate projections and the K-term adjustment, a multiply and an add
  each, the mean imputation and flip, the score and the variance).

The bound counts the work whatever does it, so a kernel that reads the
payload once for all the models cannot read over 100%."""

from __future__ import annotations

from .roofline import HBM_BYTES_S

F64_OPS_S = 67e12           # H100 SXM FP64 tensor-core rate (700 W)


def dense_bytes_ops(rows: int, n: int, P: int, K: int,
                    payload_bytes: int):
    return payload_bytes + P * n * (2 * K + 2) * 8, \
        P * rows * n * (4 * K + 6)


def dense_bound_s(rows: int, n: int, P: int, K: int,
                  payload_bytes: int) -> float:
    """Seconds at the memory rate or the operation rate, the larger."""
    nbytes, ops = dense_bytes_ops(rows, n, P, K, payload_bytes)
    return max(nbytes / HBM_BYTES_S, ops / F64_OPS_S)
