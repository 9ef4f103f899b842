"""The dense float64 GRM operator, ``v -> G_std' (G_std v) / M``: the test
oracle of the 2-bit operator (``ops/packed_grm.py``).

The counterpart of ``saigegds_tpu/ops/grm.py``.  The standardized matrix is
materialised in f64 on the device (8 B/genotype), so the product is two
plain matrix products.  Standardization (src/saige_fitnull.cpp:182-202):
per variant with allele frequency ``af`` over non-missing samples,
``s(g) = (g - 2 af) / sqrt(2 af (1-af))`` for g in {0,1,2} and
``s(missing) = 0``.
"""

from __future__ import annotations

import numpy as np
import torch

from ._cuda import check_device


class GRMOperator:
    """Device-resident standardized genotypes ``std_geno`` f64 [M, N] and
    ``diag`` f64 [N] = diag(GRM); ``matvecs`` counts the products taken,
    as on :class:`~.packed_grm.Packed2GRM`."""

    def __init__(self, std_geno: torch.Tensor, diag: torch.Tensor):
        self.std_geno = std_geno
        self.diag = diag
        self.n_variants, self.n_samples = std_geno.shape
        self.device = std_geno.device
        self.matvecs = 0

    def matvec(self, b: torch.Tensor) -> torch.Tensor:
        """GRM @ b for b [N] or [N, R] f64."""
        self.matvecs += 1
        return (self.std_geno.T @ (self.std_geno @ b)) / self.n_variants

    @classmethod
    def from_arrays(cls, std_geno, diag, *, device) -> "GRMOperator":
        """Carry a dense operator across as numpy arrays: the JAX
        package's ``GRMOperator`` fields ``std_geno`` [M, N] and ``diag``
        [N], as f64 on ``device``."""
        dev = check_device(device)
        f64 = lambda a: torch.tensor(np.asarray(a, np.float64), device=dev)
        return cls(f64(std_geno), f64(diag))


def std_lookup_table(codes: np.ndarray) -> np.ndarray:
    """Per-variant 4-value standardized lookup [M, 4] from int8 codes.

    codes: [M, N] with 0/1/2 dosage and 3 = missing (the ``buf_std_geno``
    analog, src/saige_fitnull.cpp:182-202)."""
    valid = codes < 3
    n_valid = valid.sum(axis=1)
    s = np.where(valid, codes, 0).sum(axis=1, dtype=np.int64)
    with np.errstate(divide="ignore", invalid="ignore"):
        af = s / (2.0 * n_valid)
        inv = 1.0 / np.sqrt(2.0 * af * (1.0 - af))
    bad = ~np.isfinite(af) | ~np.isfinite(inv)
    af = np.where(bad, 0.0, af)
    inv = np.where(bad, 0.0, inv)
    tab = np.empty((codes.shape[0], 4), dtype=np.float64)
    tab[:, 0] = (0.0 - 2.0 * af) * inv
    tab[:, 1] = (1.0 - 2.0 * af) * inv
    tab[:, 2] = (2.0 - 2.0 * af) * inv
    tab[:, 3] = 0.0
    return tab


def build_grm(codes: np.ndarray, *, device) -> GRMOperator:
    """Build the dense operator on ``device`` from int8 codes [M, N]."""
    tab = std_lookup_table(codes)
    std = np.take_along_axis(tab, codes.astype(np.int64), axis=1)
    diag = (std * std).sum(axis=0) / codes.shape[0]
    dev = check_device(device)
    return GRMOperator(torch.as_tensor(std, device=dev),
                       torch.as_tensor(diag, device=dev))
