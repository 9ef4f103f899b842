"""The GRM of a fit configuration, plainly: ``GRM = Z' Z / M`` with
``Z[j, i] = (c_ij - 2 af_j) / sqrt(2 af_j (1 - af_j))`` for the codes
``c_ij`` in {0, 1, 2} of marker j and sample i, ``Z[j, i] = 0`` where the
call is missing (code 3), and ``af_j`` the ALT frequency over the
non-missing calls (a marker without variation has a zero row).  ``Z`` is
held whole on the device."""

from __future__ import annotations

import torch


class PlainGRM:
    """Built from ``(row0, int8 codes [b, n])`` blocks on the device that
    hold ``m`` markers in all, in ``dtype``: ``af``, ``inv`` [m], ``diag``
    [n] = diag(GRM), the missing calls as ``pairs_samp`` (their samples,
    by marker then sample) and ``pairs_start`` [m] (where each marker's
    pairs start); :meth:`matvec` is ``GRM @ b``."""

    def __init__(self, blocks, n: int, m: int, dtype, device):
        self.m, self.n, self.dtype = m, n, dtype
        self.Z = torch.empty(m, n, dtype=dtype, device=device)
        self.af = torch.empty(m, dtype=dtype, device=device)
        self.inv = torch.empty(m, dtype=dtype, device=device)
        self.diag = torch.zeros(n, dtype=dtype, device=device)
        samp, counts = [], []
        for s, codes in blocks:
            e = s + codes.shape[0]
            valid = codes < 3
            c = torch.where(valid, codes, 0).to(dtype)
            a = c.sum(1) / (2.0 * valid.sum(1).to(dtype))
            iv = 1.0 / torch.sqrt(2.0 * a * (1.0 - a))
            bad = ~torch.isfinite(a) | ~torch.isfinite(iv)
            a = torch.where(bad, 0.0, a)
            iv = torch.where(bad, 0.0, iv)
            z = torch.where(valid, (c - 2.0 * a[:, None]) * iv[:, None], 0.0)
            self.Z[s:e] = z
            self.diag += (z * z).sum(0)
            self.af[s:e], self.inv[s:e] = a, iv
            miss = ~valid
            counts.append(miss.sum(1))
            samp.append(torch.nonzero(miss)[:, 1])
        self.diag /= m
        self.pairs_samp = torch.cat(samp)
        counts = torch.cat(counts)
        self.pairs_start = torch.cumsum(counts, 0) - counts

    def matvec(self, b: torch.Tensor) -> torch.Tensor:
        """GRM @ b for b [n] or [n, R], in this GRM's dtype."""
        b = b.to(self.dtype)
        return self.Z.T @ (self.Z @ b) / self.m
