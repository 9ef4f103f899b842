"""Imputed ALT dosages drawn on the device from the seed, as an imputation
server's 8-bit output would hold them.

Per variant, an imputation info r^2 uniform in the configuration's
range; per sample, the true genotype G of Hardy-Weinberg at the
variant's ALT frequency p, and the posterior genotype probabilities
w onehot(G) + (1 - w) (HWE prior), w = sqrt(info): what an imputation
of that quality reports for a sample whose genotype is G.  Each
probability is rounded to a multiple of 1/``levels`` (the UK Biobank's
BGEN stores them in 8 bits, 255 levels; P(1) is cut so that the two
never sum past 1), and the dosage is P(1) + 2 P(2), stored as float32.
No dosage is missing."""

from __future__ import annotations

import numpy as np
import torch

from ..seeds import device_gen, host_rng

F64 = torch.float64


def variant_infos(v: int, info_range, seed: int) -> np.ndarray:
    """Imputation info r^2 of ``v`` variants, uniform in ``info_range``."""
    return host_rng(seed, "ds.info").uniform(info_range[0], info_range[1],
                                             v)


def imputed_dosages(af: np.ndarray, info: np.ndarray, n: int,
                    cols: np.ndarray, levels: int, seed: int, device,
                    truth_rows=(), step: int = 64):
    """Dosages of ``len(af)`` variants over ``n`` samples, drawn on
    ``device`` in chunks of ``step`` variants: (the GDS's float32
    dosages [V, n], float32 dosages [V, len(cols)] of the samples
    ``cols``, int8 true genotypes [len(truth_rows), len(cols)] of the
    variants ``truth_rows`` at those samples), all on the host."""
    gen = device_gen(seed, "ds.dosages", device)
    idx = torch.as_tensor(cols, device=device)
    V = len(af)
    gds = np.empty((V, n), np.float32)
    out = np.empty((V, len(cols)), np.float32)
    truth_rows = np.asarray(truth_rows, np.int64)
    truth = np.empty((len(truth_rows), len(cols)), np.int8)
    for s in range(0, V, step):
        e = min(s + step, V)
        shape = (e - s, n)
        p = torch.as_tensor(af[s:e], dtype=F64, device=device)[:, None]
        w = torch.sqrt(torch.as_tensor(info[s:e], dtype=F64,
                                       device=device))[:, None]
        g = (torch.rand(shape, generator=gen, device=device, dtype=F64)
             < p).to(torch.int8)
        g += (torch.rand(shape, generator=gen, device=device, dtype=F64)
              < p).to(torch.int8)
        p1 = w * (g == 1) + (1.0 - w) * 2.0 * p * (1.0 - p)
        p2 = w * (g == 2) + (1.0 - w) * p * p
        k2 = torch.round(levels * p2)
        k1 = torch.minimum(torch.round(levels * p1), levels - k2)
        d = ((k1 + 2.0 * k2) / levels).to(torch.float32)
        gds[s:e] = d.cpu().numpy()
        out[s:e] = d[:, idx].cpu().numpy()
        here = (truth_rows >= s) & (truth_rows < e)
        if here.any():
            rows = torch.as_tensor(truth_rows[here] - s, device=device)
            truth[here] = g[rows][:, idx].cpu().numpy()
    return gds, out, truth
