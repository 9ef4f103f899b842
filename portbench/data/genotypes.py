"""Genotype codes drawn on the device from the seed, in blocks of
variants (frozen from ``chip_smoke.py``'s ``make_fit_data`` and
``make_data``, without their ties to the smoke).

Codes are int8: 0, 1, 2 ALT alleles, 3 missing.  A draw is a pure
function of the seed, the sizes and the device, so the reference draws
the same codes again after the window instead of keeping them."""

from __future__ import annotations

import numpy as np
import torch

from ..seeds import device_gen, host_rng


class GrmMarkers:
    """The GRM markers of a fit configuration: ``m`` variants over ``n``
    samples, allele frequencies uniform in ``af_range``, a share
    ``missing`` of the calls missing; ``bases`` polygenic scores of unit
    genetic variance (effects drawn per base) for the phenotypes."""

    BLOCK = 1024

    def __init__(self, n: int, m: int, af_range, missing: float,
                 seed: int, device, bases: int = 8):
        self.n, self.m, self.missing = int(n), int(m), float(missing)
        self.seed, self.device = seed, torch.device(device)
        rng = host_rng(seed, "grm.af")
        self.af = rng.uniform(af_range[0], af_range[1], self.m)
        sd = np.sqrt(2.0 * self.af * (1.0 - self.af))
        self.beta = rng.normal(size=(self.m, bases)) / np.sqrt(self.m) \
            / sd[:, None]
        self.bases = bases

    def blocks(self):
        """Yield ``(row0, alleles, codes)`` per block on the device:
        ``alleles`` int8 [b, n] before the missing calls are set,
        ``codes`` int8 [b, n] with them."""
        gen = device_gen(self.seed, "grm.codes", self.device)
        for s in range(0, self.m, self.BLOCK):
            e = min(s + self.BLOCK, self.m)
            shape = (e - s, self.n)
            p = torch.as_tensor(self.af[s:e], dtype=torch.float32,
                                device=self.device)[:, None].expand(shape)
            g = (torch.rand(shape, generator=gen, device=self.device)
                 < p).to(torch.int8)
            g += (torch.rand(shape, generator=gen, device=self.device)
                  < p).to(torch.int8)
            codes = g.clone()
            codes[torch.rand(shape, generator=gen, device=self.device)
                  < self.missing] = 3
            yield s, g, codes

    def code_blocks(self):
        """``(row0, codes)`` per block on the device."""
        for s, _g, codes in self.blocks():
            yield s, codes


def scan_variant_afs(v: int, spectrum: dict, alt_major: float,
                     seed: int) -> np.ndarray:
    """ALT allele frequencies of ``v`` scanned variants: shares of the
    MAF classes of ``spectrum`` ({class: [share, lo, hi, "log"|"uniform"]}),
    a share ``alt_major`` of the variants ALT-major."""
    rng = host_rng(seed, "scan.af")
    u = rng.random(v)
    maf = np.empty(v)
    edge = 0.0
    for _name, (share, lo, hi, kind) in spectrum.items():
        sel = (u >= edge) & (u < edge + share)
        k = int(sel.sum())
        maf[sel] = np.exp(rng.uniform(np.log(lo), np.log(hi), k)) \
            if kind == "log" else rng.uniform(lo, hi, k)
        edge += share
    if not np.isclose(edge, 1.0):
        raise ValueError(f"the MAF classes' shares sum to {edge}, not 1")
    return np.where(rng.random(v) < alt_major, 1.0 - maf, maf)


def scan_codes(af: np.ndarray, n: int, cols: np.ndarray, missing: float,
               seed: int, device, step: int = 256):
    """Codes of ``len(af)`` variants over ``n`` samples, drawn on
    ``device`` in chunks of ``step`` variants: (the GDS's dBit2 bytes
    uint8 [V, n / 2], int8 codes [V, len(cols)] of the samples ``cols``),
    both on the host."""
    from .gds import dbit2_rows
    gen = device_gen(seed, "scan.codes", device)
    idx = torch.as_tensor(cols, device=device)
    geno = np.empty((len(af), n // 2), np.uint8)
    out = np.empty((len(af), len(cols)), np.int8)
    for s in range(0, len(af), step):
        e = min(s + step, len(af))
        shape = (e - s, n)
        p = torch.as_tensor(af[s:e], dtype=torch.float32,
                            device=device)[:, None].expand(shape)
        g = (torch.rand(shape, generator=gen, device=device) < p).to(
            torch.int8)
        g += (torch.rand(shape, generator=gen, device=device) < p).to(
            torch.int8)
        g[torch.rand(shape, generator=gen, device=device) < missing] = 3
        geno[s:e] = dbit2_rows(g).cpu().numpy()
        out[s:e] = g[:, idx].cpu().numpy()
    return geno, out
