"""VCF -> SeqArray-GDS converter.

The reference delegates VCF ingestion to the SeqArray R package
(``seqVCF2GDS``); this is the framework-native equivalent: parse ``GT``
fields into 0/1/2/missing ALT-dosage codes (or ``DS`` fields into float
dosages) and emit a genotype (or ``annotation/format/DS``) GDS via
:mod:`saigegds_tpu.io.gds_write`.

Scope (documented):

- diploid GT (haploid calls count the single allele once), ``.`` = missing;
- multi-allelic rows: either skipped (``split_multiallelic=False``) or
  split into one biallelic record per ALT allele, bcftools-norm style —
  other ALT alleles count as REF for the split record;
- ``DS`` fields: ``Number=A`` comma lists supported under splitting;
- plain and gzip/BGZF-compressed files.
"""

from __future__ import annotations

import gzip
from typing import Optional

import numpy as np


def _open(path: str):
    if path.endswith(".gz") or path.endswith(".bgz"):
        return gzip.open(path, "rt")
    return open(path, "rt")


def _iter_vcf_rows(path: str):
    """Yield (samples, parts) for each data row; samples from #CHROM."""
    samples = None
    with _open(path) as f:
        for line in f:
            if line.startswith("##"):
                continue
            if line.startswith("#CHROM"):
                samples = line.rstrip("\n").split("\t")[9:]
                continue
            if samples is None:
                raise ValueError("VCF missing #CHROM header line")
            parts = line.rstrip("\n").split("\t")
            if len(parts) == 9 + len(samples):
                yield samples, parts
            elif len(parts) >= 10:
                raise ValueError(
                    f"VCF data line has {len(parts) - 9} sample fields, "
                    f"header declares {len(samples)}")


def _gt_row(parts, gt_i, n_samples, alt_k):
    """ALT-allele-``alt_k`` dosage codes for one row (3 = missing)."""
    row = np.empty(n_samples, np.int8)
    tgt = str(alt_k)
    for j, cell in enumerate(parts[9:]):
        gt = cell.split(":")[gt_i] if cell not in (".", "") else "."
        alleles = gt.replace("|", "/").split("/")
        ds = 0
        missing = False
        for a in alleles:
            if a in (".", ""):
                missing = True
                break
            ds += int(a == tgt)
        row[j] = 3 if missing else min(ds, 2)
    return row


def read_vcf_codes(path: str, max_variants: Optional[int] = None,
                   split_multiallelic: bool = False):
    """Parse VCF GT fields into (codes [M, N] int8, meta dict).

    meta: sample_id, variant_id (1..M), position, chromosome, allele
    ("REF,ALT"), rs_id, n_multiallelic_skipped.
    """
    samples = None
    rows = []
    chrom, pos, rsid, allele = [], [], [], []
    n_multi = 0
    for samples, parts in _iter_vcf_rows(path):
        ref, alt = parts[3], parts[4]
        alts = alt.split(",")
        if len(alts) > 1 and not split_multiallelic:
            n_multi += 1
            continue
        fmt = parts[8].split(":")
        try:
            gt_i = fmt.index("GT")
        except ValueError:
            continue
        for k, alt_k in enumerate(alts, start=1):
            rows.append(_gt_row(parts, gt_i, len(samples), k))
            chrom.append(parts[0])
            pos.append(int(parts[1]))
            rsid.append(parts[2])
            allele.append(f"{ref},{alt_k}")
        if max_variants and len(rows) >= max_variants:
            del rows[max_variants:]       # a split row can overshoot
            del chrom[max_variants:], pos[max_variants:]
            del rsid[max_variants:], allele[max_variants:]
            break
    codes = np.stack(rows) if rows else np.empty((0, len(samples or [])),
                                                 np.int8)
    meta = dict(sample_id=np.asarray(samples if samples is not None else [],
                                     dtype=object),
                variant_id=np.arange(1, len(rows) + 1, dtype=np.int32),
                position=np.asarray(pos, np.int32),
                chromosome=np.asarray(chrom, object),
                allele=np.asarray(allele, object),
                rs_id=np.asarray(rsid, object),
                n_multiallelic_skipped=n_multi)
    return codes, meta


def read_vcf_dosages(path: str, max_variants: Optional[int] = None,
                     split_multiallelic: bool = False):
    """Parse VCF DS fields into (dosages [M, N] float64, meta dict).

    DS is the imputed ALT-dosage FORMAT field (``Number=A``); missing or
    absent cells become NaN.  Rows without DS in FORMAT are skipped
    (counted in meta["n_no_ds_skipped"]).
    """
    samples = None
    rows = []
    chrom, pos, rsid, allele = [], [], [], []
    n_multi = n_nods = 0
    for samples, parts in _iter_vcf_rows(path):
        ref, alt = parts[3], parts[4]
        alts = alt.split(",")
        if len(alts) > 1 and not split_multiallelic:
            n_multi += 1
            continue
        fmt = parts[8].split(":")
        try:
            ds_i = fmt.index("DS")
        except ValueError:
            n_nods += 1
            continue
        cells = []
        for cell in parts[9:]:
            fields = cell.split(":")
            cells.append(fields[ds_i] if ds_i < len(fields) else ".")
        for k, alt_k in enumerate(alts):
            row = np.empty(len(samples), np.float64)
            for j, c in enumerate(cells):
                vals = c.split(",")
                v = vals[k] if k < len(vals) else "."
                row[j] = np.nan if v in (".", "") else float(v)
            rows.append(row)
            chrom.append(parts[0])
            pos.append(int(parts[1]))
            rsid.append(parts[2])
            allele.append(f"{ref},{alt_k}")
        if max_variants and len(rows) >= max_variants:
            break
    ds = np.stack(rows) if rows else np.empty((0, len(samples or [])))
    meta = dict(sample_id=np.asarray(samples if samples is not None else [],
                                     dtype=object),
                variant_id=np.arange(1, len(rows) + 1, dtype=np.int32),
                position=np.asarray(pos, np.int32),
                chromosome=np.asarray(chrom, object),
                allele=np.asarray(allele, object),
                rs_id=np.asarray(rsid, object),
                n_multiallelic_skipped=n_multi, n_no_ds_skipped=n_nods)
    return ds, meta


def vcf_to_gds(vcf_path: str, gds_path: str,
               max_variants: Optional[int] = None,
               field: str = "GT", split_multiallelic: bool = False) -> int:
    """Convert a VCF to a SeqArray-style GDS; returns n variants written.

    field="GT": 2-bit genotype node (hard calls).
    field="DS": float dosages under ``annotation/format/DS``.
    """
    from .gds_write import write_seqarray_gds, write_dosage_gds

    if field == "GT":
        codes, meta = read_vcf_codes(vcf_path, max_variants=max_variants,
                                     split_multiallelic=split_multiallelic)
        write_seqarray_gds(gds_path, codes,
                           sample_id=meta["sample_id"],
                           variant_id=meta["variant_id"],
                           position=meta["position"],
                           chromosome=meta["chromosome"],
                           allele=meta["allele"],
                           rs_id=meta["rs_id"])
        return codes.shape[0]
    if field == "DS":
        ds, meta = read_vcf_dosages(vcf_path, max_variants=max_variants,
                                    split_multiallelic=split_multiallelic)
        write_dosage_gds(gds_path, ds,
                         sample_id=meta["sample_id"],
                         variant_id=meta["variant_id"],
                         position=meta["position"],
                         chromosome=meta["chromosome"],
                         allele=meta["allele"],
                         rs_id=meta["rs_id"])
        return ds.shape[0]
    raise ValueError(f"field must be 'GT' or 'DS', got {field!r}")
