"""User-facing statistical utilities, the counterparts of
``saigegds_tpu/utils/stats.py``: the Cauchy combinations ``pACAT``/
``pACAT2`` (reference R/saige_main.r:145-156), ``glmmHeritability``
(R/saige_main.r:666-691) and ``seqSAIGE_LoadPval`` (R/saige_main.r:
164-215).  Tables are dicts of numpy columns."""

from __future__ import annotations

import csv
import gzip
from typing import Sequence, Union

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


def glmm_heritability(model, adjust: bool = True) -> float:
    """Heritability estimate from a fitted null model (glmmHeritability).

    binary: h2 = tau_G / (pi^2/3 + tau_G), scaled (``adjust=True``) to the
    liability scale with r = 2.970 + 0.372*log10(p) where p is the observed
    case fraction of the model's y (Zhou et al. 2018, Supp. Table 7;
    reference R/saige_main.r:666-691).
    quantitative: h2 = tau_G / (tau_E + tau_G).
    """
    from ..models.nullmodel import NullModel
    m = NullModel.load(model)
    tau = np.asarray(m.tau, dtype=float)
    if m.trait_type == "binary":
        r = 1.0
        if adjust:
            p = float(np.mean(np.asarray(m.y) == 1))
            r = 2.970 + 0.372 * np.log10(p)
        return float(tau[1] / (np.pi ** 2 / 3.0 + tau[1]) * r)
    if m.trait_type == "quantitative":
        return float(tau[1] / (tau[0] + tau[1]))
    raise ValueError(f"unknown trait type {m.trait_type!r}")


_NA = {"", "NA", "NaN", "nan", "N/A", "NULL", "null", "None"}


def _parse_column(vals: list) -> np.ndarray:
    """Text cells -> a numpy column, with the types pandas' reader infers:
    bool for True/False, int64 for integers without a missing cell,
    float64 for numbers (a missing cell is NaN), else str."""
    if vals and all(v in ("True", "False") for v in vals):
        return np.asarray([v == "True" for v in vals])
    present = [v for v in vals if v not in _NA]
    try:
        if len(present) == len(vals):
            return np.asarray([int(v) for v in vals], np.int64)
    except ValueError:
        pass
    try:
        return np.asarray([float(v) if v not in _NA else np.nan
                           for v in vals], np.float64)
    except ValueError:
        return np.asarray(vals, dtype=object)


def read_table(path: str, sep: str) -> dict:
    """A delimited text file with a header row (plain or gzip) -> a dict
    of numpy columns typed by :func:`_parse_column`."""
    opener = gzip.open if path.lower().endswith(".gz") else open
    with opener(path, "rt", newline="") as f:
        rows = list(csv.reader(f, delimiter=sep))
    header, body = rows[0], [r for r in rows[1:] if r]
    return {h: _parse_column([r[j] if j < len(r) else "" for r in body])
            for j, h in enumerate(header)}


def _read_result(fn: str, columns=None) -> dict:
    low = fn.lower()
    if low.endswith((".rds", ".rda", ".rdata")):
        from ..io.rds import read_rdata, read_rds, strip
        if low.endswith(".rds"):
            obj = read_rds(fn)
        else:
            # .rda/.RData container: the single stored object, like the
            # reference's get(load(fn)) (R/saige_main.r:191-194)
            obj = next(iter(read_rdata(fn).values()))
        return {k: np.asarray(strip(obj[k])) for k in obj.names}
    if low.endswith(".gds"):
        # reference SAIGE_OUTPUT / SAIGE_OUTPUT_SET files (the gds branch
        # of seqSAIGE_LoadPval, R/saige_main.r:176-191)
        from ..io.gds import open_gds
        f = open_gds(fn)
        fmt = f.root.attrs.get("FileFormat", "")
        fmt = fmt[0] if isinstance(fmt, list) else fmt
        if fmt not in ("SAIGE_OUTPUT", "SAIGE_OUTPUT_SET"):
            raise ValueError("FileFormat should be 'SAIGE_OUTPUT' or "
                             f"'SAIGE_OUTPUT_SET', got {fmt!r}")
        return {nm: np.asarray(f.root[nm].read()) for nm in f.root.ls()
                if nm != "sample.id" and not f.root[nm].is_folder
                and (columns is None or nm in columns)}
    if low.endswith(".parquet"):
        raise NotImplementedError(
            f"reading {fn!r}: parquet needs pandas and pyarrow, which the "
            "PyTorch port does not use (ROADMAP, Not ported)")
    return read_table(fn, "," if low.endswith((".csv", ".csv.gz"))
                      else "\t")


def load_pval(files: Union[str, Sequence[str]], columns=None,
              index=None) -> dict:
    """Load and row-bind association result files (seqSAIGE_LoadPval):
    ``.gds`` (the reference's SAIGE_OUTPUT files and this package's),
    ``.rds``/``.rda``, ``.csv`` and tab-separated text.  ``columns``
    subsets columns; ``index`` subsets the rows of a single file (like the
    reference, it is rejected for several files).  Columns missing from a
    file are NaN in its rows.  Returns a dict of numpy columns."""
    if index is not None and not isinstance(files, str) and len(files) > 1:
        raise ValueError("'index' should be None for multiple input files")
    if isinstance(files, str):
        files = [files]
    parts = [_read_result(fn, columns) for fn in files]
    names = list(dict.fromkeys(k for p in parts for k in p))
    out = {}
    for k in names:
        vals = [p[k] if k in p else
                np.full(len(next(iter(p.values()))), np.nan) for p in parts]
        out[k] = np.concatenate(vals) if len(vals) > 1 else vals[0]
    if columns is not None:
        out = {k: out[k] for k in columns}
    if index is not None:
        out = {k: v[np.asarray(index)] for k, v in out.items()}
    return out
