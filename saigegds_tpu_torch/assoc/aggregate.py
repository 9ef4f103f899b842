"""Aggregate (gene/region/set) association tests: burden, ACAT-V, ACAT-O.

The counterpart of ``saigegds_tpu/assoc/aggregate.py`` over a GDS genotype
node or imputed dosages (the burden test for a binary or a quantitative
trait, ACAT-V and ACAT-O for a binary one): ``seqAssocGLMM_spaBurden`` /
``spaACAT_V`` / ``spaACAT_O`` (reference ``R/assoc_aggregate.r``; C
engines src/saige_main.cpp:465-985).  Each unit's SNPs are reduced to
test vectors — weighted burden collapses, and single SNPs for ACAT-V —
that run through the same score + SPA kernels as the single-variant scan.

Unit rows come from `_UnitSource` (random access to the GDS frames for
big files).  For hard calls the burden collapse runs on the device
(`_Kernel.run_jobs` -> ``ops/score_packed.burden_score_packed``): a batch
of units ships once, gap-coded sparse (kernel B5 decodes it) or 2-bit,
and the weighted mean-impute + flip collapse is an affine map of the
codes, so the host never uploads 8 B/sample rows.  ACAT-V's single SNPs
stream as int8 code batches through ``_packed_parts`` (sparse: B5 then
B4; 2-bit: B3).  Dosages (a DS node, or ``dsnode="$dosage_alt"``) are
collapsed on the host and stream as f64 rows through `_Kernel.run_stream`:
a batch whose rows are all 0/1/2/NaN goes the packed way as codes, any
other the dense f64 score test.  SPA-flagged rows refine in
bounded-memory flushes (`_SpaAccum`).  ``shard_units`` splits a unit list
over hosts.

Semantics reproduced exactly:
* per-SNP MAF/MAC from non-missing genotypes (``ds_mat_mafmac``, :486-524);
* burden collapse with beta(maf; b1, b2) weights normalised to sum 1,
  mean imputation and minor-allele flip per SNP (``ds_mat_burden``,
  :526-610); weighted-sum MAC threshold ``summac`` (:652);
* ACAT-V: SNPs with MAC >= ``acatv_mac`` tested singly, the rare remainder
  collapsed into one burden; Cauchy combination with weights
  dbeta(maf)^2 maf (1-maf) (:734-833);
* ACAT-O: Cauchy combination of the burden + ACAT-V p-values across all
  weight schemes (:848-976).
ACAT-V / ACAT-O are binary-trait only, like the reference (:836-842).

Tables are ordered ``dict``s of numpy columns, with the JAX package's
column names and order.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ..config import AggregateConfig
from ..io.seqarray import SeqData
from ..models.nullmodel import NullModel
from ..ops._cuda import check_device
from ..ops.acat import beta_weights
from ..ops.score import ScanModel, ScanParams, score_stats_binary, \
    score_stats_quant, spa_refine_binary, stack_stats, unstack_stats
from ..ops.score_packed import BURDEN_S_CAP, burden_score_packed, \
    pack_scan_model, score_stats_binary_packed, score_stats_quant_packed
from ..ops.sparse_codes import encode_sparse_rows
from ..utils.stats import acat_p
from .single import CHECK_ELEMS, DEPTH, SPA_FLUSH_BYTES, _match_samples, \
    _pack2_block, _packed_parts, _shrink_f32, _spa_batches, _spa_caps, \
    _spa_nnz, _to_device

SINGLE_FETCH = 512   # variants per random-access fetch in the singles stream
MAX_SPAN = 8192      # variants per contiguous dosage read of a unit
R_CAP = 64           # burden rows per batch (BURDEN_S_CAP source rows)
_STATS = ("valid", "af", "mac", "num", "beta", "se", "pval")
_SUMMARY = ("maf_avg", "maf_sd", "maf_min", "maf_max",
            "mac_avg", "mac_sd", "mac_min", "mac_max")


@dataclass
class VariantUnits:
    """A list of variant-index units (the SeqUnitListClass analog)."""

    desp: dict                      # unit descriptors: name -> numpy column
    index: List[np.ndarray]         # 0-based variant indices per unit

    def __len__(self):
        return len(self.index)


def sliding_windows(seq: SeqData, win_size: int = 10000, win_shift: int = 5000,
                    dup_rm: bool = True, variant_mask=None) -> VariantUnits:
    """Sliding windows over basepair positions per chromosome
    (the ``seqUnitSlidingWindows`` analog; reference test_SAIGE.R:119).

    ``variant_mask`` restricts the windows to a variant selection (build
    one with :meth:`SeqData.variant_selection`)."""
    chrom = np.asarray(seq.chromosome)
    pos = np.asarray(seq.position)
    keep = np.ones(len(chrom), bool) if variant_mask is None \
        else np.asarray(variant_mask, bool)
    desp_rows = []
    index = []
    for ch in dict.fromkeys(chrom[keep].tolist()):   # order of appearance
        m = (chrom == ch) & keep
        p = pos[m]
        idx = np.flatnonzero(m)
        lo, hi = int(p.min()), int(p.max())
        start = lo
        prev = None
        while start <= hi:
            end = start + win_size - 1
            sel = idx[(p >= start) & (p <= end)]
            if len(sel) > 0:
                # full selection as the dup key (SeqArray compares the whole
                # unit; first/last/count can collide when positions are
                # unsorted within a chromosome)
                key = sel.tobytes()
                if not (dup_rm and key == prev):
                    desp_rows.append((ch, start, end))
                    index.append(sel)
                    prev = key
            start += win_shift
    desp = {"chr": np.asarray([r[0] for r in desp_rows], object),
            "start": np.asarray([r[1] for r in desp_rows], np.int64),
            "end": np.asarray([r[2] for r in desp_rows], np.int64)}
    return VariantUnits(desp=desp, index=index)


def units_from_groups(seq: SeqData, groups: dict) -> VariantUnits:
    """Units from {name: [variant ids]} (gene sets)."""
    vid_pos = {v: i for i, v in enumerate(seq.variant_id)}
    index = [np.asarray([vid_pos[v] for v in vids if v in vid_pos],
                        dtype=np.int64) for vids in groups.values()]
    return VariantUnits(desp={"set": np.asarray(list(groups), object)},
                        index=index)


def shard_units(units: VariantUnits, shard: int, n_shards: int
                ) -> VariantUnits:
    """Contiguous unit slice for host ``shard`` of ``n_shards`` (the
    multi-host ``seqUnitApply(parallel=)`` analog): per-unit results are
    independent, so the concatenated per-shard tables equal one run."""
    if not (0 <= shard < n_shards):
        raise ValueError(f"shard {shard} outside [0, {n_shards})")
    bounds = np.linspace(0, len(units), n_shards + 1).astype(int)
    lo, hi = bounds[shard], bounds[shard + 1]
    return VariantUnits(desp={k: v[lo:hi] for k, v in units.desp.items()},
                        index=units.index[lo:hi])


# ---------------------------------------------------------------------------


def _tick(inst: dict, key: str, t0: float):
    inst[key] = inst.get(key, 0.0) + time.perf_counter() - t0


def _maf_mac(ds: np.ndarray):
    """Per-SNP minor AF / minor AC over non-missing dosages [S, N]."""
    finite = np.isfinite(ds)
    n = finite.sum(axis=1)
    s = np.where(finite, ds, 0.0).sum(axis=1)
    with np.errstate(invalid="ignore", divide="ignore"):
        af = s / (2.0 * n)
    maf = np.where(n > 0, np.minimum(af, 1.0 - af), np.nan)
    mac = np.minimum(s, 2.0 * n - s)
    return maf, mac


def _burden_collapse(ds: np.ndarray, weights: np.ndarray,
                     t: "_CodeTallies" = None) -> np.ndarray:
    """Weighted burden dosage vector from f64 dosages [S, N] (NaN =
    missing), or int8 codes [S, N] (3 = missing) with their tallies, and
    weights [S] -> [N] f64.

    Per SNP: mean-impute missing, flip to minor allele when sum > n
    (``ds_mat_burden``, src/saige_main.cpp:526-610).  Reference quirks
    kept: a non-finite weight skips the SNP ENTIRELY (:536); an
    all-missing SNP with a finite weight imputes its NaN mean into every
    sample; and the mean/flip bookkeeping accumulates dosages into an
    ``int`` (:590), so fractional dosages are floor-truncated for the
    imputation mean and the flip decision while the contributions use the
    raw values."""
    if ds.dtype == np.int8:
        return _burden_collapse_codes(ds, weights,
                                      _CodeTallies(ds) if t is None else t)
    finite = np.isfinite(ds)
    n = finite.sum(axis=1)
    # the reference's `int sum`: per-add truncation of nonnegative dosages
    # onto an integer accumulator == sum of floors
    s = np.where(finite, np.floor(ds), 0.0).sum(axis=1)
    with np.errstate(invalid="ignore"):
        mean = s / n
    use = np.isfinite(weights)
    flip = s > n
    g = np.where(finite, ds, mean[:, None])
    g = np.where(flip[:, None], 2.0 - g, g)
    w = np.where(use, weights, 0.0)
    return (np.where(use[:, None], g, 0.0) * w[:, None]).sum(axis=0)


def _burden_collapse_codes(codes: np.ndarray, weights: np.ndarray,
                           t: "_CodeTallies") -> np.ndarray:
    """:func:`_burden_collapse` of int8 codes.  The JAX package sums the
    weighted [S, N] f64 matrix over its first axis, one SNP after another;
    this adds the same terms in the same order without building that
    matrix, so the result is the same."""
    out = np.zeros(codes.shape[1])
    for s in np.flatnonzero(np.isfinite(weights)):
        c = codes[s]
        g = np.where(c == 3, t.mean[s], c.astype(np.float64))
        if t.flip[s]:
            g = 2.0 - g
        out += g * weights[s]
    return out


def _as_codes(G: np.ndarray) -> Optional[np.ndarray]:
    """int8 codes (3 = missing) of f64 rows that are all 0/1/2/NaN, else
    None.  Checked in chunks of rows, so a block with a fractional dosage
    stops at its first such chunk."""
    codes = np.empty(G.shape, np.int8)
    step = max(1, CHECK_ELEMS // max(G.shape[-1], 1))
    with np.errstate(invalid="ignore"):
        for s in range(0, len(G), step):
            g = G[s : s + step]
            nan = np.isnan(g)
            if not np.all(nan | ((g == np.floor(g)) & (g >= 0) & (g <= 2))):
                return None
            codes[s : s + step] = np.where(nan, 3, g)
    return codes


def _normalize(w: np.ndarray) -> np.ndarray:
    s = np.nansum(np.where(np.isfinite(w), w, np.nan))
    if s > 0:
        return np.where(np.isfinite(w), w / s, w)
    return w


class _CodeTallies:
    """Per-SNP reductions of an int8 code block [S, N] (3 = missing): the
    MAF/MAC, mean and flip of the reference's ``ds_mat_mafmac`` and
    ``ds_mat_burden``."""

    def __init__(self, codes: np.ndarray):
        miss = codes == 3
        self.n_miss = miss.sum(axis=1).astype(np.float64)
        N = codes.shape[1]
        self.n = N - self.n_miss
        self.s = np.where(miss, 0, codes).sum(axis=1,
                                              dtype=np.int64).astype(float)
        with np.errstate(invalid="ignore", divide="ignore"):
            af = self.s / (2.0 * self.n)
            self.mean = self.s / self.n
        self.maf = np.where(self.n > 0, np.minimum(af, 1.0 - af), np.nan)
        self.mac = np.minimum(self.s, 2.0 * self.n - self.s)
        self.flip = self.s > self.n


class _BurdenJob:
    """One unit's device-collapse job: codes ship once, the weighted
    burden rows are built on the device (``burden_score_packed``).

    ``A``/``Bm`` [R, S] and ``C`` [R] are the affine coefficients of the
    reference's mean-impute + minor-flip + weight collapse; ``wrows``
    keeps the original (NaN-masked) weights so SPA-flagged rows can be
    rebuilt host-side for phase 2."""

    __slots__ = ("codes", "wrows", "tallies", "A", "Bm", "C", "row_sums")

    def __init__(self, codes: np.ndarray, wrows: np.ndarray,
                 t: _CodeTallies):
        wrows = np.atleast_2d(np.asarray(wrows, np.float64))
        use = np.isfinite(wrows)                          # [R, S]
        wz = np.where(use, wrows, 0.0)
        sign = np.where(t.flip, -1.0, 1.0)
        A = wz * sign[None, :]
        bad = ~np.isfinite(t.mean)                        # all-missing SNPs
        mean = np.where(bad, 0.0, t.mean)
        Bm = A * mean[None, :]
        if bad.any():
            A = A.copy()
            A[:, bad] = 0.0
        C = 2.0 * (wz * t.flip[None, :]).sum(axis=1)
        if bad.any():
            # a NaN weight skips the SNP entirely (src/saige_main.cpp:536),
            # so an all-missing SNP only poisons rows that give it a FINITE
            # weight (its NaN imputation mean then reaches every sample)
            C[use[:, bad].any(axis=1)] = np.nan
        N = codes.shape[1]
        self.codes, self.wrows, self.tallies = codes, wrows, t
        self.A, self.Bm, self.C = A, Bm, C
        self.row_sums = A @ t.s + Bm @ t.n_miss + N * C

    def host_row(self, r: int) -> np.ndarray:
        """Rebuild row r on the host (phase-2 SPA needs the dosage
        vector)."""
        return _burden_collapse(self.codes, self.wrows[r], self.tallies)

    def subset(self, rows) -> "_BurdenJob":
        """Keep only the given row indices (summac pre-filtering)."""
        job = object.__new__(_BurdenJob)
        job.codes, job.tallies = self.codes, self.tallies
        job.wrows = self.wrows[rows]
        job.A, job.Bm = self.A[rows], self.Bm[rows]
        job.C, job.row_sums = self.C[rows], self.row_sums[rows]
        return job


def _maf_mac_summary(maf, mac):
    def _mean_sd(x):
        x = x[np.isfinite(x)]
        if len(x) == 0:
            return np.nan, np.nan
        return float(np.mean(x)), float(np.std(x, ddof=1)) if len(x) > 1 else np.nan
    maf_avg, maf_sd = _mean_sd(maf)
    mac_avg, mac_sd = _mean_sd(mac)
    f = lambda x, fn: float(fn(x[np.isfinite(x)])) if np.isfinite(x).any() else np.nan
    return dict(
        maf_avg=maf_avg, maf_sd=maf_sd,
        maf_min=f(maf, np.min), maf_max=f(maf, np.max),
        mac_avg=mac_avg, mac_sd=mac_sd,
        mac_min=f(mac, np.min), mac_max=f(mac, np.max))


class _UnitSource:
    """Bounded-memory rows for units.  Hard calls of a genotype node come
    as int8 codes (:meth:`codes`): small files use the whole-matrix cache,
    big ones random-access the GDS frames (``SeqData.code_rows``).
    Dosages (a DS node, or ``dsnode``) come as f64 rows (:meth:`rows`).
    ``cols`` (GDS columns of the model's samples, or None) gathers the
    rows to the model's samples."""

    CACHE_LIMIT = 4 << 30

    def __init__(self, seq: SeqData, inst: dict, cols=None,
                 dsnode: str = ""):
        self.seq, self.inst, self.cols = seq, inst, cols
        self.dsnode = dsnode
        self.geno = seq.has_genotype() and not dsnode
        self.small = seq.n_variants * seq.n_samples <= self.CACHE_LIMIT

    @property
    def n_cols(self) -> int:
        return self.seq.n_samples if self.cols is None else len(self.cols)

    def rows(self, idx) -> np.ndarray:
        """f64 dosages [len(idx), N] (NaN = missing), N the model's
        samples, read in contiguous spans of at most MAX_SPAN variants (one
        min..max span of a scattered gene set could be chromosome-sized)."""
        t0 = time.perf_counter()
        idx = np.asarray(idx)
        r = np.empty((len(idx), self.seq.n_samples))
        idx_s = np.sort(idx)
        pos_of = {v: i for i, v in enumerate(idx)}
        c0 = 0
        for k in range(1, len(idx_s) + 1):
            if k == len(idx_s) or idx_s[k] - idx_s[c0] >= MAX_SPAN:
                lo, hi = int(idx_s[c0]), int(idx_s[k - 1]) + 1
                blk = self.seq.dosage_block(lo, hi, self.dsnode)
                for v in idx_s[c0:k]:
                    r[pos_of[v]] = blk[v - lo]
                c0 = k
        if self.cols is not None:
            r = np.take(r, self.cols, axis=1)
        _tick(self.inst, "fetch_s", t0)
        return r

    def codes(self, idx) -> np.ndarray:
        """int8 codes [len(idx), N] (3 = missing), N the model's samples."""
        t0 = time.perf_counter()
        idx = np.asarray(idx)
        if len(idx) == 0:
            r = np.empty((0, self.n_cols), np.int8)
        else:
            r = self.seq.code_matrix()[idx] if self.small \
                else self.seq.code_rows(idx)
            if self.cols is not None:
                r = np.take(r, self.cols, axis=1)
            r = np.ascontiguousarray(r, dtype=np.int8)
        _tick(self.inst, "fetch_s", t0)
        return r


class _SpaAccum:
    """Bounded-memory phase-2 accumulator: flagged rows refine
    incrementally once their host bytes pass the budget (the scan
    driver's SPA_FLUSH_BYTES)."""

    def __init__(self, kernel: "_Kernel"):
        self.k = kernel
        self.rows, self.G, self.bytes = [], [], 0
        self.results = []        # (rows, pval, converged, beta, se)

    def add(self, rows: np.ndarray, G: np.ndarray):
        self.rows.append(rows)
        self.G.append(G)
        self.bytes += G.nbytes
        if self.bytes >= SPA_FLUSH_BYTES:
            self.flush()

    def flush(self):
        if not self.rows:
            return
        t0 = time.perf_counter()
        rows = np.concatenate(self.rows)
        Gs = np.concatenate(self.G, axis=0)
        self.rows, self.G, self.bytes = [], [], 0
        if len(rows) > 1:
            # nnz-bucketed compaction (exact; see the scan's phase 2)
            order = np.argsort(_spa_nnz(Gs), kind="stable")
            Gs, rows = Gs[order], rows[order]
        B = self.k.batch
        pending = deque()

        def drain():
            r, stacked = pending.popleft()
            a = stacked.cpu().numpy()     # one stacked [4, B] readback
            self.results.append((r, a[0], a[1] != 0, a[2], a[3]))

        caps = _spa_caps(Gs)
        for s, e in _spa_batches(caps, B):
            res = spa_refine_binary(self.k.scan_model,
                                    _to_device(_shrink_f32(Gs[s:e]),
                                               self.k.device),
                                    cap=int(caps[s]))
            pending.append((rows[s:e],
                            torch.stack([res[0], res[1].to(torch.float64),
                                         res[2], res[3]])))
            if len(pending) >= DEPTH:
                drain()
        while pending:
            drain()
        _tick(self.k.inst, "spa_s", t0)
        self.k.inst["spa_n"] = self.k.inst.get("spa_n", 0) + len(rows)


@dataclass
class _Kernel:
    """Streaming batched score+SPA runner over test-vector rows, with the
    binary or (``binary=False``) the quantitative score test; a
    quantitative trait sends no row to SPA.

    ``inst`` collects host seconds by stage (``fetch_s``, ``tally_s``,
    ``encode_s``, ``upload_s``, ``wait_s`` blocked on device results,
    ``spa_s``), ``device_s`` (CUDA-event time of each phase-1 call, on a
    card), ``spa_n`` (rows refined by SPA) and ``payloads``, a count of
    shipped payloads by route (``burden_sparse``, ``burden_2bit``,
    ``single_sparse``, ``single_2bit``, ``dense``), and the rows that
    `run_stream` sent the packed way (``rows_packed``) and the dense way
    (``rows_dense``)."""

    scan_model: ScanModel
    params: ScanParams
    device: torch.device
    binary: bool
    batch: int = 256
    inst: dict = field(default_factory=dict)
    _pm: object = None

    def _packed(self):
        """Lazy packed-model build (one per run)."""
        if self._pm is None:
            self._pm = pack_scan_model(self.scan_model)
        return self._pm

    def _count(self, route: str):
        p = self.inst.setdefault("payloads", {})
        p[route] = p.get(route, 0) + 1

    def _upload(self, payload):
        t0 = time.perf_counter()
        out = _to_device(payload, self.device)
        _tick(self.inst, "upload_s", t0)
        return out

    def _timed(self, fn):
        """Run ``fn`` -> (result, CUDA event pair or None)."""
        if self.device.type != "cuda":
            return fn(), None
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = fn()
        ev[1].record()
        return out, ev

    def _readback(self, stacked, ev) -> np.ndarray:
        t0 = time.perf_counter()
        a = stacked.cpu().numpy()
        _tick(self.inst, "wait_s", t0)
        if ev is not None:
            ev[1].synchronize()
            self.inst["device_s"] = self.inst.get("device_s", 0.0) + \
                ev[0].elapsed_time(ev[1]) / 1e3
        return a

    def run_stream(self, blocks_iter):
        """Consume an iterator of int8 code blocks [k, N] (3 = missing) or
        f64 row blocks [k, N] (NaN = missing) -> dict of per-row stat
        arrays (af, mac, num, beta, se, pval, p.norm, converged, valid);
        rows failing the filters are NaN.

        Rows dispatch in ``batch``-row blocks.  A block of codes, or of
        f64 rows that are all 0/1/2/NaN, is split into sparse and 2-bit
        payloads by ``_packed_parts`` (the kernels); any other f64 block
        ships as it is (f32 where lossless) to the dense f64 score test.
        Per-row results are independent either way.  Host memory holds the
        window of blocks in flight plus the SPA-flagged rows."""
        B = self.batch
        parts = {k: [] for k in _STATS}
        acc = _SpaAccum(self)
        window = deque()
        buf, buf_n, row0 = [], 0, 0
        phase1 = score_stats_binary_packed if self.binary \
            else score_stats_quant_packed
        dense1 = score_stats_binary if self.binary else score_stats_quant

        def _drain():
            start, G, res_parts = window.popleft()
            m = len(G)
            f = {k: np.empty(m) for k in parts}
            need = np.empty(m, bool)
            for rows, stacked, ev in res_parts:
                res = unstack_stats(self._readback(stacked, ev))
                need[rows] = res.need_spa
                for k in f:
                    f[k][rows] = getattr(res, k)
            for k in parts:
                parts[k].append(f[k])
            if self.binary and need.any():   # phase 2 runs on f64 dosages
                Gf = G[need]
                if Gf.dtype == np.int8:
                    Gf = np.where(Gf == 3, np.nan, Gf).astype(np.float64)
                acc.add(start + np.flatnonzero(need), Gf)

        def _dispatch(G, start):
            t0 = time.perf_counter()
            codes = G if G.dtype == np.int8 else _as_codes(G)
            key = "rows_packed" if codes is not None else "rows_dense"
            self.inst[key] = self.inst.get(key, 0) + len(G)
            if codes is None:
                host = [(np.arange(len(G)), _shrink_f32(G))]
            else:
                host = _packed_parts(codes)
            _tick(self.inst, "encode_s", t0)
            res_parts = []
            for rows, payload in host:
                self._count("dense" if codes is None else "single_sparse"
                            if isinstance(payload, tuple) else "single_2bit")
                dev = self._upload(payload)
                res, ev = self._timed(lambda: stack_stats(
                    dense1(self.scan_model, self.params, dev)
                    if codes is None
                    else phase1(self._packed(), self.params, dev)))
                res_parts.append((rows, res, ev))
            window.append((start, G, res_parts))
            if len(window) >= DEPTH:
                _drain()

        for rows in blocks_iter:
            rows = np.asarray(rows)
            if rows.dtype != np.int8:        # int8 streams skip the f64 hop
                rows = np.asarray(rows, np.float64)
            if rows.ndim == 1:
                rows = rows[None, :]
            pos = 0
            while pos < len(rows):
                take = min(B - buf_n, len(rows) - pos)
                buf.append(rows[pos:pos + take])
                buf_n += take
                pos += take
                if buf_n == B:
                    _dispatch(np.vstack(buf), row0)
                    row0 += B
                    buf, buf_n = [], 0
        if buf_n:
            _dispatch(np.vstack(buf), row0)
        while window:
            _drain()
        return self._finalize(parts, acc)

    def run_jobs(self, jobs_iter):
        """Consume an iterator of `_BurdenJob`s -> the same per-row stat
        dict as ``run_stream`` (rows in job order).

        Unit codes batch into [S, N] blocks (at most BURDEN_S_CAP source
        rows and R_CAP burden rows) with block-diagonal coefficient
        matrices; each batch ships as one payload, gap-coded when that at
        least halves its 2-bit bytes, and `burden_score_packed` builds and
        scores its rows on the device.  SPA-flagged rows are rebuilt
        host-side for phase 2."""
        parts = {k: [] for k in _STATS}
        acc = _SpaAccum(self)
        window = deque()

        def _flush(batch, R_tot, S_tot, start):
            t0 = time.perf_counter()
            codes = batch[0].codes if len(batch) == 1 else \
                np.concatenate([job.codes for job in batch])
            N = codes.shape[1]
            A = np.zeros((R_tot, S_tot))
            Bm = np.zeros((R_tot, S_tot))
            C = np.zeros(R_tot)
            r0 = s0 = 0
            for job in batch:
                r1, s1 = r0 + len(job.A), s0 + job.codes.shape[0]
                A[r0:r1, s0:s1] = job.A
                Bm[r0:r1, s0:s1] = job.Bm
                C[r0:r1] = job.C
                r0, s0 = r1, s1
            # whole-batch transport decision (one payload by design)
            nnz = int(np.count_nonzero(codes))
            sparse = S_tot * N < (1 << 31) and \
                2 * nnz < (S_tot * (N // 4)) // 2
            payload = encode_sparse_rows(codes) if sparse \
                else _pack2_block(codes)
            _tick(self.inst, "encode_s", t0)
            self._count("burden_sparse" if sparse else "burden_2bit")
            dev = self._upload((payload, A, Bm, C))
            res, ev = self._timed(lambda: stack_stats(burden_score_packed(
                self.scan_model, self.params, *dev, binary=self.binary)))
            window.append((start, batch, res, ev))
            if len(window) >= DEPTH:
                _drain()

        def _drain():
            start, batch, stacked, ev = window.popleft()
            res = unstack_stats(self._readback(stacked, ev))
            for k in parts:
                parts[k].append(getattr(res, k))
            if self.binary and res.need_spa.any():
                # rebuild flagged rows host-side (few: ~spa_pval fraction)
                offs = np.cumsum([0] + [len(j.A) for j in batch])
                need = np.flatnonzero(res.need_spa)
                rows = []
                for r in need:
                    j = np.searchsorted(offs, r, side="right") - 1
                    rows.append(batch[j].host_row(r - offs[j]))
                acc.add(start + need, np.asarray(rows))

        batch, R_tot, S_tot, row0 = [], 0, 0, 0
        for job in jobs_iter:
            S_u = job.codes.shape[0]
            if batch and (S_tot + S_u > BURDEN_S_CAP or
                          R_tot + len(job.A) > R_CAP):
                _flush(batch, R_tot, S_tot, row0)
                row0 += R_tot
                batch, R_tot, S_tot = [], 0, 0
            batch.append(job)
            R_tot += len(job.A)
            S_tot += S_u
        if batch:
            _flush(batch, R_tot, S_tot, row0)
        while window:
            _drain()
        return self._finalize(parts, acc)

    def _finalize(self, parts, acc: _SpaAccum):
        """Shared tail: assemble per-row arrays + apply phase-2 results."""
        out = {k: (np.concatenate(v) if v else np.empty(0))
               for k, v in parts.items()}
        out["valid"] = out["valid"].astype(bool)
        out["p.norm"] = out["pval"].copy()
        out["converged"] = np.isfinite(out["pval"])
        acc.flush()
        for r, p, conv, b, e in acc.results:
            out["pval"][r] = p
            out["converged"][r] = conv
            out["beta"][r] = b
            out["se"][r] = e
        # rows failing the filters -> NaN like the reference
        bad = ~out["valid"]
        for k in ("af", "mac", "beta", "se", "pval", "p.norm"):
            out[k][bad] = np.nan
        out["converged"][bad] = False
        return out


def _prepare(gdsfile, modobj, config: AggregateConfig, device):
    dev = check_device(device)
    model = NullModel.load(modobj)
    seq = gdsfile if isinstance(gdsfile, SeqData) else SeqData(gdsfile)
    # sample alignment like the scan (R/assoc_single.r:136-142)
    cols, ii = _match_samples(seq.sample_id, model.sample_id)
    scan_model = model.scan_model(sample_index=ii, var_ratio=config.var_ratio,
                                  device=dev)
    params = ScanParams(maf=0.0, mac=0.0, missing=1.0,
                        spa_pval=config.spa_pval)
    inst = {}
    kernel = _Kernel(scan_model=scan_model, params=params, device=dev,
                     binary=model.trait_type == "binary",
                     batch=config.block_size, inst=inst)
    wbeta = np.asarray(config.wbeta, dtype=np.float64)  # [W, 2]
    wnames = [f"{b1:g}_{b2:g}" for b1, b2 in wbeta]
    return kernel, wbeta, wnames, _UnitSource(seq, inst, cols,
                                              config.dsnode)


def _table(units: VariantUnits, summaries: List[dict]) -> dict:
    """The descriptor, ``numvar`` and MAF/MAC summary columns."""
    tab = dict(units.desp)
    tab["numvar"] = np.asarray([len(i) for i in units.index], np.int64)
    for key in _SUMMARY:
        tab[key.replace("_", ".")] = np.asarray([s[key] for s in summaries],
                                                np.float64)
    return tab


def _finish(tab: dict, kernel: _Kernel, instrument, res_savefn: str,
            res_compress: str) -> dict:
    if instrument is not None:
        instrument.update(kernel.inst)
    if res_savefn:
        from .single import save_assoc
        save_assoc(tab, res_savefn, file_format="SAIGE_OUTPUT_SET",
                   res_compress=res_compress)
    return tab


def assoc_burden(gdsfile, modobj, units: VariantUnits,
                 config: AggregateConfig = AggregateConfig(),
                 res_savefn: str = "", verbose: bool = False,
                 res_compress: str = "LZMA", instrument=None, *,
                 device) -> dict:
    """Burden tests over variant units (seqAssocGLMM_spaBurden), binary or
    quantitative trait, on ``device``; a quantitative trait's table has no
    ``p.norm`` or ``cvg`` columns.

    Streams one unit at a time — host memory is bounded by the device
    batch, not by [units x samples].  ``instrument``: optional dict that
    receives the stage seconds and payload counts of `_Kernel`."""
    kernel, wbeta, wnames, src = _prepare(gdsfile, modobj, config, device)
    U = len(units)
    W = len(wbeta)
    summaries = []
    summac = np.zeros(U * W)

    def burden_stream():
        # dosages: collapse on the host, score the f64 rows
        for u, idx in enumerate(units.index):
            ds = src.rows(idx)
            t0 = time.perf_counter()
            maf, mac = _maf_mac(ds)
            summaries.append(_maf_mac_summary(maf, mac))
            rows = np.empty((W, src.n_cols))
            for w in range(W):
                ws = _normalize(beta_weights(maf, wbeta[w, 0], wbeta[w, 1]))
                rows[w] = _burden_collapse(ds, ws)
                summac[u * W + w] = rows[w].sum() * len(idx)
            _tick(kernel.inst, "tally_s", t0)
            yield rows

    def job_stream():
        # hard calls: ship codes once, collapse on the device
        for u, idx in enumerate(units.index):
            codes = src.codes(idx)
            t0 = time.perf_counter()
            t = _CodeTallies(codes)
            summaries.append(_maf_mac_summary(t.maf, t.mac))
            wrows = np.stack([
                _normalize(beta_weights(t.maf, b1, b2))
                for b1, b2 in wbeta])
            job = _BurdenJob(codes, wrows, t)
            summac[u * W : (u + 1) * W] = job.row_sums * len(idx)
            _tick(kernel.inst, "tally_s", t0)
            yield job

    out = kernel.run_jobs(job_stream()) if src.geno \
        else kernel.run_stream(burden_stream())
    ok = (summac >= config.summac) & (summac > 0)
    for k in ("beta", "se", "pval", "p.norm"):
        out[k][~ok] = np.nan
    out["converged"][~ok] = False

    tab = _table(units, summaries)
    for w, nm in enumerate(wnames):
        s = f".b{nm}" if W > 1 else ""
        sel = np.arange(U) * W + w
        tab[f"summac{s}"] = summac[sel]
        tab[f"beta{s}"] = out["beta"][sel]
        tab[f"SE{s}"] = out["se"][sel]
        tab[f"pval{s}"] = out["pval"][sel]
        if kernel.binary:
            tab[f"p.norm{s}"] = out["p.norm"][sel]
            tab[f"cvg{s}"] = out["converged"][sel]
    return _finish(tab, kernel, instrument, res_savefn, res_compress)


@dataclass
class _AcatVPlan:
    """Per-unit ACAT-V bookkeeping collected during the burden stream."""

    idx: np.ndarray
    maf: np.ndarray
    mac: np.ndarray
    single_mask: np.ndarray
    n_burden: int
    burden_keys: dict = field(default_factory=dict)   # w -> burden row
    full_keys: dict = field(default_factory=dict)     # w -> full-burden row


class _AcatVRunner:
    """Streaming cross-unit ACAT-V (+ optional ACAT-O full burdens).

    One pass over the units streams every qualifying burden job to the
    device; single-variant rows are deduplicated globally by variant index
    (overlapping sliding windows share SNPs — the reference's per-unit
    loop recomputes them, src/saige_main.cpp:900-963, values identical)
    and fetched in a second bounded stream."""

    def __init__(self, kernel: _Kernel, wbeta, config, src: _UnitSource,
                 with_full_burden: bool = False):
        self.kernel = kernel
        self.wbeta = wbeta
        self.config = config
        self.src = src
        self.with_full = with_full_burden
        self.plans: List[_AcatVPlan] = []
        self.summaries: List[dict] = []
        self.n_rows = 0

    def _plan(self, idx, maf, mac) -> _AcatVPlan:
        single_mask = mac >= self.config.acatv_mac
        plan = _AcatVPlan(idx=np.asarray(idx), maf=maf, mac=mac,
                          single_mask=single_mask,
                          n_burden=int((~single_mask).sum()))
        self.plans.append(plan)
        return plan

    def _weights(self, plan: _AcatVPlan):
        """The unit's weight rows -> [(weights [S], key dict, w)]: one per
        scheme over the rare SNPs when it has any (ACAT-V's burden), and,
        for ACAT-O, one per scheme over all SNPs (the full burden)."""
        out = []
        if plan.n_burden > 0:
            for w, (b1, b2) in enumerate(self.wbeta):
                with np.errstate(invalid="ignore", divide="ignore"):
                    wb = np.where(plan.single_mask, np.nan,
                                  beta_weights(plan.maf, b1, b2))
                out.append((_normalize(wb), plan.burden_keys, w))
        if self.with_full:
            for w, (b1, b2) in enumerate(self.wbeta):
                out.append((_normalize(beta_weights(plan.maf, b1, b2)),
                            plan.full_keys, w))
        return out

    def _keep(self, summac: float, keys: dict, w: int) -> bool:
        """The summac pre-filter; a kept row takes the next row number."""
        if summac >= self.config.summac and summac > 0:
            keys[w] = self.n_rows
            self.n_rows += 1
            return True
        return False

    def _unit_rows(self, idx) -> list:
        """Plan one unit of dosages; its qualifying burden rows, collapsed
        on the host."""
        ds = self.src.rows(idx)
        t0 = time.perf_counter()
        maf, mac = _maf_mac(ds)
        self.summaries.append(_maf_mac_summary(maf, mac))
        plan = self._plan(idx, maf, mac)
        rows = []
        for wts, keys, w in self._weights(plan):
            g = _burden_collapse(ds, wts)
            if self._keep(g.sum() * ds.shape[0], keys, w):
                rows.append(g)
        _tick(self.kernel.inst, "tally_s", t0)
        return rows

    def _unit_job(self, idx) -> Optional[_BurdenJob]:
        """Plan one unit; its burden job of the qualifying rows (summac
        pre-filtering), or None."""
        codes = self.src.codes(idx)
        t0 = time.perf_counter()
        t = _CodeTallies(codes)
        self.summaries.append(_maf_mac_summary(t.maf, t.mac))
        wlist = self._weights(self._plan(idx, t.maf, t.mac))
        job = None
        if wlist:
            job = _BurdenJob(codes, np.stack([wts for wts, _, _ in wlist]),
                             t)
            keep = [i for i, (_, keys, w) in enumerate(wlist)
                    if self._keep(job.row_sums[i] * codes.shape[0], keys, w)]
            job = None if not keep else \
                job if len(keep) == len(wlist) else job.subset(keep)
        _tick(self.kernel.inst, "tally_s", t0)
        return job

    def run(self, units: VariantUnits):
        """-> (results {uid: (pvals [W], p_med, p_min, p_max, n_single,
        n_burden)}, full_pvals {uid: {w: pval}})"""
        if self.src.geno:
            jobs = (job for job in map(self._unit_job, units.index)
                    if job is not None)
            pburden = self.kernel.run_jobs(jobs)["pval"]
        else:
            rows = (g for idx in units.index for g in self._unit_rows(idx))
            pburden = self.kernel.run_stream(rows)["pval"]

        # dedup'd single-variant tests, fetched in bounded batches
        sv_idx = sorted({int(i) for plan in self.plans
                         for i in plan.idx[plan.single_mask]})
        psingle = {}
        if sv_idx:
            sv = np.asarray(sv_idx)
            # hard calls come as int8 codes (no f64 hop on the host)
            fetch = self.src.codes if self.src.geno else self.src.rows
            sres = self.kernel.run_stream(
                fetch(sv[s : s + SINGLE_FETCH])
                for s in range(0, len(sv), SINGLE_FETCH))
            psingle = dict(zip(sv_idx, sres["pval"]))

        out = {}
        full = {}
        for uid, plan in enumerate(self.plans):
            maf, single_mask = plan.maf, plan.single_mask
            n_burden = plan.n_burden
            out_p, out_med, out_min, out_max = [], [], [], []
            burden_added_w0 = False
            for w, (b1, b2) in enumerate(self.wbeta):
                pvals, wp = [], []
                for j in np.flatnonzero(single_mask):
                    p = maf[j]
                    wp.append(float(beta_weights(p, b1, b2)) ** 2
                              * p * (1 - p))
                    pvals.append(float(psingle[int(plan.idx[j])]))
                if w in plan.burden_keys:
                    pv = float(pburden[plan.burden_keys[w]])
                    if np.isfinite(pv):
                        p = float(maf[~single_mask].sum() / n_burden)
                        wp.append(float(beta_weights(p, b1, b2)) ** 2
                                  * p * (1 - p))
                        pvals.append(pv)
                        if w == 0:
                            burden_added_w0 = True
                pvals = np.asarray(pvals, float)
                wp = np.asarray(wp, float)
                if len(pvals) > 0:
                    out_p.append(acat_p(pvals, wp) if len(pvals) > 1
                                 else float(pvals[0]))
                    fin = pvals[np.isfinite(pvals)]
                    out_med.append(float(np.median(fin)) if len(fin) else np.nan)
                    out_min.append(float(np.min(fin)) if len(fin) else np.nan)
                    out_max.append(float(np.max(fin)) if len(fin) else np.nan)
                else:
                    out_p.append(np.nan)
                    out_med.append(np.nan)
                    out_min.append(np.nan)
                    out_max.append(np.nan)
            # counts refer to the first weight scheme only
            # (src/saige_main.cpp:815-819)
            n_single = int(single_mask.sum()) + (1 if burden_added_w0 else 0)
            out[uid] = (out_p, out_med, out_min, out_max,
                        n_single - n_burden, n_burden)
            full[uid] = {w: float(pburden[r])
                         for w, r in plan.full_keys.items()}
        return out, full


def assoc_acat_v(gdsfile, modobj, units: VariantUnits,
                 config: AggregateConfig = AggregateConfig(),
                 res_savefn: str = "", verbose: bool = False,
                 res_compress: str = "LZMA", instrument=None, *,
                 device) -> dict:
    """ACAT-V tests over variant units (seqAssocGLMM_spaACAT_V, binary
    only), on ``device``."""
    kernel, wbeta, wnames, src = _prepare(gdsfile, modobj, config, device)
    if not kernel.binary:
        raise NotImplementedError(
            "ACAT-V is binary-only, like the reference "
            "(src/saige_main.cpp:836-842)")
    runner = _AcatVRunner(kernel, wbeta, config, src)
    results, _full = runner.run(units)
    rows = [results[uid] for uid in range(len(units))]

    W = len(wbeta)
    tab = _table(units, runner.summaries)
    tab["n.single"] = np.asarray([r[4] for r in rows], np.int64)
    tab["n.burden"] = np.asarray([r[5] for r in rows], np.int64)
    for w, nm in enumerate(wnames):
        s = f".v{nm}" if W > 1 else ""
        tab[f"pval{s}"] = np.asarray([r[0][w] for r in rows])
        tab[f"p.med{s}"] = np.asarray([r[1][w] for r in rows])
        tab[f"p.min{s}"] = np.asarray([r[2][w] for r in rows])
        tab[f"p.max{s}"] = np.asarray([r[3][w] for r in rows])
    return _finish(tab, kernel, instrument, res_savefn, res_compress)


def assoc_acat_o(gdsfile, modobj, units: VariantUnits,
                 config: AggregateConfig = AggregateConfig(),
                 res_savefn: str = "", verbose: bool = False,
                 res_compress: str = "LZMA", instrument=None, *,
                 device) -> dict:
    """ACAT-O tests (seqAssocGLMM_spaACAT_O, binary only), on ``device``:
    Cauchy combination of the burden and ACAT-V p-values across weight
    schemes."""
    kernel, wbeta, wnames, src = _prepare(gdsfile, modobj, config, device)
    if not kernel.binary:
        raise NotImplementedError("ACAT-O is binary-only, like the reference")
    W = len(wbeta)
    runner = _AcatVRunner(kernel, wbeta, config, src, with_full_burden=True)
    results, full = runner.run(units)

    combined, pbs, pvs = [], [], []
    for uid in range(len(units)):
        pb = [full[uid].get(w, np.nan) for w in range(W)]
        pv = results[uid][0]
        allp = np.asarray(pb + list(pv), float)
        combined.append(acat_p(allp[np.isfinite(allp)])
                        if np.isfinite(allp).any() else np.nan)
        pbs.append(pb)
        pvs.append(pv)

    tab = _table(units, runner.summaries)
    tab["pval"] = np.asarray(combined, np.float64)
    for w, nm in enumerate(wnames):
        tab[f"pval.b{nm}"] = np.asarray([p[w] for p in pbs], np.float64)
        tab[f"pval.v{nm}"] = np.asarray([p[w] for p in pvs], np.float64)
    return _finish(tab, kernel, instrument, res_savefn, res_compress)
