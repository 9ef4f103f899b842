"""Single-variant association scan (the ``seqAssocGLMM_SPA`` equivalent).

The counterpart of ``saigegds_tpu/assoc/single.py`` for a binary or a
quantitative trait.  Variant blocks stream through three threads — GDS
decode, pack, upload to the device — into the phase-1 score test.  Hard
calls of a genotype node ship planar 2-bit (``ops/score_packed.py``,
kernel B3; with ``packed_2bit=False`` the int8 block ships as it is,
through kernel B4).  Dosages — an imputed ``annotation/format/DS`` node,
``dsnode="$dosage_alt"``, ``use_packed=False`` or the user's callback of
:func:`assoc_spa_user` — ship as f64 rows (f32 where that is lossless)
into the dense f64 score test (``ops/score.py``).  For a binary trait,
variants with ``p_noadj <= spa.pval`` are refined in phase 2 by the
saddlepoint approximation (``ops/score.spa_refine_binary``), and a
quantitative trait's phase 1 is final.  Output columns and semantics match
the reference (``R/assoc_single.r:92-334``): id, chr, pos, rs.id, ref, alt,
AF.alt, mac, num, beta, SE, pval, and for a binary trait p.norm and
converged.
Variants failing the MAF/MAC/missing filters are dropped from the table,
as in the reference's NULL results (R/assoc_single.r:228-234).

The table is an ordered ``dict`` of numpy columns (no pandas dependency).
"""

from __future__ import annotations

import math
from collections import deque
from typing import Optional, Union

import numpy as np
import torch

from ..config import ScanConfig
from ..io.seqarray import SeqData
from ..models.nullmodel import NullModel
from ..ops._cuda import check_device
from ..ops.score import ScanParams, score_stats_binary, score_stats_quant, \
    spa_refine_binary, stack_stats, unstack_stats
from ..ops.score_packed import pack_scan_model, score_stats_binary_packed, \
    score_stats_quant_packed
from ..ops.sparse_codes import SPARSE_NNZ_FRAC, encode_sparse_rows

SPA_BATCH = 256  # compact SPA refinement batch size
SPA_FLUSH_BYTES = 1 << 30  # flagged-set host budget before an incremental
#                            phase-2 flush (bounds scan memory at scale)
DEPTH = 3        # blocks in flight between dispatch and readback
CHECK_ELEMS = 1 << 20   # elements per chunk of the host's dosage checks


def _prefetch_blocks(block_iter, depth: int = 2, name: str = "",
                     instrument=None):
    """Run the block iterator in a background thread with a bounded queue,
    so the stage producing block k+1 overlaps the consumer of block k
    (decode is zlib/lzma + native kernels — all release the GIL).

    With ``instrument`` and ``name``, three per-item wait timers land in
    lists: ``stall_{name}_s`` — the producer blocked on a full queue (the
    stage DOWNSTREAM of ``name`` is the laggard); ``idle_{name}_s`` — the
    consumer blocked on an empty queue (``name`` itself is the laggard);
    ``queued_{name}_s`` — how long a finished item sat ready-but-unconsumed.
    """
    import time as _time
    import queue
    import threading

    q = queue.Queue(maxsize=depth)
    _END = object()
    rec = (lambda k, v: instrument.setdefault(k, []).append(v)) \
        if instrument is not None and name else (lambda k, v: None)

    def worker():
        try:
            for item in block_iter:
                t0 = _time.perf_counter()
                q.put((t0, item))
                rec(f"stall_{name}_s", _time.perf_counter() - t0)
            q.put(_END)
        except BaseException as e:               # surface in the consumer
            q.put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        t0 = _time.perf_counter()
        item = q.get()
        t1 = _time.perf_counter()
        if item is _END:
            break
        if isinstance(item, BaseException):
            raise item
        t_ready, item = item
        rec(f"idle_{name}_s", t1 - t0)
        rec(f"queued_{name}_s", max(t1 - t_ready, 0.0))
        yield item


def _scan_params(config: ScanConfig) -> ScanParams:
    """The filters and the SPA cut of a ScanConfig (NaN: no filter)."""
    return ScanParams(
        maf=-1.0 if math.isnan(config.maf) else config.maf,
        mac=-1.0 if math.isnan(config.mac) else config.mac,
        missing=1.0 if math.isnan(config.missing) else config.missing,
        spa_pval=config.spa_pval,
    )


def _shrink_f32(G: np.ndarray) -> np.ndarray:
    """Ship a dosage block f32 when that is lossless (always for dFloat32
    sources and integer-valued dosages): half the host-to-device bytes;
    ``ops/score.prep_dosage`` widens it back to f64 on the device.  The
    block is cast and checked in chunks of rows, so a block that is not
    f32-exact stops at its first such chunk."""
    G32 = np.empty(G.shape, np.float32)
    step = max(1, CHECK_ELEMS // max(G.shape[-1], 1))
    for s in range(0, len(G), step):
        g, g32 = G[s : s + step], G32[s : s + step]
        with np.errstate(over="ignore"):      # an overflow is a miss
            g32[...] = g
        if not np.all((g32 == g) | np.isnan(g)):
            return G
    return G32


def _pack2_block(G: np.ndarray) -> np.ndarray:
    """2-bit planar pack of an int8 code block — the scan transport's pack
    stage (the native threaded kernel when the host library builds, numpy
    otherwise).  Blocks are not padded to a fixed row count: nothing here
    compiles per shape."""
    from ..io import native
    out = native.pack2_raw(G)
    if out is not None:
        return out
    from ..ops.packed_grm import pack_codes_2bit
    return pack_codes_2bit(G)


def assoc_spa(gdsfile, modobj: Union[NullModel, str],
              config: ScanConfig = ScanConfig(),
              res_savefn: str = "", verbose: bool = False,
              variant_mask: Optional[np.ndarray] = None,
              res_compress: str = "LZMA", instrument=None, *,
              device, mesh=None) -> dict:
    """Score-test + SPA scan over all variants of a SeqArray GDS file, on
    ``device`` ("cuda" runs phase 1 of hard calls through the hand-written
    kernels, and of dosages through f64 tensor code on the card).

    Hard calls of a genotype node take the packed route; an
    ``annotation/format/DS`` node (found by itself when the file has no
    genotype node), ``config.dsnode`` and ``config.use_packed=False`` take
    the dense dosage route.  ``variant_mask`` restricts the scan;
    ``res_compress`` is the output compression of :func:`save_assoc`.
    ``instrument``: optional dict that collects per-stage wall-times (see
    :func:`_scan_blocks`).  ``mesh`` (``parallel/mesh.make_mesh``, its
    lead device ``device``) splits each block's variants over the mesh's
    devices, phase 1 of each part on its device against a copy of the
    model; SPA runs on the lead, and the table equals the one-device
    table.  A mesh that spans processes raises ValueError: across
    processes the scan runs on variant ranges
    (``parallel/distributed.assoc_spa_sharded``), as the JAX package's
    does.  Returns the result table as an ordered dict of numpy columns.
    """
    dev = _scan_device(device, mesh)
    model = NullModel.load(modobj)
    seq = gdsfile if isinstance(gdsfile, SeqData) else SeqData(gdsfile)
    if verbose:
        print(f"SPA association scan ({model.trait_type} trait) on {dev}: "
              f"{seq.n_variants} variants x {model.n_samples} samples")
    tab = _scan_models(seq, [model], config, variant_mask, instrument,
                       dev, mesh)[0]
    if verbose:
        n = len(tab["id"])
        print(f"    tested {n} variants (filters dropped "
              f"{seq.n_variants - n})")
    if res_savefn:
        save_assoc(tab, res_savefn, res_compress=res_compress)
        if verbose:
            print(f"    saved to {res_savefn}")
    return tab


def _scan_device(device, mesh) -> torch.device:
    """The scan's device: ``device``, which must be the lead of
    ``mesh``, a mesh of one process."""
    if mesh is None:
        return check_device(device)
    if mesh.spans:
        raise ValueError("a scan does not take a mesh that spans processes: "
                         "scan variant ranges with assoc_spa_sharded, one "
                         "range per process, and merge_shards")
    from ..parallel.mesh import check_lead
    return check_lead(mesh, device)


def _scan_models(seq: SeqData, models: list, config: ScanConfig,
                 variant_mask, instrument, dev, mesh=None) -> list:
    """One pass of the genotypes of ``seq`` for the NullModels ``models``
    (over the same GDS samples): the route, the blocks and the scan core;
    one table per model."""
    if config.spa_mixed:
        raise NotImplementedError("spa_mixed is deprecated and not ported")
    # sample alignment (R/assoc_single.r:136-142): cols restricts the
    # genotype columns to the models' samples (GDS order), ii gathers each
    # model's per-sample arrays to those columns
    cols0 = None
    scan_models = []
    for i, model in enumerate(models):
        cols, ii = _match_samples(seq.sample_id, model.sample_id)
        if i == 0:
            cols0 = cols
        elif not ((cols is None and cols0 is None) or
                  (cols is not None and cols0 is not None and
                   np.array_equal(cols, cols0))):
            raise ValueError(
                "assoc_spa_multi: all models must select the same GDS "
                "sample columns (fit them on one sample universe, or scan "
                "separately with assoc_spa)")
        scan_models.append((model.scan_model(
            sample_index=ii, var_ratio=config.var_ratio, device=dev),
            model.trait_type == "binary"))
    # the packed route needs hard calls; a model over a subset of the GDS
    # samples keeps it (the blocks are gathered before the pack)
    dense = not (config.use_packed and seq.has_genotype()
                 and not config.dsnode)
    if dense:
        blocks = seq.iter_dosage_blocks(config.block_size,
                                        dsnode=config.dsnode,
                                        variant_mask=variant_mask)
    else:
        blocks = seq.iter_code_blocks(config.block_size,
                                      variant_mask=variant_mask)
    res = _scan_blocks_multi(
        scan_models, _scan_params(config), blocks, dev,
        packed_2bit=config.packed_2bit, sparse=_static_sparse(config),
        spa_compact=config.spa_compact, cols=cols0, instrument=instrument,
        dense=dense, mesh=mesh)
    return [_with_meta(seq, r) for r in res]


def _static_sparse(config: ScanConfig) -> bool:
    """Whether code blocks take the sparse route: ``packed_sparse`` with
    ``transport_policy="static"`` (the nnz-only rule of
    :func:`_packed_parts`).  The JAX package's default, link-aware policy
    engages the sparse route only on a starved host-to-device link, which
    it measures; that policy is not ported, and without it the scan stays
    2-bit, as the JAX package's does on a healthy link."""
    return config.packed_sparse and config.transport_policy == "static"


def _with_meta(seq: SeqData, res: dict) -> dict:
    """A scan core's table, its ``__idx__`` replaced by the variant columns
    of its rows in front."""
    idx = res["__idx__"]
    ref, alt = seq.ref_alt
    tab = {
        "id": seq.variant_id[idx],
        "chr": seq.chromosome[idx],
        "pos": seq.position[idx],
        "rs.id": seq.rs_id[idx],
        "ref": ref[idx],
        "alt": alt[idx],
    }
    tab.update((k, v) for k, v in res.items() if k != "__idx__")
    return tab


def assoc_spa_multi(gdsfile, modobjs, config: ScanConfig = ScanConfig(),
                    res_savefn: str = "", verbose: bool = False,
                    variant_mask: Optional[np.ndarray] = None, mesh=None,
                    res_compress: str = "LZMA", model_batch: int = 0,
                    instrument=None, *, device) -> list:
    """PheWAS-mode scan: score test + SPA for several null models over ONE
    pass of the genotype stream, on ``device`` (the JAX package's
    ``assoc_spa_multi``).

    The GDS decode, the sample gather, the pack and the upload of each
    block are paid once, and phase 1 launches once per model on the
    resident payload (B3 on the 2-bit route, B4 on the int8 route, B5
    then B4 on the sparse route), so P phenotypes cost about one pass of
    the genotypes.  The reference re-reads the GDS per model
    (R/assoc_single.r:202-222).

    ``modobjs``: NullModels or paths; binary and quantitative models may
    mix, and every model must select the same GDS sample columns.  The
    filters come from the shared ``config``, so every table covers the
    same variants in the same order; each table has the columns of
    :func:`assoc_spa`'s; ``mesh`` as :func:`assoc_spa`'s.  A model over
    only part of the GDS samples keeps the packed route (each block is
    gathered to those samples before the pack), where the JAX package
    takes its dense dosage route; both give the same table.  ``res_savefn``: a pattern with ``{}`` (the model's
    index).  ``model_batch`` > 0 scans at most that many models per pass
    of the genotypes.  ``instrument``: as :func:`assoc_spa`'s, for all
    models together.  Returns one table per model.
    """
    dev = _scan_device(device, mesh)
    if not modobjs:
        raise ValueError("assoc_spa_multi: empty model list")
    if res_savefn:
        # fail malformed patterns before the scan runs
        try:
            probe = res_savefn.format(0)
        except Exception as e:
            raise ValueError(f"res_savefn is not a valid '{{}}' pattern "
                             f"({e!r}): {res_savefn!r}") from None
        if probe == res_savefn:
            raise ValueError("res_savefn must contain '{}' (model index)")
    if model_batch and len(modobjs) > model_batch:
        results = []
        for g0 in range(0, len(modobjs), model_batch):
            grp = modobjs[g0:g0 + model_batch]
            tabs = assoc_spa_multi(gdsfile, grp, config, "", verbose,
                                   variant_mask, mesh, res_compress,
                                   instrument=instrument, device=dev)
            if res_savefn:
                for i, tab in enumerate(tabs):
                    save_assoc(tab, res_savefn.format(g0 + i),
                               res_compress=res_compress)
            results.extend(tabs)
        return results
    models = [NullModel.load(m) for m in modobjs]
    seq = gdsfile if isinstance(gdsfile, SeqData) else SeqData(gdsfile)
    if verbose:
        kinds = ",".join(m.trait_type for m in models)
        print(f"SPA association scan x{len(models)} models ({kinds}) on "
              f"{dev}: {seq.n_variants} variants, one genotype pass")
    results = _scan_models(seq, models, config, variant_mask, instrument,
                           dev, mesh)
    if res_savefn:
        for i, tab in enumerate(results):
            save_assoc(tab, res_savefn.format(i), res_compress=res_compress)
    if verbose:
        print(f"    tested {len(results[0]['id'])} variants per model")
    return results


def assoc_spa_user(geno_fn, n_variants: int, modobj: Union[NullModel, str],
                   config: ScanConfig = ScanConfig(), variant_id=None,
                   res_savefn: str = "", res_compress: str = "LZMA", *,
                   device) -> dict:
    """Score-test + SPA scan over dosages the caller supplies (the
    reference's internal ``.UserGLMM_SPA``, R/assoc_single.r:342-554),
    on ``device``, through the dense dosage route.

    ``geno_fn(start, stop)`` returns a ``[stop-start, N]`` float array of
    ALT dosages (NaN = missing) whose columns are the model's samples in
    the model's order.  ``variant_id`` names the variants (default: their
    1-based positions).  The table starts with ``id``, then the columns of
    :func:`assoc_spa` from ``AF.alt`` on.
    """
    dev = check_device(device)
    model = NullModel.load(modobj)
    scan_model = model.scan_model(var_ratio=config.var_ratio, device=dev)
    params = _scan_params(config)
    B = config.block_size

    def blocks():
        for s in range(0, n_variants, B):
            e = min(s + B, n_variants)
            G = np.asarray(geno_fn(s, e), np.float64)
            if G.shape != (e - s, model.n_samples):
                raise ValueError(
                    f"geno_fn({s}, {e}) returned shape {G.shape}, expected "
                    f"({e - s}, {model.n_samples})")
            yield np.arange(s, e), G

    res = _scan_blocks(scan_model, params, blocks(), dev,
                       binary=model.trait_type == "binary",
                       spa_compact=config.spa_compact, dense=True)
    idx = res.pop("__idx__")
    ids = np.asarray(variant_id)[idx] if variant_id is not None else idx + 1
    tab = {"id": ids}
    tab.update(res)
    if res_savefn:
        save_assoc(tab, res_savefn, res_compress=res_compress)
    return tab


def _scan_blocks(scan_model, params, block_iter, device: torch.device,
                 binary: bool, **kw) -> dict:
    """Two-phase scan core for one model: :func:`_scan_blocks_multi` with
    P = 1."""
    return _scan_blocks_multi([(scan_model, binary)], params, block_iter,
                              device, **kw)[0]


def _scan_blocks_multi(models, params, block_iter, device: torch.device,
                       packed_2bit: bool = True, sparse: bool = False,
                       spa_compact: bool = True, cols=None,
                       instrument=None, dense: bool = False,
                       mesh=None) -> list:
    """Two-phase scan core: batched score kernel + compact SPA, for one or
    several models over ONE pass of the genotype stream (the JAX
    package's ``_scan_blocks_multi``).

    ``models`` is a list of ``(scan_model, binary)`` pairs over the same
    samples.  Each block is decoded, gathered, packed and uploaded once,
    and phase 1 launches once per model on the resident payload; the
    filters (maf/mac/missing) depend on the genotypes only, so every model
    tests the same variants, and each model keeps its own SPA set.  A
    quantitative model (``binary=False``) flags nothing for SPA, and its
    table has no ``p.norm`` or ``converged`` column.  Returns one table
    per model.

    Blocks of int8 codes ship 2-bit planar (kernel B3) or, with
    ``packed_2bit=False``, as the codes themselves (kernel B4); with
    ``sparse``, each block is split by :func:`_packed_parts` and its rare
    rows ship as the gap-coded stream (kernel B5, then B4).  Phase 2 ships
    the flagged codes 2-bit either way.  With ``dense``, blocks are f64
    dosages (NaN = missing) that ship f64, or f32 where that is lossless,
    to the dense score test, and phase 2 ships the flagged rows the same
    way.  ``cols`` (GDS columns of the models' samples, from
    :func:`_match_samples`) gathers every block to those samples before it
    is packed, so phase 1 and phase 2 both see them.  With ``mesh`` (its
    lead is ``device``), each payload's rows are split into one part per
    device of the mesh (``parallel/mesh.shard_variant_batch``), uploaded
    there and scored against that device's copy of the models; phase 2
    runs on the lead, and the sparse route is off (its entry streams do
    not split by variant, as in the JAX package).

    ``instrument``: optional dict; per-block wall-times land in lists
    under ``decode_s`` (GDS block read, decode thread), ``pack_s`` (2-bit
    pack, pack thread), ``upload_s`` (host-to-device copy, upload thread),
    ``dispatch_s`` (phase-1 enqueue of every model, main thread),
    ``drain_s`` (result sync + readback), ``bytes`` (payload sizes),
    ``gather_s`` (the sample gather inside ``pack_s``, when ``cols`` is
    given), plus scalars ``spa_s`` (phase-2 time, the flushes inside
    ``drain_s`` included) and ``spa_n`` (variants refined, all models).
    Stages overlap, so sums exceed wall-clock by design.
    """
    import time as _time
    if instrument is not None:
        for k in ("decode_s", "pack_s", "upload_s", "dispatch_s",
                  "drain_s", "bytes", "gather_s"):
            instrument.setdefault(k, [])
        instrument.setdefault("spa_s", 0.0)
        instrument.setdefault("spa_n", 0)
    P = len(models)
    if dense:
        kerns = [score_stats_binary if b else score_stats_quant
                 for _sm, b in models]
        states = [sm for sm, _b in models]
    else:
        kerns = [score_stats_binary_packed if b else score_stats_quant_packed
                 for _sm, b in models]
        states = [pack_scan_model(sm) for sm, _b in models]
    if mesh is None:
        on = {device: states}          # the models' state by device
    else:
        from ..parallel.mesh import replicate, shard_variant_batch
        copies = [replicate(mesh, st) for st in states]
        on = {d: [c[d] for c in copies] for d in mesh.distinct()}
        sparse = False
    rows_idx = []
    outs = [[] for _ in range(P)]
    spa_G = [[] for _ in range(P)]      # flagged variants for phase 2
    spa_rows = [[] for _ in range(P)]
    spa_bytes = 0                   # host bytes of the flagged codes held
    spa_out = [[] for _ in range(P)]  # (rows, pval, conv, beta, se)
    row0 = 0
    window = deque()

    def _decoded(raw):
        it = iter(raw)
        while True:
            t0 = _time.perf_counter()
            try:
                idx, G = next(it)            # GDS decode happens here
            except StopIteration:
                break
            if instrument is not None:
                instrument["decode_s"].append(_time.perf_counter() - t0)
            yield idx, G

    def _packed_stage(it):
        for idx, G in it:
            t0 = _time.perf_counter()
            G = np.asarray(G, np.float64 if dense else np.int8)
            if cols is not None:
                G = np.take(G, cols, axis=1)         # the models' samples
                if instrument is not None:
                    instrument["gather_s"].append(_time.perf_counter() - t0)
            # [(rows, payload)]: f64/f32 dosages, uint8 [n, ceil(N/4)],
            # the int8 codes, or the sparse split
            parts = [(np.arange(len(idx)), _shrink_f32(G))] if dense else \
                _packed_parts(G) if sparse else \
                [(np.arange(len(idx)),
                  _pack2_block(G) if packed_2bit else G)]
            if instrument is not None:
                instrument["pack_s"].append(_time.perf_counter() - t0)
            yield idx, G, parts

    def _upload(rows, pl):
        """[(rows, device, payload there)]: the part on the scan's device,
        or split by rows over the mesh."""
        if mesh is None:
            return [(rows, device, _to_device(pl, device))]
        return [(rows[r], t.device, t) for r, t in
                shard_variant_batch(mesh, pl)]

    def _uploaded(it):
        for idx, G, parts in it:
            t0 = _time.perf_counter()
            dev_parts = [part for rows, pl in parts
                         for part in _upload(rows, pl)]
            if instrument is not None:
                instrument["upload_s"].append(_time.perf_counter() - t0)
                instrument["bytes"].append(sum(
                    sum(x.nbytes for x in pl) if isinstance(pl, tuple)
                    else pl.nbytes for _, pl in parts))
            yield idx, G, dev_parts

    block_iter = _prefetch_blocks(
        _uploaded(_prefetch_blocks(
            _packed_stage(_prefetch_blocks(
                _decoded(block_iter),
                name="decode", instrument=instrument)),
            name="pack", instrument=instrument)),
        name="upload", instrument=instrument)

    def _drain_one():
        nonlocal row0, spa_bytes
        t_dr = _time.perf_counter()
        idx, G, results = window.popleft()
        n = len(idx)
        n_valid = 0
        for p in range(P):
            valid = np.empty(n, bool)
            need = np.empty(n, bool)
            f = {k: np.empty(n) for k in ("af", "mac", "num", "beta", "se",
                                          "pval")}
            for rows, stacked in results[p]:
                res = unstack_stats(stacked.cpu().numpy())   # one readback
                valid[rows] = res.valid
                need[rows] = res.need_spa
                for k in f:
                    f[k][rows] = getattr(res, k)
            if p == 0:
                rows_idx.append(idx[valid])
                n_valid = int(valid.sum())
            out = {k: v[valid] for k, v in f.items()}
            out["converged"] = np.isfinite(out["pval"])
            out["pval_noadj"] = out["pval"].copy()
            needv = need[valid]
            if needv.any():
                Gf = G[valid][needv]   # codes ship 2-bit, dosages f64/f32
                spa_G[p].append(Gf)
                spa_rows[p].append(row0 + np.flatnonzero(needv))
                spa_bytes += Gf.nbytes
            outs[p].append(out)
        row0 += n_valid
        # bound host memory: refine incrementally once the flagged sets
        # grow past the budget
        if spa_bytes >= SPA_FLUSH_BYTES:
            _flush_spa()
        if instrument is not None:
            instrument["drain_s"].append(_time.perf_counter() - t_dr)

    def _flush_spa():
        nonlocal spa_bytes
        spa_bytes = 0
        for p in range(P):
            if spa_G[p]:
                _flush_model(p)

    def _flush_model(p):
        t_spa = _time.perf_counter()
        scan_model = models[p][0]
        Gs = np.concatenate(spa_G[p], axis=0)
        rows = np.concatenate(spa_rows[p])
        spa_G[p].clear()
        spa_rows[p].clear()
        if instrument is not None:
            instrument["spa_n"] += len(rows)
        # compact batches grouped by nonzero count, so rare variants run
        # the compacted CGF even when the flagged set mixes in common ones
        if spa_compact and len(rows) > 1:
            order = np.argsort(_spa_nnz(Gs), kind="stable")
            Gs, rows = Gs[order], rows[order]
        N = Gs.shape[1]
        caps = _spa_caps(Gs, spa_compact)

        codes = np.issubdtype(Gs.dtype, np.integer)

        def _spa_payloads():
            # payload build + upload in the prefetch worker, like phase 1;
            # codes ship 2-bit packed (N/4 bytes per variant)
            for s, e in _spa_batches(caps, SPA_BATCH):
                Gi = Gs[s:e]
                payload = _pack2_block(Gi) if codes else _shrink_f32(Gi)
                yield rows[s:e], _to_device(payload, device), int(caps[s])

        for r, Gb, cap in _prefetch_blocks(_spa_payloads()):
            res = spa_refine_binary(scan_model, Gb, cap=cap,
                                    packed_n=N if codes else 0)
            a = torch.stack([res[0], res[1].to(torch.float64), res[2],
                             res[3]]).cpu().numpy()
            spa_out[p].append((r, a[0], a[1] != 0, a[2], a[3]))
        if instrument is not None:
            instrument["spa_s"] += _time.perf_counter() - t_spa

    for idx, G, parts in block_iter:
        t_di = _time.perf_counter()
        results = [[(rows, stack_stats(kerns[p](on[d][p], params, payload)))
                    for rows, d, payload in parts] for p in range(P)]
        if instrument is not None:
            instrument["dispatch_s"].append(_time.perf_counter() - t_di)
        window.append((idx, G, results))
        if len(window) >= DEPTH:
            _drain_one()
    while window:
        _drain_one()
    _flush_spa()  # phase 2 over the remaining flagged subsets

    idx_all = np.concatenate(rows_idx) if rows_idx else np.empty(0, int)
    tabs = []
    for p, (_sm, binary) in enumerate(models):
        def col(k):
            return np.concatenate([o[k] for o in outs[p]]) if outs[p] \
                else np.empty(0)

        pval = col("pval")
        beta = col("beta")
        se = col("se")
        converged = col("converged")
        for r, pv, conv, b, e in spa_out[p]:
            pval[r] = pv
            converged[r] = conv
            beta[r] = b
            se[r] = e
        tab = {
            "__idx__": idx_all,
            "AF.alt": col("af"),
            "mac": col("mac"),
            "num": col("num").astype(np.int32),
            "beta": beta,
            "SE": se,
            "pval": pval,
        }
        if binary:
            tab["p.norm"] = col("pval_noadj")
            tab["converged"] = converged.astype(bool)
        tabs.append(tab)
    return tabs


def _to_device(a, device: torch.device):
    """Host array (or tuple of arrays: the sparse transport) -> tensor(s)
    on ``device``; a CUDA upload goes through a pinned buffer and
    completes before returning."""
    if isinstance(a, tuple):
        return tuple(_to_device(x, device) for x in a)
    t = torch.from_numpy(a)
    if device.type == "cuda":
        t = t.pin_memory().to(device)
    return t


SPLIT_SAVE_BYTES = 4 << 20   # min upload saving to justify a 2nd payload
SPLIT_SAVE_FRAC = 0.25       # ... and it must be >= this fraction of the
#                              block's 2-bit bytes
MIN_SPLIT = 64               # rows on each side of a split block


def _packed_parts(G: np.ndarray):
    """Split one int8 code block into host transport payloads by the
    static nonzero-count rule -> ``[(rows, payload), ...]``.

    Rare rows (nonzero fraction < 1/8) ship as the gap-coded
    ``(entries, row_ptr)`` stream, the rest 2-bit planar.  The block splits
    into two payloads only when the sparse side's byte saving is
    substantial (SPLIT_SAVE_BYTES and SPLIT_SAVE_FRAC, MIN_SPLIT rows a
    side); otherwise the whole block goes sparse when that at least halves
    its 2-bit bytes, and 2-bit when not.  ``rows`` indexes the block.  The
    JAX package's link-aware ``TransportPolicy`` is not ported: this is its
    ``policy=None`` rule.
    """
    n, N = G.shape
    sp_rows, de_rows = np.empty(0, np.int64), np.arange(n)
    if n * N < (1 << 31):                        # the encoder's bound
        nnz = (G != 0).sum(axis=1)
        mask = nnz < (N * SPARSE_NNZ_FRAC)
        ns = int(mask.sum())
        row_bytes = N // 4
        whole_sparse = 2 * int(nnz.sum()) < (n * row_bytes) // 2
        saving = ns * row_bytes - 2 * int(nnz[mask].sum())
        if min(ns, n - ns) >= MIN_SPLIT and saving >= max(
                SPLIT_SAVE_BYTES, SPLIT_SAVE_FRAC * n * row_bytes):
            sp_rows, de_rows = np.flatnonzero(mask), np.flatnonzero(~mask)
        elif whole_sparse:
            sp_rows, de_rows = np.arange(n), np.empty(0, np.int64)
    parts = []
    if len(sp_rows):
        parts.append((sp_rows, encode_sparse_rows(
            G if len(sp_rows) == n else G[sp_rows])))
    if len(de_rows):
        parts.append((de_rows, _pack2_block(
            G if len(de_rows) == n else G[de_rows])))
    return parts


def _spa_nnz(Gi: np.ndarray) -> np.ndarray:
    """Per-variant nonzero count after imputation + flip (for bucketing).

    Accepts f64 dosages (NaN missing) or int8 codes (3 missing); the codes
    branch computes the identical count from per-variant 0/2/missing tallies
    without materializing the f64 matrix (flip iff ac > num; an imputed
    entry is nonzero iff ac != 0, or ac != 2*num when flipped)."""
    if np.issubdtype(Gi.dtype, np.integer):
        N = Gi.shape[1]
        miss = Gi == 3
        n_miss = miss.sum(axis=1)
        num = N - n_miss
        ac = np.where(miss, 0, Gi).sum(axis=1, dtype=np.int64)
        c0 = (Gi == 0).sum(axis=1)
        c2 = (Gi == 2).sum(axis=1)
        flip = ac > num
        nz_obs = np.where(flip, N - c2, N - c0) - n_miss
        imp_nz = np.where(flip, ac != 2 * num, ac != 0)
        return nz_obs + np.where(imp_nz, n_miss, 0)
    isnan = np.isnan(Gi)
    num = (~isnan).sum(axis=1)
    ac = np.where(isnan, 0.0, Gi).sum(axis=1)
    with np.errstate(invalid="ignore", divide="ignore"):
        af = ac / (2 * num)
        g = np.where(isnan, (ac / np.maximum(num, 1))[:, None], Gi)
    g = np.where((af > 0.5)[:, None], 2.0 - g, g)
    return np.nan_to_num(g != 0).sum(axis=1)


def _spa_caps(Gs: np.ndarray, compact: bool = True) -> np.ndarray:
    """Each variant's SPA compaction width: the power-of-two bucket (at
    least 1,024) covering its nonzero count after imputation + flip (so
    compaction is exact); 0 (no compaction) where that bucket reaches 3/4
    of the samples, or without ``compact``."""
    if not compact:
        return np.zeros(len(Gs), np.int64)
    caps = np.array([1 << max(10, int(v - 1).bit_length())
                     for v in _spa_nnz(Gs)], np.int64)
    return np.where(caps >= 0.75 * Gs.shape[1], 0, caps)


def _spa_batches(caps: np.ndarray, size: int) -> list:
    """[start, stop) SPA batches of at most ``size`` rows that share one
    compaction width, so that a variant is refined at its own width
    whatever else is flagged (rows sorted by nonzero count keep equal
    widths together)."""
    out, s = [], 0
    while s < len(caps):
        e = min(s + size, len(caps))
        other = np.flatnonzero(caps[s:e] != caps[s])
        e = s + int(other[0]) if len(other) else e
        out.append((s, e))
        s = e
    return out


def _match_samples(gds_samples, model_samples):
    """Align GDS genotype columns with the model's samples
    (reference R/assoc_single.r:136-142).

    Returns ``(cols, ii)``: ``cols`` selects the GDS columns belonging to
    the model's samples, kept in GDS order, and ``ii`` is the model
    position of each kept column.  Both are ``None`` when the orders
    already coincide.
    """
    if model_samples is None:
        return None, None
    gds_samples = np.asarray(gds_samples)
    model_samples = np.asarray(model_samples)
    if len(gds_samples) == len(model_samples) and \
            (gds_samples == model_samples).all():
        return None, None
    lookup = {s: i for i, s in enumerate(model_samples)}
    cols = np.asarray([i for i, s in enumerate(gds_samples) if s in lookup],
                      dtype=np.int64)
    if len(cols) != len(model_samples):
        raise ValueError("model samples missing from the GDS file")
    ii = np.asarray([lookup[gds_samples[c]] for c in cols], dtype=np.int64)
    return cols, ii


RES_COMPRESS_CHOICES = ("LZMA", "LZMA_RA", "ZIP", "ZIP_RA", "none")


def save_assoc(tab: dict, path: str, file_format: str = "SAIGE_OUTPUT",
               res_compress: str = "LZMA"):
    """Save a result table (gds / rds / rda / csv / tsv by extension).

    ``.gds`` writes the reference's SAIGE_OUTPUT container and
    ``.rds``/``.rda`` its saveRDS/save outputs (R/assoc_single.r:242-333;
    the .rda object is named ``.res`` like the reference's), all readable
    by ``seqSAIGE_LoadPval`` and the JAX package's ``load_pval``.
    ``res_compress`` (LZMA, LZMA_RA, ZIP, ZIP_RA, none — the reference's
    ``res.compress`` choices) applies to the gds column pipes and, mapped
    as the reference maps it (LZMA* to xz, ZIP* to gzip,
    R/assoc_single.r:313-314), to the rds/rda streams.  ``.csv``/``.csv.gz``
    write comma-separated text and any other extension tab-separated
    text, with a header row and NaN as an empty field.  ``.parquet`` raises:
    it needs pandas and pyarrow, which this package does not use.
    """
    if res_compress not in RES_COMPRESS_CHOICES:
        raise ValueError("`res_compress` should be one of LZMA, LZMA_RA, "
                         "ZIP, ZIP_RA and none.")
    low = path.lower()
    if low.endswith(".gds"):
        from ..io.gds_write import write_gds_table
        write_gds_table(path, tab, file_format=file_format,
                        compress="" if res_compress == "none"
                        else res_compress)
    elif low.endswith(".rds"):
        from ..io.rds_write import write_rds
        write_rds(path, _df_to_robject(tab), compress=_rcompress(res_compress))
    elif low.endswith((".rda", ".rdata")):
        from ..io.rds_write import write_rdata
        write_rdata(path, {".res": _df_to_robject(tab)},
                    compress=_rcompress(res_compress))
    elif low.endswith(".parquet"):
        raise NotImplementedError(
            f"saving {path!r}: parquet needs pandas and pyarrow, which the "
            "PyTorch port does not use (ROADMAP, Not ported); save as .gds, "
            ".rds, .rda, .csv or .tsv")
    else:
        _write_text(tab, path,
                    sep="," if low.endswith((".csv", ".csv.gz")) else "\t")


def _rcompress(res_compress: str):
    """res.compress -> saveRDS/save compress argument
    (R/assoc_single.r:313)."""
    return {"LZMA": "xz", "LZMA_RA": "xz", "ZIP": "gzip",
            "ZIP_RA": "gzip"}.get(res_compress, True)


def _df_to_robject(tab: dict):
    """A table (dict of numpy columns) -> an R data.frame for the rds
    writer; string columns become character vectors."""
    from ..io.rds import RObject
    cols = {}
    for c, v in tab.items():
        v = np.asarray(v)
        if v.dtype == object or v.dtype.kind in ("U", "S"):
            v = np.asarray([None if x is None else str(x) for x in v],
                           dtype=object)
        cols[c] = v
    n = len(next(iter(cols.values()))) if cols else 0
    return RObject(cols, {
        "names": np.asarray(list(cols), dtype=object),
        "class": np.asarray(["data.frame"], dtype=object),
        "row.names": np.arange(1, n + 1, dtype=np.int32),
    })


def _write_text(tab: dict, path: str, sep: str):
    import csv
    import gzip

    def cell(x):
        if isinstance(x, (float, np.floating)):
            return "" if np.isnan(x) else repr(float(x))
        return x

    opener = gzip.open if path.lower().endswith(".gz") else open
    with opener(path, "wt", newline="") as f:
        w = csv.writer(f, delimiter=sep)
        w.writerow(list(tab))
        for row in zip(*(np.asarray(v).tolist() for v in tab.values())):
            w.writerow([cell(x) for x in row])
