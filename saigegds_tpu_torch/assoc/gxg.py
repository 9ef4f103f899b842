"""GxG SNP-pair interaction tests with SPA adjustment, on a torch device.

The counterpart of ``saigegds_tpu/assoc/gxg.py``: ``seqGLMM_GxG_spa``
(reference R/saige_interaction.r:44-641 + ``saige_GxG_snp_bin``
src/saige_fitnull.cpp:1480-1558).  For each SNP pair the two
minor-allele-coded dosage vectors join the covariates, the null GLMM is
refitted (or a pre-fitted tau reused, or a plain-GLM screen skips it),
and the product ``g1*g2`` is score-tested with a full PCG variance (no
variance-ratio shortcut) and the full saddlepoint approximation.  Binary
traits only, like the reference (quantitative raises, :531-533).

The GRM is the fit's: the 2-bit operator (kernels B1 and B2 on a card),
built by the streamed builder with the fit's variant filter and
``max_num_snp`` down-sampling, so the host never holds the whole code
matrix; ``grm_impl="dense"`` builds the dense f64 oracle.  Tables are
dicts of numpy columns.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Union

import numpy as np
import torch

from ..config import NullModelConfig
from ..io.seqarray import SeqData
from ..models.fitnull import (_Binomial, _binary_tau_init, _FitGRM,
                              _mat_inv, _parse_formula, _prepare_fit,
                              fit_ai_pcg)
from ..models.glm import glm_binomial, obj_nok_binary, qr_transform
from ..ops._cuda import check_device
from ..ops.pcg import pcg_solve
from ..ops.spa import saddle_prob_batch
from ..ops.special import pchisq1_sf, qnorm
from ..utils.rrandom import RRandom

_COLS = ("beta", "SE", "n_nonzero", "pval", "p.norm", "converged", "tau_G")


def _minor_allele_geno(g: np.ndarray) -> np.ndarray:
    """Flip to minor allele, mean-impute (R/saige_interaction.r:12-23)."""
    g = np.asarray(g, np.float64).copy()
    if np.isnan(g).any():
        af = np.nanmean(g)
        if not np.isfinite(af):
            af = 0.0
        g[np.isnan(g)] = af
    if g.mean() > 1.0:
        g = 2.0 - g
    return g


def _weights(fit0) -> np.ndarray:
    fam = _Binomial()
    mu_eta = fam.mu_eta(fit0.linear_predictors)
    return (mu_eta * mu_eta) / fam.variance(fit0.fitted_values)


def _finish(grm: _FitGRM, stats: list, Gs: np.ndarray, mus: np.ndarray):
    """SPA p-values of a batch of pairs: ``stats`` holds per pair (beta,
    Tstat, var1, var2, m1, qtilde, n_nonzero, tau_G).  One batched full
    SPA (every lane exact) that keeps Saddle_Prob's own pval = 0
    (``zero_noadj=False``, src/saige_fitnull.cpp:1540)."""
    dev = grm.op.device
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=dev)
    st = np.asarray([s[:6] for s in stats], np.float64)
    beta, tstat, var1, var2, m1, qt = st.T
    pv, conv = saddle_prob_batch(
        t(qt), t(m1), t(var2), t(Gs), t(mus),
        torch.ones(Gs.shape, dtype=torch.bool, device=dev), cutoff=2.0,
        zero_noadj=False)
    pv = pv.cpu().numpy()
    # p.norm = pchisq((qtilde-m1)^2/var2) = pchisq(Tstat^2/var1)
    pnorm = pchisq1_sf(t(tstat * tstat / var1)).cpu().numpy()
    z = qnorm(t(pv / 2.0)).cpu().numpy()
    conv = conv.cpu().numpy()
    return [dict(zip(_COLS, (float(beta[p]), float(abs(beta[p] / z[p])),
                             stats[p][6], float(pv[p]), float(pnorm[p]),
                             bool(conv[p]), stats[p][7])))
            for p in range(len(stats))]


def _pair_moments(fit0, nok, G, Sigma_iX, Sigma_iG):
    """(beta, Tstat, var1, var2, m1, qtilde) of one pair's interaction."""
    X1, y, mu = nok.X1, fit0.y, fit0.fitted_values
    adj = Sigma_iX @ (_mat_inv(X1.T @ Sigma_iX) @ (X1.T @ Sigma_iG))
    S = float((y - mu) @ G)
    var1 = float(G @ Sigma_iG) - float(G @ adj)
    var2 = float((mu * (1 - mu)) @ (G * G))
    m1 = float(mu @ G)
    tstat = float(y @ G) - m1
    qtilde = tstat / np.sqrt(var1) * np.sqrt(var2) + m1
    return S / var1, tstat, var1, var2, m1, qtilde


def _gxg_stat_batch(grm: _FitGRM, states, taus, inters, cfg):
    """``saige_GxG_snp_bin`` (src/saige_fitnull.cpp:1480-1558) for a batch
    of pairs: every pair's [X1 | G] columns ride ONE per-column PCG (each
    column with its pair's weights and tau, so each does the iterations
    of its own solve) and one batched SPA; per pair the arithmetic of
    :func:`_pair_moments`.

    ``states``: [(fit0, nok)] per pair; ``taus`` [P, 2]; ``inters``
    [P, N].  Returns a list of per-pair result dicts."""
    P, N = inters.shape
    # per-pair column offsets: X1 widths differ when the QR transform
    # drops a collinear dosage for some pairs
    offs = np.concatenate([[0], np.cumsum([nok.X1.shape[1] + 1
                                           for _f, nok in states])])
    C = int(offs[-1])
    B, Wb, taub = np.empty((N, C)), np.empty((N, C)), np.empty((2, C))
    Gs = np.empty((P, N))
    for p, (fit0, nok) in enumerate(states):
        G = inters[p] - nok.XXVX_inv @ (nok.XV @ inters[p])
        Gs[p] = G
        s0, s1 = int(offs[p]), int(offs[p + 1])
        B[:, s0:s1 - 1] = nok.X1
        B[:, s1 - 1] = G
        Wb[:, s0:s1] = _weights(fit0)[:, None]
        taub[:, s0:s1] = np.asarray(taus[p], np.float64)[:, None]
    t = lambda a: torch.as_tensor(a, dtype=torch.float64,
                                  device=grm.op.device)
    sol, iters, conv = pcg_solve(grm.op, t(Wb), t(taub), t(B), cfg.tol_pcg,
                                 cfg.maxiter_pcg)
    grm.pcg_iterations += int(iters.max())
    if not bool(conv.all()):
        print("PCG does not converge (may need to increase 'maxiter').")
    sol = sol.cpu().numpy()
    stats = []
    for p, (fit0, nok) in enumerate(states):
        s0, s1 = int(offs[p]), int(offs[p + 1])
        stats.append(_pair_moments(fit0, nok, Gs[p], sol[:, s0:s1 - 1],
                                   sol[:, s1 - 1])
                     + (int((inters[p] != 0).sum()),
                        float(np.asarray(taus[p])[1])))
    return _finish(grm, stats, Gs,
                   np.stack([f0.fitted_values for f0, _n in states]))


def _device_taus(grm: _FitGRM, y, X_list, eta0_list, tau_init, cfg):
    """Per-pair tau of the batched refits: the batched fitter of
    ``models/fit_device.py`` with one design per lane, over the shared
    GRM (the JAX package vmaps its one-lane device fit).  Probes: a pool
    of nrun + 30 columns of R's stream.  Lanes whose designs differ in
    width (a collinear dosage dropped) run in separate batches; the
    lanes' phenotypes, designs and starts stay on the host until their
    group runs."""
    from ..models.fit_device import _binary_multi

    dev = grm.op.device
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=dev)
    host = lambda a: torch.as_tensor(np.asarray(a, np.float64))
    rng = RRandom(cfg.seed)
    n = len(y)
    U = t(np.stack([rng.rademacher(n).astype(np.float64)
                    for _ in range(cfg.nrun + 30)], axis=1))
    taus = np.empty((len(X_list), 2))
    widths = np.asarray([X.shape[1] for X in X_list])
    for k in np.unique(widths):
        lanes = np.flatnonzero(widths == k)
        L = len(lanes)
        fit = _binary_multi(
            grm.op, host(np.tile(y, (L, 1))),
            host(np.stack([X_list[i] for i in lanes])),
            host(np.tile(tau_init, (L, 1))),
            host(np.stack([eta0_list[i] for i in lanes])), U, cfg.tol,
            cfg.tol_pcg, maxiter=cfg.maxiter, maxiter_pcg=cfg.maxiter_pcg,
            nrun=cfg.nrun, trace_cv_cutoff=cfg.trace_cv_cutoff)
        grm.pcg_iterations += fit.pcg_iterations
        taus[lanes] = fit.tau.cpu().numpy()
    return taus


def _table(rows: list, extra: dict) -> dict:
    """Row dicts -> a dict of numpy columns, with the pair table's extra
    columns cut to the rows done."""
    keys = list(dict.fromkeys(k for r in rows for k in r))
    tab = {k: np.asarray([r.get(k, np.nan) for r in rows]) for k in keys}
    for c, vals in extra.items():
        tab[c] = np.asarray(vals)[:len(rows)]
    return tab


def _pair_columns(snp_pair):
    """``snp_pair`` -> ([(id1, id2)], extra columns): a dict of columns (or
    a table with ``.columns``) whose first two columns are the pair, or a
    sequence of rows whose first two entries are."""
    if hasattr(snp_pair, "columns"):
        cols = {c: np.asarray(snp_pair[c]) for c in snp_pair.columns}
    elif isinstance(snp_pair, dict):
        cols = {c: np.asarray(v) for c, v in snp_pair.items()}
    else:
        rows = [tuple(r) for r in snp_pair]
        width = min(len(r) for r in rows) if rows else 2
        cols = {j: np.asarray([r[j] for r in rows]) for j in range(width)}
    names = list(cols)
    if len(names) < 2:
        raise ValueError("snp_pair needs two columns of variant ids")
    pairs = list(zip(cols[names[0]].tolist(), cols[names[1]].tolist()))
    return pairs, {c: cols[c] for c in names[2:]}


def _gxg_run(grm, ori_X, y, pairs, fetch, tau_init, use_approx_tau,
             glm_threshold, cfg, pair_batch, res_savefn, extra,
             res_compress="LZMA") -> dict:
    """GxG over ``pairs`` in chunks of ``pair_batch`` (1: one pair at a
    time, as the reference runs them, R/saige_interaction.r:413-521): a
    chunk's solves share one per-column PCG and one SPA, so a pair's
    statistic does not depend on the chunk it rides in.  The GLM screen
    and ``use_approx_tau`` take their tau as given; full per-pair refits
    are the host fit (``fit_ai_pcg``) one pair at a time and the batched
    fitter in chunks (tau within the AI-REML stopping tolerance of the
    host fit's).  The table is saved after every chunk."""
    from .single import save_assoc

    batch = pair_batch if pair_batch and pair_batch > 1 else 1
    rows = []
    for c0 in range(0, len(pairs), batch):
        chunk = pairs[c0:c0 + batch]
        metas, states, inters, Xs, eta0s = [], [], [], [], []
        for i1, i2 in chunk:
            g1, s1 = fetch(i1)
            g2, s2 = fetch(i2)
            # collinearity drop + QR transform (R/saige_interaction.r:457-480)
            X_new, _, _ = qr_transform(np.column_stack([ori_X, g1, g2]))
            fit0 = glm_binomial(X_new, y)
            metas.append(dict(id1=i1, snp1=s1, maf1=g1.mean() * 0.5,
                              id2=i2, snp2=s2, maf2=g2.mean() * 0.5))
            states.append((fit0, obj_nok_binary(X_new, y)))
            inters.append(g1 * g2)
            Xs.append(X_new)
            eta0s.append(fit0.linear_predictors)
        inters = np.stack(inters)
        P = len(chunk)

        screen = None
        run = np.ones(P, bool)
        if glm_threshold is not False:
            screen = _gxg_stat_batch(grm, states, np.tile([1.0, 0.0], (P, 1)),
                                     inters, cfg)
            run = np.asarray([np.isfinite(d["pval"]) and
                              d["pval"] <= glm_threshold for d in screen])
        sel = np.flatnonzero(run)
        taus = np.tile(np.asarray(tau_init, float), (P, 1))
        if len(sel) and not use_approx_tau and batch > 1:
            taus[sel] = _device_taus(grm, y, [Xs[i] for i in sel],
                                     [eta0s[i] for i in sel], tau_init, cfg)
        elif len(sel) and not use_approx_tau:
            for i in sel:
                taus[i] = fit_ai_pcg(grm, states[i][0], Xs[i], tau_init, cfg,
                                     binary=True).tau
        full = [None] * P
        if len(sel):
            res = _gxg_stat_batch(grm, [states[i] for i in sel], taus[sel],
                                  inters[sel], cfg)
            for j, i in enumerate(sel):
                full[i] = res[j]

        for p in range(P):
            if screen is not None:
                d = dict(full[p] if full[p] is not None else screen[p])
                if full[p] is None:
                    d["pval"] = d["p.norm"] = np.nan
                d["p.glm"] = screen[p]["pval"]
                d["p.glm.norm"] = screen[p]["p.norm"]
            else:
                d = full[p]
            row = dict(metas[p])
            row.update(d)
            rows.append(row)
        if res_savefn:
            # incremental save, like the reference (:612-631): a crash
            # loses no finished pair
            save_assoc(_table(rows, {}), res_savefn,
                       res_compress=res_compress)
    out = _table(rows, extra)
    if res_savefn:
        save_assoc(out, res_savefn, res_compress=res_compress)
    return out


def gxg_spa(formula: str, data, gds_grm, snp_pair, gds_assoc=None,
            config: NullModelConfig = NullModelConfig(),
            use_approx_tau: bool = False,
            glm_threshold: Union[bool, float] = False,
            res_savefn: str = "", verbose: bool = False, variant_id=None,
            pair_batch: int = 0, res_compress: str = "LZMA",
            instrument=None, *, device) -> dict:
    """GxG interaction scan over SNP pairs (binary traits) on ``device``.

    ``data``: a mapping from column name to a 1-D array, as the fit
    takes.  ``snp_pair``: two columns of variant ids in ``gds_assoc``
    (default ``gds_grm``), as a dict of columns whose first two are the
    pair (any others are copied to the table) or a sequence of rows.
    ``variant_id``: explicit GRM SNP panel, replacing the maf/missing
    filter (the reference's ``variant.id=``, R/saige_interaction.r:46,
    :237-247).  ``use_approx_tau`` reuses the base fit's tau for every
    pair; ``glm_threshold`` (True = 0.01) screens each pair with a plain
    GLM first and refits only pairs whose GLM p-value is at most the
    threshold (``p.glm``/``p.glm.norm`` columns); ``res_savefn`` saves
    the table after every pair, as the reference does (:612-631), or
    after every batch.

    ``pair_batch > 1`` runs that many pairs per batch: their solves share
    one per-column PCG and one SPA; equal to the serial path with
    ``use_approx_tau`` or the GLM screen, and with full refits through
    the batched fitter (tau within the stopping tolerance of the host
    fit's, which refits the serial path's pairs).  ``instrument``: optional dict that receives the wall seconds
    of the GRM build (``ingest_s``), of the base fit (``base_fit_s``) and
    of the pairs (``pairs_s``), and the GRM products and PCG iterations
    run.  Returns the table as a dict of numpy columns.
    """
    dev = check_device(device)
    if config.trait_type != "binary":
        raise NotImplementedError(
            "quantitative GxG is unimplemented, like the reference "
            "(R/saige_interaction.r:531-533)")
    # per-pair refits must not collide on a mid-fit checkpoint; GxG's
    # resume story is the per-pair incremental result save
    cfg = (dataclasses.replace(config, checkpoint="")
           if config.checkpoint else config)
    seq = gds_grm if isinstance(gds_grm, SeqData) else SeqData(gds_grm)
    seq_assoc = seq if gds_assoc is None else (
        gds_assoc if isinstance(gds_assoc, SeqData) else SeqData(gds_assoc))
    resp, covs = _parse_formula(formula)
    t0 = time.perf_counter()
    # the fit's samples, variant filter and down-sampling; a streamed
    # build of the 2-bit store unless the dense oracle is asked for
    prep = _prepare_fit(
        seq, data,
        cfg if cfg.grm_impl == "dense"
        else dataclasses.replace(cfg, stream_geno=True),
        resp, covs, variant_id, verbose, formula, dev, harvest=False)
    grm = _FitGRM(prep["grm"])
    y = prep["data"][resp].astype(np.float64)
    ori_X = prep["X"]

    a_order = {s: i for i, s in enumerate(seq_assoc.sample_id.astype(str))}
    i_geno = np.asarray([a_order[s] for s in
                         prep["data"][cfg.sample_col].astype(str)])
    vid_pos = {v: i for i, v in enumerate(seq_assoc.variant_id.tolist())}

    tau_init = _binary_tau_init(cfg)
    t1 = time.perf_counter()
    if use_approx_tau:
        X_new, _, _ = qr_transform(ori_X)
        glmm0 = fit_ai_pcg(grm, glm_binomial(X_new, y), X_new, tau_init,
                           cfg, binary=True, verbose=verbose)
        tau_init = glmm0.tau
    if glm_threshold is True:
        glm_threshold = 0.01
    t2 = time.perf_counter()

    def _fetch(vid):
        i = vid_pos[vid]
        g = seq_assoc.dosage_block(i, i + 1)[0][i_geno]
        allele = seq_assoc.allele[i].replace(",", "_")
        return _minor_allele_geno(g), \
            f"{seq_assoc.chromosome[i]}:{seq_assoc.position[i]}_{allele}"

    pairs, extra = _pair_columns(snp_pair)
    out = _gxg_run(grm, ori_X, y, pairs, _fetch, tau_init, use_approx_tau,
                   glm_threshold, cfg, pair_batch, res_savefn, extra,
                   res_compress)
    if instrument is not None:
        instrument.update(ingest_s=t1 - t0, base_fit_s=t2 - t1,
                          pairs_s=time.perf_counter() - t2,
                          matvecs=grm.op.matvecs,
                          pcg_iterations=grm.pcg_iterations)
    return out
