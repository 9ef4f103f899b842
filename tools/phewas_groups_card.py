"""Lane groups of the PheWAS fit on one card: what splitting the lanes
costs, and what the caching allocator leaves of the free memory when a
group is as large as the group rule allows.

    python tools/phewas_groups_card.py [--lanes 15] [--share 1.0]

On the full-width data of ``chip_smoke.py`` (phase 4's GDS: 16,384 GRM
variants x 430,000 samples, with phase 16's PheWAS phenotypes):

1. ``fit_null_glmm_multi`` of ``--lanes`` binary phenotypes by the group
   rule, one ingest, its operator and its fitters' inputs kept;
2. the binary AI-REML fitter on those inputs with the lanes forced into
   one group and into two: wall seconds, GRM products, PCG iterations;
3. with the rule's plan share (``fit_device._PLAN_SHARE``) set to
   ``--share``, the largest group the rule then allows, in one group:
   the binary fitter (a whole fit), the variance-ratio pass and the
   quantitative fitter, each with its peak allocated and reserved bytes
   and the caching allocator's peak of split-off free bytes beside the
   free bytes at entry; then the variance-ratio pass's bytes per lane
   (peaks at 2, 4 and 6 lanes) against ``fit_device._lane_bytes``.

An out-of-memory error in step 3 is reported, not raised, and step 3 is
then repeated in a second process with the allocator's expandable
segments on (``PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True``).
Each step prints one JSON line; a process's lines also go to
``chiprun_out/phewas_groups_default.json`` (``..._expandable.json`` for
the second).  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

RESULTS = []


def emit(step: str, **fields):
    line = dict(step=step, **fields)
    RESULTS.append(line)
    print(json.dumps(line), flush=True)


def memory(torch, device, free_in: int, base: int) -> dict:
    s = torch.cuda.memory_stats(device)
    return dict(free_at_entry=free_in,
                allocated=torch.cuda.max_memory_allocated(device) - base,
                reserved=torch.cuda.max_memory_reserved(device),
                split_free_peak=s.get("inactive_split_bytes.all.peak", 0))


def measured(torch, device, fn) -> dict:
    """``fn()`` with the peaks reset first: its result under ``out``, the
    seconds, the memory fields, or the out-of-memory error's text."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free_in = torch.cuda.mem_get_info(device)[0]
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    try:
        out = fn()
        torch.cuda.synchronize()
        oom = None
    except torch.OutOfMemoryError as e:
        out, oom = None, str(e).splitlines()[0]
    res = dict(seconds=time.perf_counter() - t0, oom=oom,
               **memory(torch, device, free_in, base))
    torch.cuda.empty_cache()
    return out, res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lanes", type=int, default=15)
    ap.add_argument("--share", type=float, default=1.0)
    ap.add_argument("--edges-only", action="store_true")
    a = ap.parse_args()

    import torch
    from saigegds_tpu_torch import NullModelConfig, fit_null_glmm_multi
    from saigegds_tpu_torch.io.gds_write import write_seqarray_gds
    from saigegds_tpu_torch.models import fit_device as fd
    from saigegds_tpu_torch.models import fitnull
    from saigegds_tpu_torch.ops import _cuda
    from saigegds_tpu_torch.ops.packed_grm import N_SLICES, kernel_cols

    if not torch.cuda.is_available():
        print("phewas_groups_card: no card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    emit("card", card=card, torch=torch.__version__,
         alloc_conf=os.environ.get("PYTORCH_CUDA_ALLOC_CONF", ""))
    _cuda.load("plane_dot")

    work = os.path.join(ROOT, "_smoke", "groups")
    os.makedirs(work, exist_ok=True)
    gds = os.path.join(work, "fit.gds")
    t0 = time.perf_counter()
    codes, data = cs.make_fit_data(cs.N_SAMPLES, cs.M_FIT, device, cs.SEED,
                                   more_phenotypes=cs.PHEWAS_MORE)
    if not os.path.exists(gds):
        write_seqarray_gds(gds, codes, compress="ZIP_ra")
    del codes
    emit("setup", seconds=time.perf_counter() - t0)

    # 1. the PheWAS fit by the rule, its operator and inputs kept
    P = a.lanes
    resps = (["y"] + [f"yb{p}" for p in cs.PHEWAS_CASES]
             + [f"yp{k}" for k in range(P - 1 - len(cs.PHEWAS_CASES))])
    formulas = [f"{r} ~ x1 + x2 + x3" for r in resps]
    kept = {}
    real_prep, real_bin = fitnull._prepare_fit, fd._binary_multi
    real_vr, real_rule = fitnull.calc_var_ratio_multi, fd._lane_groups

    def prep(*args, **kw):
        out = real_prep(*args, **kw)
        kept["op"] = out["grm"]
        return out

    def binary(*args, **kw):
        kept["fit"] = (args, kw)
        return real_bin(*args, **kw)

    def var_ratio(*args, **kw):
        kept["vr"] = (args, kw)
        return real_vr(*args, **kw)

    fitnull._prepare_fit, fd._binary_multi = prep, binary
    fitnull.calc_var_ratio_multi = var_ratio
    inst = {}
    try:
        _, res = measured(torch, device, lambda: fit_null_glmm_multi(
            formulas, data, gds, NullModelConfig(), instrument=inst,
            device=device))
    finally:
        fitnull._prepare_fit, fd._binary_multi = real_prep, real_bin
        fitnull.calc_var_ratio_multi = real_vr
    emit("phewas_fit", lanes=P, share=fd._PLAN_SHARE,
         **{k: inst.get(k) for k in ("lane_groups", "var_ratio_groups",
                                     "ingest_s", "aireml_s", "var_ratio_s",
                                     "matvecs", "pcg_iterations",
                                     "outer_iterations")}, **res)
    op = kept["op"]
    args, kw = kept["fit"]
    n, K = op.n_samples, args[2].shape[-1]

    def forced(most):
        fd._lane_groups = lambda P_, *x, **y: fd._balanced(P_, most)

    # 2. the fitter in one group and in two
    if not a.edges_only:
        taus = {}
        for most in (P, -(-P // 2)):
            forced(most)
            m0 = op.matvecs
            try:
                fit, res = measured(torch, device,
                                    lambda: real_bin(*args, **kw))
            finally:
                fd._lane_groups = real_rule
            if fit is not None:
                taus[most] = fit.tau.cpu().numpy()
            emit("aireml_forced", most=most, products=op.matvecs - m0,
                 lane_groups=list(fit.lane_groups) if fit else None,
                 pcg_iterations=fit.pcg_iterations if fit else None, **res)
            del fit
        if len(taus) == 2:
            t1, t2 = taus.values()
            emit("aireml_forced_agree", max_rel=float(np.max(
                np.abs(t1 - t2) / np.maximum(np.abs(t1), 1e-300))))

    # 3. the largest group at the plan share
    fd._PLAN_SHARE = a.share
    torch.cuda.empty_cache()
    Y, X, tau, eta, U = args[1], args[2], args[3], args[4], args[5]
    nrun, pool = kw["nrun"], U.shape[1]
    free = torch.cuda.mem_get_info(device)[0]
    # the pool's products are allocated before the fitter's rule reads
    # the free memory
    L = fd._group_budget(free - 8 * n * pool, n) // fd._lane_bytes(
        n, K, 1 + max(K, nrun))
    idx = np.arange(L) % P
    fit, res = measured(torch, device, lambda: real_bin(
        op, Y[idx], X, tau[idx], eta[idx], U, *args[6:], **kw))
    emit("edge_binary", share=a.share, lanes=int(L),
         lane_groups=list(fit.lane_groups) if fit else None,
         converged=fit.converged.tolist() if fit else None,
         planned=int(L) * fd._lane_bytes(n, K, 1 + max(K, nrun)), **res)
    del fit

    vargs, vkw = kept["vr"]
    grm, codes_v, fit0s, glmms, noks, cfg = vargs[:6]
    cols = max(cfg.num_marker, 10, K)
    free = torch.cuda.mem_get_info(device)[0]
    Lv = fd._group_budget(free, n) // fd._lane_bytes(n, K, cols)

    def var_ratio_lanes(L_):
        ix = [i % len(glmms) for i in range(L_)]
        pick = lambda xs: [xs[i] for i in ix]
        return real_vr(grm, codes_v, pick(fit0s), pick(glmms), pick(noks),
                       *vargs[5:], **vkw)

    rows, res = measured(torch, device, lambda: var_ratio_lanes(Lv))
    emit("edge_var_ratio", share=a.share, lanes=int(Lv),
         var_ratio_groups=list(grm.var_ratio_groups),
         planned=int(Lv) * fd._lane_bytes(n, K, cols), **res)
    peaks = {}
    for L_ in (2, 4, 6):
        _, r = measured(torch, device, lambda: var_ratio_lanes(L_))
        peaks[L_] = r["allocated"]
    pad = lambda L_: kernel_cols(L_ * cols) - N_SLICES * L_ * cols
    emit("var_ratio_lane_bytes", cols=cols, peaks=peaks, slopes=[dict(
        lanes=[lo, hi], measured=(peaks[hi] - peaks[lo]) // (hi - lo),
        reckoned=fd._lane_bytes(n, K, cols)
        + n * (pad(hi) - pad(lo)) * 8 // (hi - lo))
        for lo, hi in ((2, 4), (4, 6))])

    colsq = 1 + K + nrun
    free = torch.cuda.mem_get_info(device)[0]
    Lq = fd._group_budget(free - 8 * n * pool, n) // fd._lane_bytes(
        n, K, colsq)
    yq = data["yq"] - data["yq"].mean()
    yq = torch.as_tensor(np.tile(yq / yq.std(), (Lq, 1)))
    fit, res = measured(torch, device, lambda: fd._quant_multi(
        op, yq, X, torch.tensor([[0.5, 0.5]] * Lq, dtype=torch.float64), U,
        0.02, 1e-5))
    emit("edge_quant", share=a.share, lanes=int(Lq),
         lane_groups=list(fit.lane_groups) if fit else None,
         converged=fit.converged.tolist() if fit else None,
         planned=int(Lq) * fd._lane_bytes(n, K, colsq), **res)
    del fit

    failed = any(r.get("oom") for r in RESULTS)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    tag = "expandable" if "expandable" in os.environ.get(
        "PYTORCH_CUDA_ALLOC_CONF", "") else "default"
    with open(os.path.join(ROOT, "chiprun_out",
                           f"phewas_groups_{tag}.json"), "w") as f:
        json.dump(RESULTS, f, indent=1)
    if failed and tag == "default":
        env = dict(os.environ,
                   PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
        return subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--lanes", str(P), "--share", str(a.share),
                               "--edges-only"], env=env).returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
