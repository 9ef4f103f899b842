#!/usr/bin/env python3
"""Smoke run of the PyTorch port (saigegds_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

1. the card (``nvidia-smi``), torch and CUDA versions;
2. build every kernel of the fit and scan paths from
   ``saigegds_tpu_torch/csrc`` (one ``nvcc`` per source, all at once) and
   print each kernel's registers and spills;
3. kernel B3 (``indicator_dot_2bit``) against its plain PyTorch version on
   the card, bit-equal, at a ragged shape and at the scan's main-path shape
   (B = 1024 variants, N = 430,000 samples, C = 128); kernels B1
   (``plane_dot_fwd``) and B2 (``plane_dot_t``) against theirs, bit-equal,
   at a ragged shape and at the fit's main-path shapes (M = 16,384 GRM
   variants, N = 430,000, C = 128 and 256); every time is the median of
   several runs timed with CUDA events;
4. the null-GLMM fit at full width: a synthetic GDS of 16,384 GRM variants
   x 430,000 samples (allele frequencies 0.05-0.5, 0.5% missing) and a
   polygenic binary phenotype (true tau_G ~ 0.6, 3 covariates), then
   ``fit_null_glmm(..., device="cuda")`` through the streamed ingest; it
   must converge with tau_G > 0 and finite variance ratios, and B1 and B2
   must each launch once per GRM product;
5. the fit held against the CPU: one GRM product over the first 2,048 GRM
   variants at full N (31 columns) on the card and on the CPU, within
   1e-12 relative; a small fit (2,000 samples x 1,000 variants) on both,
   within 1e-8 relative with the same iteration counts;
6. the scan from the fitted model at N = 430,000: a GDS of 4,096 variants
   (a MAF spectrum with rare variants, 0.5% missing, 16 variants enriched
   in the fit's cases), ``assoc_spa(..., device="cuda")`` with 1,024-variant
   blocks; B3 must launch once per block, every p-value must lie in
   [0, 1] and some variants must go through SPA; then the first block
   again on the CPU, whose table must agree with the card's within 1e-10
   relative.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Data is made from a fixed seed; the
GDS files live in ``_smoke/`` beside this script and are removed at the
end.
"""

import json
import math
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
N_SAMPLES = 430_000
N_VARIANTS = 4096
BLOCK = 1024
N_COV = 3
MISS_RATE = 0.005
N_ASSOC = 16            # variants of the first block tied to the phenotype
SEED = 20261016
RTOL = 1e-10            # card vs CPU table agreement
KERNEL_SHAPES = [(37, 1031), (BLOCK, N_SAMPLES)]
M_FIT = 16_384          # GRM variants of the fit (bench.py M_FITMIX)
FIT_SMALL = (2000, 1000)  # samples x variants of the card-vs-CPU fit
GRM_SHAPES = [(37, 1031, 128), (M_FIT, N_SAMPLES, 128),
              (M_FIT, N_SAMPLES, 256)]
MV_ROWS, MV_COLS = 2048, 31  # the card-vs-CPU GRM product
RTOL_MV = 1e-12         # card vs CPU GRM product (f64 atomics reorder)
RTOL_FIT = 1e-8         # card vs CPU small fit
FORMULA = "y ~ x1 + x2 + x3"
SOURCES = ["indicator_dot_2bit", "plane_dot"]


def log(msg: str):
    print(msg, flush=True)


def median_ms(fn, runs: int) -> float:
    """Median wall time of ``fn`` on the card, in ms, by CUDA events."""
    import torch
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def check_kernel(B: int, N: int, device, gen) -> dict:
    """B3 on the card vs its plain version on the same tensors."""
    import torch
    from saigegds_tpu_torch.ops import score_kernel

    n4 = -(-N // 4)
    packed = torch.randint(0, 256, (B, n4), dtype=torch.uint8, device=device,
                           generator=gen)
    vs4 = torch.randint(-64, 65, (4, n4, 128), dtype=torch.int8,
                        device=device, generator=gen)
    vs4.view(4 * n4, 128)[N:] = 0        # padded samples meet zero rows
    got = score_kernel.indicator_dot_2bit(packed, vs4)
    want = score_kernel.indicator_dot_2bit_plain(packed, vs4)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"B3 disagrees with its plain version at "
                             f"B={B}, N={N}: max abs err {err}")
    kernel = lambda: score_kernel.indicator_dot_2bit(packed, vs4)
    plain = lambda: score_kernel.indicator_dot_2bit_plain(packed, vs4)
    # warmed up by the check above; alternate plain, kernel, kernel, plain
    p1 = median_ms(plain, 3)
    k1 = median_ms(kernel, 10)
    k2 = median_ms(kernel, 10)
    p2 = median_ms(plain, 3)
    ms, plain_ms = float(np.median([k1, k2])), float(np.median([p1, p2]))
    log(f"B3 B={B} N={N} C=128: bit-equal to the plain version; kernel "
        f"{ms:.3f} ms (runs {k1:.3f}, {k2:.3f}), plain {plain_ms:.3f} ms "
        f"(runs {p1:.3f}, {p2:.3f})")
    return dict(B=B, N=N, max_abs_err=err, ms=ms, plain_ms=plain_ms)


def check_grm(M: int, N: int, C: int, device, gen) -> dict:
    """B1 and B2 on the card vs their plain versions on the same tensors:
    a random store of codes 0..2 (code-3 bit pairs cleared, as in the
    fit's store), slices in [-64, 64] with zero rows at padded samples."""
    import torch
    from saigegds_tpu_torch.ops import grm_kernel

    n4 = -(-N // 4)
    x = torch.randint(0, 256, (M, n4), dtype=torch.uint8, device=device,
                      generator=gen)
    m3 = x & (x >> 1) & 0x55
    packed = x & ~(m3 | (m3 << 1))
    d4 = torch.randint(-64, 65, (4, n4, C), dtype=torch.int8, device=device,
                       generator=gen)
    d4.view(4 * n4, C)[N:] = 0
    dm = torch.randint(-64, 65, (M, C), dtype=torch.int8, device=device,
                       generator=gen)
    out = {}
    for name, rhs in (("plane_dot_fwd", d4), ("plane_dot_t", dm)):
        kern = getattr(grm_kernel, name)
        plain = getattr(grm_kernel, name + "_plain")
        got = kern(packed, rhs)
        want = plain(packed, rhs)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"at M={M}, N={N}, C={C}: max abs err {err}")
        del got, want
        # warmed up by the check above; alternate plain, kernel, kernel, plain
        p1 = median_ms(lambda: plain(packed, rhs), 3)
        k1 = median_ms(lambda: kern(packed, rhs), 5)
        k2 = median_ms(lambda: kern(packed, rhs), 5)
        p2 = median_ms(lambda: plain(packed, rhs), 3)
        ms, plain_ms = float(np.median([k1, k2])), float(np.median([p1, p2]))
        log(f"{name} M={M} N={N} C={C}: bit-equal to the plain version; "
            f"kernel {ms:.3f} ms (runs {k1:.3f}, {k2:.3f}), plain "
            f"{plain_ms:.3f} ms (runs {p1:.3f}, {p2:.3f})")
        out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    return out


def make_data(y: np.ndarray, n_variants: int, device, seed: int):
    """int8 codes [M, N] of the scan, for the phenotype ``y`` [N].

    Genotypes are drawn on ``device`` in chunks (two alleles per sample
    against the variant's ALT frequency): 25% rare (MAF 0.0005-0.01,
    log-uniform), 15% low-frequency (0.01-0.05), the rest common
    (0.05-0.5), a tenth of them ALT-major; the first N_ASSOC variants
    carry the ALT allele more often in cases."""
    import torch
    rng = np.random.default_rng(seed)
    n_samples = len(y)
    u = rng.random(n_variants)
    maf = np.where(u < 0.25, np.exp(rng.uniform(np.log(5e-4), np.log(0.01),
                                                n_variants)),
                   np.where(u < 0.4, rng.uniform(0.01, 0.05, n_variants),
                            rng.uniform(0.05, 0.5, n_variants)))
    af = np.where(rng.random(n_variants) < 0.1, 1 - maf, maf)

    gen = torch.Generator(device=device).manual_seed(seed)
    y_dev = torch.as_tensor(y, dtype=torch.float32, device=device)
    codes = np.empty((n_variants, n_samples), np.int8)
    step = 256
    for s in range(0, n_variants, step):
        e = min(s + step, n_variants)
        p = torch.as_tensor(af[s:e], dtype=torch.float32,
                            device=device)[:, None].expand(e - s, n_samples)
        if s < N_ASSOC:
            # case enrichment from 2% to 24%: p-values from ~0.05 down
            # past 1e-100
            k = min(N_ASSOC, e) - s
            boost = torch.zeros(e - s, 1, device=device)
            boost[:k, 0] = 0.02 * 1.18 ** torch.arange(k, device=device)
            p = torch.clamp(p * (1 + boost * y_dev[None, :]), max=0.95)
        shape = (e - s, n_samples)
        g = (torch.rand(shape, generator=gen, device=device) < p).to(
            torch.int8)
        g += (torch.rand(shape, generator=gen, device=device) < p).to(
            torch.int8)
        g[torch.rand(shape, generator=gen, device=device) < MISS_RATE] = 3
        codes[s:e] = g.cpu().numpy()
    return codes


def make_fit_data(n_samples: int, n_variants: int, device, seed: int):
    """(int8 codes [M, N], data dict) of a polygenic binary trait, as
    bench.py's fit data: allele frequencies uniform in 0.05-0.5, effects
    giving a genetic variance of 0.6 on the logit scale, three covariates
    plus the intercept; genotypes drawn on ``device`` in chunks, then 0.5%
    set missing."""
    import torch
    rng = np.random.default_rng(seed)
    af = rng.uniform(0.05, 0.5, n_variants)
    X = np.column_stack([np.ones(n_samples),
                         rng.normal(size=(n_samples, N_COV))])
    beta = rng.normal(size=n_variants) * np.sqrt(0.6 / n_variants) \
        / np.sqrt(2 * af * (1 - af))
    alpha = rng.normal(size=N_COV + 1) * 0.3
    gen = torch.Generator(device=device).manual_seed(seed)
    g_eff = torch.zeros(n_samples, dtype=torch.float64, device=device)
    codes = np.empty((n_variants, n_samples), np.int8)
    step = 1024
    for s in range(0, n_variants, step):
        e = min(s + step, n_variants)
        shape = (e - s, n_samples)
        p = torch.as_tensor(af[s:e], dtype=torch.float32,
                            device=device)[:, None].expand(shape)
        g = (torch.rand(shape, generator=gen, device=device) < p).to(
            torch.int8)
        g += (torch.rand(shape, generator=gen, device=device) < p).to(
            torch.int8)
        g_eff += g.T.to(torch.float64) @ torch.as_tensor(
            beta[s:e], device=device)
        g[torch.rand(shape, generator=gen, device=device) < MISS_RATE] = 3
        codes[s:e] = g.cpu().numpy()
    eta = X @ alpha - 1.5 + g_eff.cpu().numpy()
    y = (rng.random(n_samples) < 1 / (1 + np.exp(-eta))).astype(np.float64)
    data = {"sample.id": np.arange(1, n_samples + 1, dtype=np.int32),
            "y": y}
    data.update({f"x{i}": X[:, i] for i in range(1, N_COV + 1)})
    return codes, data


def fit(gds: str, data: dict, device: str):
    """(model, instrument dict) of one fit_null_glmm run; the dict also
    holds its wall seconds."""
    import torch
    from saigegds_tpu_torch import NullModelConfig, fit_null_glmm

    inst = {}
    t0 = time.perf_counter()
    model = fit_null_glmm(FORMULA, data, gds, NullModelConfig(),
                          instrument=inst, device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    inst["wall_s"] = time.perf_counter() - t0
    return model, inst


def check_fit(model):
    ratio = np.asarray(model.var_ratio["ratio"], float)
    if not model.converged:
        raise AssertionError("the fit did not converge")
    if not model.tau[1] > 0:
        raise AssertionError(f"tau_G = {model.tau[1]} is not positive")
    if not (len(ratio) and np.isfinite(ratio).all()
            and np.isfinite(model.coefficients).all()):
        raise AssertionError("variance ratios or coefficients not finite")


def check_matvec(codes: np.ndarray, device) -> float:
    """One GRM product over ``codes``' variants at full N on the card and
    on the CPU; max over columns of max|card - CPU| / max|CPU|."""
    import torch
    from saigegds_tpu_torch.ops.packed_grm import build_packed2_grm

    b = torch.from_numpy(np.random.default_rng(SEED).normal(
        size=(codes.shape[1], MV_COLS)))
    t0 = time.perf_counter()
    got = build_packed2_grm(codes, device=device).matvec(b.to(device)).cpu()
    t1 = time.perf_counter()
    want = build_packed2_grm(codes, device="cpu").matvec(b)
    t2 = time.perf_counter()
    worst = float(((got - want).abs().amax(0) / want.abs().amax(0)).max())
    if not worst <= RTOL_MV:
        raise AssertionError(f"GRM product card vs CPU: relative error "
                             f"{worst:.3e} > {RTOL_MV}")
    log(f"GRM product, {codes.shape[0]} variants x {codes.shape[1]} samples "
        f"x {MV_COLS} columns: card vs CPU max relative error {worst:.3e} "
        f"(limit {RTOL_MV}); build + product {t1 - t0:.1f} s on the card, "
        f"{t2 - t1:.1f} s on the CPU")
    return worst


def compare_fits(gpu, cpu, inst_gpu: dict, inst_cpu: dict) -> float:
    """The card's small fit against the CPU's: tau, coefficients and
    variance ratios within RTOL_FIT, the same markers and iterations."""
    for k in ("outer_iterations", "pcg_iterations", "matvecs"):
        if inst_gpu[k] != inst_cpu[k]:
            raise AssertionError(f"{k}: {inst_gpu[k]} on the card, "
                                 f"{inst_cpu[k]} on the CPU")
    if not np.array_equal(gpu.var_ratio["id"], cpu.var_ratio["id"]):
        raise AssertionError("variance-ratio markers differ")
    worst = 0.0
    for name in ("tau", "coefficients"):
        a, b = getattr(gpu, name), getattr(cpu, name)
        worst = max(worst, float(np.max(np.abs(a - b) / np.abs(b))))
    a, b = gpu.var_ratio["ratio"], cpu.var_ratio["ratio"]
    worst = max(worst, float(np.max(np.abs(a - b) / np.abs(b))))
    if not worst <= RTOL_FIT:
        raise AssertionError(f"small fit card vs CPU: relative error "
                             f"{worst:.3e} > {RTOL_FIT}")
    return worst


def scan(gds: str, model, device: str, variant_mask=None):
    """(table, instrument dict, wall seconds) of one assoc_spa run."""
    import torch
    from saigegds_tpu_torch import ScanConfig, assoc_spa

    inst = {}
    t0 = time.perf_counter()
    tab = assoc_spa(gds, model, ScanConfig(block_size=BLOCK),
                    variant_mask=variant_mask, instrument=inst,
                    device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    return tab, inst, time.perf_counter() - t0


def check_table(tab: dict):
    p = tab["pval"]
    if not (len(p) and np.all(np.isfinite(p)) and np.all((p >= 0) & (p <= 1))):
        raise AssertionError("p-values outside [0, 1] or not finite")
    for c in ("AF.alt", "beta", "SE", "p.norm"):
        if np.isnan(tab[c]).any():
            raise AssertionError(f"NaN in column {c}")


def compare_tables(gpu: dict, cpu: dict) -> float:
    """Rows of ``cpu`` (a variant subset) against the same rows of
    ``gpu``: columns and counts exact, statistics within RTOL."""
    if list(gpu) != list(cpu):
        raise AssertionError("column order differs")
    sel = np.isin(gpu["id"], cpu["id"])
    if sel.sum() != len(cpu["id"]):
        raise AssertionError("the card's table lacks rows of the CPU's")
    for c in ("id", "chr", "pos", "rs.id", "ref", "alt", "AF.alt", "mac",
              "num", "converged"):
        if not np.array_equal(np.asarray(gpu[c])[sel], np.asarray(cpu[c])):
            raise AssertionError(f"column {c} differs between card and CPU")
    worst = 0.0
    for c in ("pval", "p.norm", "beta", "SE"):
        a, b = gpu[c][sel], cpu[c]
        rel = np.abs(a - b) / np.maximum(np.abs(b), np.finfo(float).tiny)
        worst = max(worst, float(rel.max(initial=0.0)))
    if worst > RTOL:
        raise AssertionError(f"card vs CPU max relative error {worst:.3e} "
                             f"> {RTOL}")
    return worst


def main() -> int:
    import torch
    from saigegds_tpu_torch.ops import _cuda, grm_kernel, score_kernel
    from saigegds_tpu_torch.io.gds_write import write_seqarray_gds

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    card = smi.splitlines()[0]
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}, {torch.cuda.get_device_name(0)}")
    device = torch.device("cuda", 0)

    # 2. build, one nvcc per source, all at once
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        list(pool.map(_cuda.load, SOURCES))
    log(f"build: {', '.join(SOURCES)} in {time.perf_counter() - t0:.1f} s")
    for name in SOURCES:
        for line in _cuda.BUILD_LOG.get(name, "").splitlines():
            if "entry function" in line or "registers" in line \
                    or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    # 3. kernels vs plain versions
    gen = torch.Generator(device=device).manual_seed(SEED)
    checks = [check_kernel(B, N, device, gen) for B, N in KERNEL_SHAPES]
    grm_checks = [check_grm(M, N, C, device, gen) for M, N, C in GRM_SHAPES]

    work = os.path.join(ROOT, "_smoke")
    os.makedirs(work, exist_ok=True)
    try:
        # 4. the fit at full width
        t0 = time.perf_counter()
        codes, data = make_fit_data(N_SAMPLES, M_FIT, device, SEED)
        gds_fit = os.path.join(work, "fit.gds")
        write_seqarray_gds(gds_fit, codes, compress="ZIP_ra")
        log(f"fit setup: {M_FIT} GRM variants x {N_SAMPLES} samples, "
            f"{data['y'].mean():.4f} cases, GDS "
            f"{os.path.getsize(gds_fit) / 1e6:.0f} MB, "
            f"{time.perf_counter() - t0:.1f} s")

        torch.cuda.reset_peak_memory_stats()
        for k in grm_kernel.LAUNCHES:
            grm_kernel.LAUNCHES[k] = 0
        score_kernel.LAUNCHES = 0
        model, inst = fit(gds_fit, data, "cuda")
        fit_launches = dict(grm_kernel.LAUNCHES)
        if set(fit_launches.values()) != {inst["matvecs"]} or \
                score_kernel.LAUNCHES:
            raise AssertionError(f"launches {fit_launches} (B3 "
                                 f"{score_kernel.LAUNCHES}) for "
                                 f"{inst['matvecs']} GRM products")
        check_fit(model)
        log(f"fit on the card: tau {model.tau.tolist()}, "
            f"{inst['outer_iterations']} outer iterations, "
            f"{inst['pcg_iterations']} PCG iterations, {inst['matvecs']} GRM "
            f"products, B1 launches {fit_launches['plane_dot_fwd']}, B2 "
            f"launches {fit_launches['plane_dot_t']}; {inst['wall_s']:.1f} s "
            f"wall = ingest {inst['ingest_s']:.1f} + AI-REML "
            f"{inst['aireml_s']:.1f} + variance ratio "
            f"{inst['var_ratio_s']:.1f} s ({len(model.var_ratio['ratio'])} "
            f"markers, mean ratio {model.mean_var_ratio:.4f}); peak device "
            f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

        # 5. the fit held against the CPU
        worst_mv = check_matvec(codes[:MV_ROWS], device)
        del codes
        n_s, m_s = FIT_SMALL
        codes_s, data_s = make_fit_data(n_s, m_s, device, SEED + 1)
        gds_s = os.path.join(work, "fit_small.gds")
        write_seqarray_gds(gds_s, codes_s)
        m_gpu, inst_gpu = fit(gds_s, data_s, "cuda")
        m_cpu, inst_cpu = fit(gds_s, data_s, "cpu")
        check_fit(m_cpu)
        worst_fit = compare_fits(m_gpu, m_cpu, inst_gpu, inst_cpu)
        log(f"small fit ({n_s} x {m_s}): card vs CPU max relative error "
            f"{worst_fit:.3e} (limit {RTOL_FIT}), tau_G "
            f"{m_cpu.tau[1]:.6f}, {inst_cpu['outer_iterations']} outer and "
            f"{inst_cpu['pcg_iterations']} PCG iterations on both; "
            f"{inst_gpu['wall_s']:.1f} s on the card, "
            f"{inst_cpu['wall_s']:.1f} s on the CPU")

        # 6. the scan from the fitted model
        t0 = time.perf_counter()
        codes = make_data(data["y"], N_VARIANTS, device, SEED)
        gds = os.path.join(work, "scan.gds")
        write_seqarray_gds(gds, codes, compress="ZIP_ra")
        del codes
        log(f"scan setup: {N_VARIANTS} variants x {N_SAMPLES} samples, GDS "
            f"{os.path.getsize(gds) / 1e6:.0f} MB, "
            f"{time.perf_counter() - t0:.1f} s")

        torch.cuda.reset_peak_memory_stats()
        for k in grm_kernel.LAUNCHES:
            grm_kernel.LAUNCHES[k] = 0
        score_kernel.LAUNCHES = 0
        tab, inst, wall = scan(gds, model, "cuda")
        launches = score_kernel.LAUNCHES
        n_blocks = -(-N_VARIANTS // BLOCK)
        if launches != n_blocks or any(grm_kernel.LAUNCHES.values()):
            raise AssertionError(f"B3 launched {launches} times for "
                                 f"{n_blocks} blocks")
        check_table(tab)
        refined = int(np.sum(tab["pval"] != tab["p.norm"]))
        if inst["spa_n"] == 0 or refined == 0:
            raise AssertionError("no variant went through SPA")
        stages = {k: round(float(np.sum(inst[k])), 3)
                  for k in ("decode_s", "pack_s", "upload_s", "dispatch_s",
                            "drain_s")}
        log(f"scan on the card: {len(tab['pval'])} of {N_VARIANTS} variants "
            f"tested, {inst['spa_n']} through SPA ({refined} changed), "
            f"min p {tab['pval'].min():.3e}, {wall:.2f} s wall, "
            f"{N_VARIANTS / wall:.1f} variants/s, B3 launches {launches}, "
            f"peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        log(f"  stage sums (s, stages overlap): "
            f"{json.dumps(stages)}, spa_s {inst['spa_s']:.3f}")

        # the first block on the CPU
        mask = np.zeros(N_VARIANTS, bool)
        mask[:BLOCK] = True
        tab_cpu, _, wall_cpu = scan(gds, model, "cpu", variant_mask=mask)
        worst = compare_tables(tab, tab_cpu)
        log(f"first block on the CPU: {len(tab_cpu['pval'])} rows agree with "
            f"the card's, max relative error {worst:.3e} (limit {RTOL}), "
            f"{wall_cpu:.1f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    main_shape = grm_checks[1]           # M_FIT x N_SAMPLES, C = 128
    kernels = [{
        "name": name,
        "route": "cuda",
        "source": "saigegds_tpu_torch/csrc/plane_dot.cu",
        "replaces": f"saigegds_tpu/ops/pallas_grm.py:{line}",
        "launches": fit_launches[name],
        "max_abs_err": max(c[name]["max_abs_err"] for c in grm_checks),
        "ms": main_shape[name]["ms"],
        "plain_ms": main_shape[name]["plain_ms"],
    } for name, line in (("plane_dot_fwd", 86), ("plane_dot_t", 166))]
    kernels.append({
        "name": "indicator_dot_2bit",
        "route": "cuda",
        "source": "saigegds_tpu_torch/csrc/indicator_dot_2bit.cu",
        "replaces": "saigegds_tpu/ops/pallas_score.py:102",
        "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in checks),
        "ms": checks[-1]["ms"],
        "plain_ms": checks[-1]["plain_ms"],
    })
    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
