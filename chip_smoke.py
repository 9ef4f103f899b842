#!/usr/bin/env python3
"""Smoke run of the PyTorch port (saigegds_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

(Phase 20 runs this script again as ranks of a process group, with
``--rank``, ``--world``, ``--init``, ``--role`` and ``--work``.)

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

1. the card (``nvidia-smi``), torch and CUDA versions;
2. build every kernel of the fit, scan and aggregate paths from
   ``saigegds_tpu_torch/csrc`` (one ``nvcc`` per source, all at once) and
   print each kernel's registers and spills; it fails when an entry
   spills, or when ``libplane_dot.so`` (B1, B2),
   ``libindicator_dot_2bit.so`` (B3) or ``libindicator_dot.so`` (B4)
   holds no warpgroup MMA (``GMMA`` in ``cuobjdump -sass``), no TMA or
   bulk copy (``UTMALDG`` or ``UBLKCP``), or any ``mma.sync`` (``IMMA``);
3. every kernel against its plain PyTorch version on the card, bit-equal,
   at a ragged shape and at its main-path shapes: B3
   (``indicator_dot_2bit``) at 37 variants x 1,031 samples and at the
   scan's block (B = 1024 variants, N = 430,000 samples) at C = 96 (the
   main paths' models: 88 live columns) and C = 384 (four tiles), over
   the slices' layout made once beforehand as the scan makes it once per
   model (its time printed apart); B1 (``plane_dot_fwd``) and B2
   (``plane_dot_t``) at three ragged shapes (37, 129 and 129 variants x
   1,031 and 1,069 samples, C = 128, 256 and 16) and over one store of the
   fit's shape (M = 16,384 GRM variants, N = 430,000) at every column
   tile, C = 16, 32, 64, 128 and 256, and looped as the PheWAS fit runs
   them, at C = 384 (three tiles of 128), 768 (three tiles of 256) and
   2,048 (eight tiles of 256, the widest C of the PheWAS fit at its
   smallest split); from phase 4 on the run fails if a fit ran B1 and B2
   at a C whose tile and looping (``grm_kernel.column_tile``) phase 3 did
   not hold; each over a store of the GRM store's
   width, B1 from the slices' sample rows as the fit hands them over
   (``plane_dot_fwd_rows``, so each time includes the wrapper's re-layout
   of its operand; the general wrapper ``plane_dot_fwd`` held equal to
   it), each beside ``torch._int_mm`` on
   the store decoded beforehand (B1: against the slices; B2: the decoded
   store's transpose against its operand), a contraction-only yardstick;
   the GRM product's slice kernels (``grm_kernel.slice_i8``: the column
   max, then the slices) at N = 430,000 and R = 31, 103 (the fit's
   average) and 248 (its widest), row-major, and on a transposed [N, 8]
   view, slices and scales bit-equal, beside their 24 N R bytes;
   B4 (``indicator_dot``, int8 codes) at 37 x 1,031 and at the aggregate
   tests' single-variant batch (B = 256, N = 430,000) at C = 96 and 384,
   B3 and B4 each beside ``torch._int_mm`` (cuBLAS int8 GEMM) on the
   indicators decoded beforehand at the same C, a contraction-only
   yardstick the port never calls; from phase 4 on every B3 and B4 launch
   is counted by phase and C, and the run fails if the main paths launched
   either at a C that phase 3 did not hold at full width;
   B5
   (``decode_codes``: a stream scan that writes a table of where each
   16 KiB output tile's entries start, then one block per tile that
   replays them and stores the tile whole) on a ragged stream full of
   escapes and empty rows and on rare-variant streams of 256 and 2,048
   rows x N = 430,000 (1% of them ALT-major, an entry per sample; the
   count of dense rows is printed), beside ``torch.zeros`` of its output
   (the zero-fill yardstick), and each of its two stages against its own
   plain version, with its own time; the sample gather of the 2-bit scan
   (``gather_2bit``, which replaces no TPU kernel: it takes the host's
   ``np.take`` off the scan) at the scan cells' block, 1,024 variants x
   488,000 GDS samples to 430,000 sorted columns, and at 37 x 1,031 to
   1,021 shuffled columns, byte-equal, beside the bytes it must move.
   Every kernel's time (and its
   yardstick's) is the median of several runs of CUDA events around
   enough calls back to back to span about 2 ms (one call between two
   events, which also times the host's work per call, is printed
   beside), printed beside the plain version's and the bound (the larger
   of the bytes the function must move at 3.35 TB/s and its int8
   operations at 1,979 TOP/s), with the achieved int8 operations per
   second and the share of the bound;
4. the null-GLMM fit at full width: a synthetic GDS of 16,384 GRM variants
   x 430,000 samples (allele frequencies 0.05-0.5, 0.5% missing) and a
   polygenic binary phenotype (true tau_G ~ 0.6, 3 covariates), then
   ``fit_null_glmm(..., device="cuda")`` through the streamed ingest, with
   ``checkpoint=`` set to a path in ``_smoke/``; it must converge with
   tau_G > 0 and finite variance ratios, B1 and B2 must each launch once
   per GRM product, and the checkpoint files must be gone once the model
   is assembled; the fit's products by column count C and the device
   seconds of its B1 and B2 calls (CUDA events around each wrapper call)
   are printed; then one GRM product at R = 30
   columns over a random store of the fit's size and missing rate, timed
   by CUDA events and profiled by kernel (``torch.profiler``), and its
   missing-pair corrections alone in five forms (``index_add_`` with and
   without ``torch.use_deterministic_algorithms``, ``segment_reduce``, a
   CSR product and the port's ``embedding_bag`` sums), each timed and run
   twice: the port's must agree with itself bit for bit; then one scan
   block's phase 1 from the fitted model traced by ``torch.profiler``
   over the model packed once, as the scan packs it (device ms by kernel;
   it fails if the block made a layout of the slices or did not launch
   B3 once);
5. the fit held against the CPU: one GRM product over the first 1,024 GRM
   variants at full N (31 columns) on the card and on the CPU, within
   1e-12 relative; a small fit (2,000 samples x 1,000 variants) on both,
   within 1e-8 relative with the same iteration counts;
6. the quantitative fit at full width, on phase 4's GDS: a phenotype from
   the same genetic values and covariates, heritability 0.4, with a
   log-normal noise (``make_fit_data``'s ``yq``), fitted with
   ``trait_type="quantitative"`` and the default inverse-normal transform;
   it must converge with tau_E > 0, tau_G > 0 and finite variance ratios,
   B1 and B2 launching once per GRM product; then the small fit's
   quantitative trait on the card and on the CPU (1e-8, same iterations);
7. the scan from the fitted model at N = 430,000: a GDS of 4,096 variants
   (a MAF spectrum with rare variants, 0.5% missing, 16 variants enriched
   in the fit's cases) over the model's samples and 16 more that the model
   lacks, at shuffled positions, so that every block is gathered to the
   model's samples (on the card: ``gather_2bit`` after the upload);
   ``assoc_spa(..., device="cuda")`` with 1,024-variant blocks; B3 and
   the gather must each launch once per block, every p-value must
   lie in [0, 1] and some variants must go through SPA; then the first
   block's first 256 variants (``CPU_ROWS``) on the CPU, whose table
   must agree with the card's within 1e-10 relative, and the first block
   on the card through the int8 route
   (``packed_2bit=False``, one B4 launch), held to the CPU's table too;
8. the same scan from the quantitative model: B3 once per block, no
   variant through SPA, no ``p.norm`` or ``converged`` column, the first
   block on the CPU (1e-10) and through the int8 route (one B4 launch);
9. the aggregate tests from the fitted model at N = 430,000: a GDS of
   16,384 variants with an exome's MAF spectrum (50% ultra-rare with 1-9
   minor alleles, 40% rare, 10% low-frequency, 0.5% missing), 512 gene
   units of 8-64 contiguous variants (8 of them enriched in the fit's
   cases), read frame by frame as a file above the whole-matrix cache is;
   ``assoc_acat_o(..., device="cuda")`` over the first 64 units (2 of
   them enriched) with the default
   ``AggregateConfig``: every p-value in [0, 1], some rows through SPA, and
   B5 launched once per sparse payload, B4 once per sparse single-variant
   payload; ``assoc_burden`` and ``assoc_acat_v`` on the card over the
   first 16 units equal ACAT-O's burden and ACAT-V columns within 1e-12;
   the first 8 units on the CPU agree with the card within 1e-10 relative
   on every p-value column, with the same NaN pattern;
10. ``assoc_burden`` of the quantitative model over phase 9's GDS and
   units: B5 once per sparse payload and no other kernel, no row through
   SPA, every p-value in [0, 1], the first 8 units on the CPU within
   1e-10 relative with the same NaN pattern; ``assoc_acat_o`` on the
   quantitative model raises NotImplementedError;
11. the scan of imputed dosages at N = 430,000: a DS GDS (``annotation/
   format/DS``, ZIP_RA) of 1,024 variants over the model's samples and 16
   more at shuffled positions, as in phase 7; hard calls with phase 7's
   MAF spectrum (8 variants tied to the phenotype, 0.5% missing, NaN) turn
   into dosages: a tenth of the entries get a Gaussian imputation noise,
   all are clipped to [0, 2] and rounded to 0.001, and the variants
   DS_TYPED keep their hard calls (typed variants: integer-valued, so
   their blocks ship f32).  ``assoc_spa`` from phase 4's model in blocks
   of 256, so the three-stage pipeline runs: no kernel launches (the dense
   f64 route), every p-value in [0, 1], some rows through SPA, the first
   block's first 128 variants on the CPU within 1e-10 relative with the
   same NaN pattern and SPA set; the stage sums, variants/s, bytes
   shipped and peak device memory are printed, and the dense phase 1 of
   one block is timed by CUDA events beside its bound (the larger of its
   f64 bytes at 3.35 TB/s and its f64 operations at 34 TFLOP/s).  Then
   the quantitative model's scan
   of the same file, with the same checks (nothing to SPA);
12. the dense route against the packed route: ``dsnode="$dosage_alt"``
   over phase 7's first 1,024 variants from phase 4's model; its table
   equals phase 7's packed table there within 1e-10 relative, the same
   variants and SPA set;
   then ``assoc_spa_user`` over phase 11's first 256 dosages in model
   order, served from a numpy callback, equal within 1e-12 to phase 11's
   scan of the same 256 variants on the card (a scan of the whole file
   batches its SPA rows across blocks, which moves the last bits);
13. the gene tests over the DS file: 16 units of 32 contiguous variants;
   ``assoc_acat_o`` from the binary model and ``assoc_burden`` from the
   quantitative one on the card: every p-value in [0, 1], the first 2
   units on the CPU within 1e-10 with the same NaN pattern; the rows sent
   the packed way (B5/B4 or B3, launched once per payload) and the dense
   way are printed, with the launches;
14. R files: phase 4's model saved as ``.rds`` and ``.rda`` and loaded
   back; the scan of phase 7's first block from each reloaded model
   equals the in-memory model's bit for bit, B3 launched once; one scan
   table saved as ``.rds`` reads back equal with the port's ``read_rds``;
15. fit options at the small fit's size (2,000 x 1,000, half of the
   markers rare, MAF 0.002-0.01): ``var_ratio_mac_cat=(10.5, 20.5)`` on
   the card and on the CPU within 1e-8, the same markers in each
   category; then the small binary fit of phase 5 with ``checkpoint=``,
   killed in outer iteration 2 (a wrapped ``_fit_tau_binary`` raises) and
   resumed on the card: equal to the uninterrupted card fit bit for bit
   (tau, coefficients, fitted values, variance ratios, markers, outer
   iterations), the checkpoint files gone;
16. the PheWAS fit at full width: ``fit_null_glmm_multi`` over phase 4's
   GDS at the least P that the group rule (``fit_device._lane_groups``)
   splits into two groups or more on this card, reckoned from the free
   memory before the fit: phase 4's ``y``, three more phenotypes from the
   same genetic values at case fractions of about 10%, 20% and 50%, and
   the rest at case fractions spread over 5-50% (``yp0``, ...), one
   ingest (counted); it fails unless the AI-REML fit ran in two groups or
   more; every lane converges with tau_G > 0 and finite variance ratios,
   B1 and B2 launch once per GRM product; P, the groups of the AI-REML
   fit and of the variance ratios, the wall split, the products by the
   kernels' column count C, the PCG iterations and the peak device
   memory against the card's are printed beside phase 4's one fit; then
   the bytes a lane adds, measured over the fit's operator (the peak
   allocated at 2, 4 and 6 lanes of each fitter stopped after its first
   stage, and of the fit's variance-ratio pass) against the rule's
   reckoning, which it must not exceed; the largest group the rule
   allows then, in one group, for the binary and the quantitative fitter
   through their first outer iteration and for the variance-ratio pass
   whole, each with its peak allocated and reserved printed beside the
   free memory; at the
   small fit's size the PheWAS fit of ``y`` and the three ``yb``
   phenotypes with the groups forced to 1 and 2 lanes equals one group
   within 1e-10 (same iterations and markers), the public one-lane
   fitters ``fit_glmm_binary_device`` and ``fit_glmm_quant_device`` agree
   on the card and the CPU within 1e-8 with the same iterations, and the
   quantitative PheWAS fit (``yq``, ``yq2``) likewise;
17. the PheWAS scan: ``assoc_spa_multi`` over phase 7's GDS with phase
   16's first four lanes (``y`` and the ``yb`` phenotypes) and phase 6's
   quantitative model (P = 5), in blocks of 1,024: B3
   launches P times per block, each block is decoded once (``decode_s``
   beside phase 7's), the quantitative lane's table equals phase 8's
   within 1e-10, lane 0's first 256 variants on the CPU within 1e-10;
   variants x models per second beside phase 7's variants per second;
   then the first block again with ``transport_policy="static"``: its
   rare rows ship as the gap-coded stream, so B5 and B4 launch P times
   per sparse payload (and B3 P times per 2-bit payload, from the host's
   own split of the block), lane 0 within 1e-10 of the CPU and every lane
   within 1e-10 of the 2-bit pass;
18. GxG: ``gxg_spa`` with phase 4's GDS as the GRM (its first 4,096
   variants, by ``variant_id=``) and phase 7's GDS as the tested SNPs,
   8 pairs of common variants, ``use_approx_tau=True`` from tau_G = 0.1
   (it must end positive), ``pair_batch=8``: every p-value in [0, 1], B1
   and B2 once per product, seconds per pair printed; one pair from the
   default start (1, 0.5), whose approximate tau_G is printed (0 in both
   packages at this panel shape, tests/test_torch_gxg_start.py), its
   p-value in [0, 1] and B1 and B2 once per product; then at the small fit's
   size the batched approximate-tau path equals the serial one (with the
   GLM screen at 1.0) within 1e-10 on the card, and full per-pair
   refits, serial and ``pair_batch=4``, on the card and on the CPU:
   within 1e-8, the same PCG iterations and products;
19. the mesh: ``make_mesh(devices=["cuda:0"] * 2)``, two shards on the
   one card (this proves the sharded paths and measures what sharding
   costs, not a speed-up): ``fit_null_glmm(..., mesh=)`` over phase 5's
   small GDS and data (the streamed ingest builds each shard's store as
   the blocks arrive) equals the one-store fit of the same streamed build
   bit for bit, B1 and B2 launched twice per product; its operator gives
   products at R = 1 and R = 30 equal to the one-store operator's, and
   phase 4's operator wrapped into two shards equal to phase 4's
   operator's, bit for bit (ms sharded against unsharded printed at full
   width); ``assoc_spa(...,
   mesh=)`` over phase 7's GDS equals phase 7's table bit for bit, B3
   twice per block; ``assoc_spa_sharded`` as process 0 and 1 of 2, then
   ``merge_shards``, equals phase 7's table bit for bit;
20. the fit across two processes on the one card: this script again as
   rank 0 and rank 1 of a gloo group (``--rank``; NCCL refuses two ranks
   on one device, so the messages are staged through host memory), each
   its own CUDA context with ``make_mesh(devices=["cuda:0"])`` and one
   half of the store: phase 4's fit (streamed ingest, ``checkpoint=``)
   equals phase 4's bit for bit on both ranks (tau, coefficients, fitted
   values, variance ratios, products and PCG iterations), B1 and B2
   launched once per product on each rank, the checkpoint files gone;
   then products at R = 1 and 30 equal phase 4's operator's bit for bit
   (ms by CUDA events on the lead, wire bytes and seconds per product);
   each rank's store bytes, peak device memory and host RSS are printed
   (the parent first hands its freed heap back to the system); then phase
   5's small fit with a failure of the lead in outer iteration 2 ends both
   ranks non-zero by the lead's abort, inside a time limit;
21. the command line: ``python -m saigegds_tpu_torch`` with ``--device
   cuda`` in a process of its own for ``fit --pheno-cols``, ``scan`` with
   two ``--model`` (the API's models), ``gxg``, ``merge`` and ``info`` on
   the small fit's data, the commands that need no other's output at
   once; each output against the API's on the card (fits and GxG 1e-8,
   tables 1e-10, the merge equal, info names the card).

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Data is made from a fixed seed; the
GDS files live in ``_smoke/`` beside this script and are removed at the
end.
"""

import contextlib
import ctypes
import gc
import json
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
N_EXTRA = 16            # scan GDS samples outside the model
SEED = 20261016
RTOL = 1e-10            # card vs CPU table agreement
CPU_ROWS = 256          # variants of phase 7's and 17's first block held
#                         against the CPU (the first N_ASSOC among them)
SCAN_C = 96             # C of B3 and B4 on the main paths: 88 live columns
#                         (2K + 3 vectors x 8 slices, K = 4) padded to a tile
SCAN_WIDE = 384         # a multi-tile C (four tiles of 96)
KERNEL_SHAPES = [(37, 1031, SCAN_C), (BLOCK, N_SAMPLES, SCAN_C),
                 (BLOCK, N_SAMPLES, SCAN_WIDE)]     # B3: B, N, C
M_FIT = 16_384          # GRM variants of the fit (bench.py M_FITMIX)
FIT_SMALL = (2000, 1000)  # samples x variants of the card-vs-CPU fit
GRM_SHAPES = [(37, 1031, 128), (129, 1031, 256), (129, 1069, 16)]
GRM_WIDTHS = (16, 32, 64, 128, 256, 384, 768, 2048)   # C of B1 and B2
#                 over the fit's store: every tile, tiles of 128 and of
#                 256 looped, and the widest C the PheWAS fit has run
GRM_MAIN = len(GRM_SHAPES) + GRM_WIDTHS.index(64)   # the JSON line's shape:
#                                            the fit's most frequent C
SLICE_COLS = (31, 103, 248)   # R of the slice kernels at N = N_SAMPLES: the
#                 card-vs-CPU product's, the fit's average, its widest
SLICE_T = 8             # and a transposed [N, 8] view (the fitter's PY.T)
SLICE_MAIN = SLICE_COLS.index(103)      # the JSON line's shape
MV_ROWS, MV_COLS = 1024, 31  # the card-vs-CPU GRM product
PROFILE_COLS = 30       # columns of the profiled full-width GRM product
RTOL_MV = 1e-12         # card vs CPU GRM product (f64 atomics reorder)
RTOL_FIT = 1e-8         # card vs CPU small fit
RTOL_GROUP = 1e-10      # a PheWAS fit in groups against one group
FORMULA = "y ~ x1 + x2 + x3"
FORMULA_Q = "yq ~ x1 + x2 + x3"   # the quantitative phenotype of the fit data
H2_Q = 0.4              # its heritability
N_DS = 1024             # imputed variants of the DS phase
DS_BLOCK = 256          # its scan blocks
DS_ASSOC = 8            # DS variants tied to the phenotype
DS_TYPED = (256, 640)   # typed (integer-valued) DS variants
DS_CPU_ROWS = 128       # DS variants of the first block held against the CPU
DS_NOISY, DS_NOISE = 0.1, 0.15   # share of noisy dosages, the noise's sd
DS_UNITS, DS_UNIT, DS_CPU_UNITS = 16, 32, 2   # DS gene units, their size,
#                                              units held against the CPU
RTOL_USER = 1e-12       # assoc_spa_user against the DS scan's rows
CAT_EDGES = (10.5, 20.5)  # MAC categories of the categorized fit
RARE_SHARE = 0.5        # rare GRM markers of the categorized fit's data
F64_OPS_S = 34e12       # H100 SXM FP64 peak outside the tensor cores
SOURCES = ["indicator_dot_2bit", "plane_dot", "indicator_dot", "decode_codes",
           "gather_2bit"]
GATHER_SHAPES = [(37, 1031, 1021, False),
                 (BLOCK, 488_000, N_SAMPLES, True)]   # B, GDS samples,
#                 columns kept, sorted: a ragged width, the scan cells'
GATHER_MAIN = 1         # the JSON line's shape of the gather
B4_SHAPES = [(37, 1031, SCAN_C), (256, N_SAMPLES, SCAN_C),
             (256, N_SAMPLES, SCAN_WIDE)]       # B, N, C
SCAN_MAIN = 1           # the JSON line's shape of B3 and B4: C = SCAN_C
B5_ROWS = (256, 2048)   # rare-variant streams at N = N_SAMPLES
N_AGG = 16_384          # variants of the aggregate phase's GDS
N_UNITS = 512           # gene units of 8-64 contiguous variants
N_UNITS_RUN = 64        # the units the aggregate tests run (the first)
ENRICHED_UNITS = (1, 40, 100, 170, 250, 330, 410, 490)
AGG_SUB, AGG_CPU = 16, 8    # units of the burden/ACAT-V and CPU checks
RTOL_AGG = 1e-12        # burden and ACAT-V against ACAT-O on the card
HBM_BYTES_S = 3.35e12   # H100 SXM device memory rate
N_ALT = 1024            # phase 7's variants that the $dosage_alt scan reads
PHEWAS_CASES = (10, 20, 50)   # case % of the PheWAS fit's extra phenotypes
PHEWAS_MORE = 16        # binary phenotypes beyond them at full width
PHEWAS_SPREAD = (5.0, 50.0)   # their case %: any first k spread over this
#                               range (a van der Corput order)
N_PAIRS, GXG_M = 8, 4096      # GxG pairs; GRM variants of its panel
GXG_BATCH = 8           # its pair batch
GXG_SMALL_PAIRS = ((11, 12), (40, 90), (75, 150), (300, 500))
# GxG's start of tau_G for the batched-against-serial check: from the
# default start (1, 0.5) the base fit on a 4,096-variant panel of the
# 16,384 causal variants ends at tau_G = 0, in both packages
# (tests/test_torch_gxg_start.py), and a pair's solves then never use
# the GRM; from 0.1 (near the panel's quarter of the genetic variance) it
# ends positive, so the check covers the GLMM
GXG_TAU_INIT = (0.0, 0.1)
INT8_OPS_S = 1.979e15   # H100 SXM dense int8 tensor-core peak
MESH_SHARDS = 2         # shards of the mesh phase, all on the one card
DIST_RANKS = 2          # processes of the fit across processes, one card
DIST_TIMEOUT_S = 900    # their group's timeout: no rank waits longer
DIST_ABORT_S = 240      # the induced lead failure ends every rank by then
DIST_RUNS = 5           # products timed per width across the processes


def log(msg: str):
    print(msg, flush=True)


T_START = time.perf_counter()


def host_rss_gib() -> float:
    """This process's resident host memory now (``VmRSS``), GiB."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 2**20
    raise RuntimeError("no VmRSS in /proc/self/status")


def mark(phase: str):
    """Log the start of a phase with the seconds since the script began
    and this process's resident host memory."""
    log(f"== {phase} (at {time.perf_counter() - T_START:.1f} s, host RSS "
        f"{host_rss_gib():.2f} GiB)")


class LaunchWidths:
    """From its creation on, every B3 and B4 launch counted by phase and by
    C (the rows of the slices' layout that the wrapper hands its kernel);
    launch counts are untouched."""

    def __init__(self):
        from saigegds_tpu_torch.ops import score_kernel
        self.phase = ""
        self.counts = {}            # "phase: kernel C=c" -> launches
        inner = score_kernel._launch

        def launch(name, x, op, k):
            key = f"{self.phase}: {name} C={op.shape[0]}"
            self.counts[key] = self.counts.get(key, 0) + 1
            return inner(name, x, op, k)
        score_kernel._launch = launch

    def mark(self, phase: str):
        """`mark`, and the launches from here on count for ``phase``."""
        mark(phase)
        self.phase = phase.split(".")[0]

    def check(self, checked: set):
        """Every C at which the main paths launched B3 or B4 is one that
        phase 3 held against the plain versions, at full width."""
        launched = {key.split(": ")[1] for key in self.counts}
        log(f"B3 and B4 launches by phase and C (phase 4 on, this "
            f"process): {json.dumps(self.counts)}")
        missing = launched - checked
        if missing:
            raise AssertionError(f"the main paths launched "
                                 f"{sorted(missing)}, which phase 3 does "
                                 "not hold against the plain versions")


def median_ms(fn, runs: int, per: int = 1) -> float:
    """Median wall time of one call of ``fn`` on the card, in ms, by CUDA
    events around ``per`` calls back to back."""
    import torch
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(per):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / per)
    return float(np.median(times))


BATCH_MS = 2.0          # a kernel is timed over calls that span about this


def per_call_ms(fn, runs: int) -> tuple:
    """(ms a call, calls, ms of one call): a kernel's time, the median
    over ``runs`` of CUDA events
    around enough calls back to back to span about BATCH_MS (at least one),
    beside the median of one call between two events, which also times the
    host's work per call."""
    one = median_ms(fn, runs)
    per = max(1, min(32, int(BATCH_MS / max(one, 1e-3))))
    return (median_ms(fn, runs, per) if per > 1 else one), per, one


def kernel_modules():
    from saigegds_tpu_torch.ops import gather_2bit, grm_kernel, \
        score_kernel, sparse_codes
    return gather_2bit, grm_kernel, score_kernel, sparse_codes


def reset_launches():
    for mod in kernel_modules():
        for name in mod.LAUNCHES:
            mod.LAUNCHES[name] = 0


def launches() -> dict:
    """Launch count of every kernel, by name."""
    return {name: n for mod in kernel_modules()
            for name, n in mod.LAUNCHES.items()}


def expect_launches(what: str, want: dict):
    """Every kernel launched as often as ``want`` says (0 when absent)."""
    got = launches()
    bad = {k: v for k, v in got.items() if v != want.get(k, 0)}
    if bad:
        raise AssertionError(f"{what}: launches {got}, expected {want}")
    log(f"{what}: kernel launches {json.dumps(got)}")
    return got


def packed_model_builds(payloads: dict) -> int:
    """Slice launches of an aggregate run: its packed scan model is built
    at its first single-variant packed payload, once (one slice call)."""
    return int(bool(payloads.get("single_sparse", 0)
                    + payloads.get("single_2bit", 0)))


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: the larger of the bytes moved
    at the device memory rate and the int8 operations at the tensor-core
    peak (H100 SXM at 700 W); ``ops`` is kept for the achieved rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, ops / INT8_OPS_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), ops=ops, bytes=nbytes,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def compare_and_time(label: str, kern, plain, runs: int, least: dict,
                     plain_runs: int = 3, exact=None) -> dict:
    """Kernel against its plain version on the same tensors (bit-equal,
    each tensor where they return a tuple, and equal to ``exact`` when
    given), then the median times of both, in turns: plain, kernel,
    kernel, plain, beside ``least`` (`bound`)."""
    import torch
    got, want = kern(), plain()
    torch.cuda.synchronize()
    pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
    err = max(0.0 if torch.equal(g, w) else
              float((g.double() - w.double()).abs().max()) for g, w in pairs)
    if err or (exact is not None and not torch.equal(got, exact)):
        raise AssertionError(f"{label} disagrees with its plain version "
                             f"(max abs err {err}) or with its input")
    del got, want
    p1 = median_ms(plain, plain_runs)
    k1, per, one1 = per_call_ms(kern, runs)
    k2, _, one2 = per_call_ms(kern, runs)
    p2 = median_ms(plain, plain_runs)
    ms, plain_ms = float(np.median([k1, k2])), float(np.median([p1, p2]))
    one = float(np.median([one1, one2]))
    rate = f"{least['ops'] / ms * 1e3:.3e} int8 op/s" if least["ops"] else \
        f"{least['bytes'] / ms / 1e6:.1f} GB/s of needed bytes"
    log(f"{label}: bit-equal to the plain version; kernel {ms:.3f} ms a "
        f"call over {per} back to back (runs {k1:.3f}, {k2:.3f}; one call "
        f"between two events {one:.3f}), plain {plain_ms:.3f} ms (runs "
        f"{p1:.3f}, {p2:.3f}), bound {least['bound_ms']:.4f} ms "
        f"({least['bound_by']}); {rate}, {least['bound_ms'] / ms:.1%} of "
        f"the bound")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **least)


def int_mm_best(label: str, what: str, lhs, rhs, same, runs: int):
    """Median ms of ``torch._int_mm(lhs, rhs)`` (cuBLAS int8 GEMM) with the
    right-hand operand row- and column-major (the copy outside the time);
    the faster counts.  ``same(result)`` holds each result against the
    kernel's.  None, with the reason printed, when ``_int_mm`` refuses the
    shapes."""
    import torch
    times = {}
    for layout, r in (("row-major", rhs),
                      ("column-major", rhs.t().contiguous().t())):
        try:
            got = torch._int_mm(lhs, r)
        except RuntimeError as e:
            log(f"{label}: torch._int_mm refused the shapes "
                f"{tuple(lhs.shape)} x {tuple(r.shape)} {layout} "
                f"({str(e).splitlines()[0]})")
            continue
        ok = same(got)
        del got
        times[layout] = per_call_ms(lambda: torch._int_mm(lhs, r), runs)[0]
        log(f"{label}: torch._int_mm (cuBLAS int8 GEMM, contraction only, "
            f"{what}), right operand {layout}: {times[layout]:.3f} ms, "
            f"{'equal to' if ok else 'DIFFERENT from'} the kernel's result")
    return min(times.values()) if times else None


def int_mm_ms(label: str, codes, vs, kern_out, runs: int = 10):
    """The yardstick of B3 and B4: ``torch._int_mm`` on the same
    contraction, contraction only: the indicators of ``codes`` (int
    [B, N] in the slices' sample order) are decoded into int8 [3B, N]
    beforehand, outside the time.  Held against the kernel's ``kern_out``
    (f64 [B, 3, C])."""
    import torch
    c = codes.to(torch.int8)
    ind = torch.cat([torch.where(c == 3, 0, c), (c == 3).to(torch.int8),
                     (c == 2).to(torch.int8)])
    del c
    B = codes.shape[0]
    return int_mm_best(
        label, "the indicators decoded beforehand", ind, vs,
        lambda got: torch.equal(got.view(3, B, -1).transpose(0, 1).double(),
                                kern_out), runs)


def decoded_store(packed):
    """The yardstick's operands of B1 and B2: the store decoded into int8
    [M, 4 N4] (plane p in columns p N4 .. p N4 + N4 - 1) and its
    transpose, made once, outside every time."""
    import torch
    M, n4 = packed.shape
    D = torch.empty(M, 4 * n4, dtype=torch.int8, device=packed.device)
    for p in range(4):
        D[:, p * n4:(p + 1) * n4] = ((packed >> (2 * p)) & 3).view(
            torch.int8)
    return D, D.t().contiguous()


def grm_int_mm_ms(label: str, decoded, d4, dm, out_fwd, out_t,
                  runs: int = 5) -> dict:
    """The yardstick of B1 and B2: ``torch._int_mm`` on the store decoded
    beforehand (`decoded_store`): against d4 as [4 N4, C] for B1, and the
    decoded store's transpose against dm for B2; contraction only.  Held
    against the kernels' outputs."""
    import torch
    D, Dt = decoded
    n4, C = d4.shape[1], d4.shape[2]
    what = "the store decoded beforehand"
    out = {"plane_dot_fwd": int_mm_best(
        f"{label} B1", what, D, d4.reshape(4 * n4, C).contiguous(),
        lambda got: torch.equal(got.double(), out_fwd), runs)}
    out["plane_dot_t"] = int_mm_best(
        f"{label} B2", what + ", transposed", Dt, dm,
        lambda got: torch.equal(got.double().view(4, n4, C), out_t), runs)
    return out


def check_kernel(B: int, N: int, C: int, device, gen) -> dict:
    """B3 on the card vs its plain version on the same tensors, over the
    slices' layout made once beforehand (``operand_2bit``: the scan makes
    it once per model), whose own time is printed."""
    import torch
    from saigegds_tpu_torch.ops import score_kernel

    n4 = -(-N // 4)
    packed = torch.randint(0, 256, (B, n4), dtype=torch.uint8, device=device,
                           generator=gen)
    vs4 = torch.randint(-64, 65, (4, n4, C), dtype=torch.int8,
                        device=device, generator=gen)
    vs4.view(4 * n4, C)[N:] = 0          # padded samples meet zero rows
    vs4k = score_kernel.operand_2bit(vs4)
    label = f"B3 B={B} N={N} C={C}"
    res = compare_and_time(
        label, lambda: score_kernel.indicator_dot_2bit(packed, vs4, vs4k),
        lambda: score_kernel.indicator_dot_2bit_plain(packed, vs4), 10,
        bound(B * n4 + vs4.numel() + 4 * B * 3 * C,
              2 * 3 * B * 4 * n4 * C))
    layout_ms = median_ms(lambda: score_kernel.operand_2bit(vs4), 3)
    log(f"  of which not timed: the model's layout of the slices "
        f"(operand_2bit, once per model) {layout_ms:.3f} ms")
    pi = packed.to(torch.int32)          # natural order: sample p*N4 + j
    codes = torch.cat([(pi >> (2 * p)) & 3 for p in range(4)], dim=1)
    del pi
    res["library_ms"] = int_mm_ms(label, codes, vs4.view(4 * n4, C),
                                  score_kernel.indicator_dot_2bit(packed,
                                                                  vs4, vs4k))
    res["C"], res["N"] = C, N
    return res


def trace_scan_block(model, device, gen):
    """The scan's phase 1 of one block (``score_stats_binary_packed``: B3
    and the per-variant algebra), traced by ``torch.profiler`` over a model
    packed once beforehand as ``assoc_spa`` packs it: the device kernels
    by name, and no layout of the slices made for the block."""
    import torch
    from saigegds_tpu_torch.ops import score_kernel
    from saigegds_tpu_torch.ops.score import ScanParams
    from saigegds_tpu_torch.ops.score_packed import pack_scan_model, \
        score_stats_binary_packed

    sm = model.scan_model(device=device)
    t0 = time.perf_counter()
    pm = pack_scan_model(sm)
    torch.cuda.synchronize()
    t_pack = time.perf_counter() - t0
    n4 = pm.vs4.shape[1]
    payload = torch.randint(0, 256, (BLOCK, n4), dtype=torch.uint8,
                            device=device, generator=gen)
    params = ScanParams(maf=-1.0, mac=10.0, missing=0.1, spa_pval=0.05)
    score_stats_binary_packed(pm, params, payload)        # warm-up
    made = []
    saved = {k: getattr(score_kernel, k) for k in ("operand_2bit", "operand")}
    for k, fn in saved.items():
        setattr(score_kernel, k,
                lambda *a, _k=k, _fn=fn: made.append(_k) or _fn(*a))
    before = score_kernel.LAUNCHES["indicator_dot_2bit"]
    try:
        by_name = device_ms_by_kernel(
            lambda: score_stats_binary_packed(pm, params, payload))
    finally:
        for k, fn in saved.items():
            setattr(score_kernel, k, fn)
    if made or score_kernel.LAUNCHES["indicator_dot_2bit"] != before + 1:
        raise AssertionError(f"one block's phase 1 made layouts {made} or "
                             "did not launch B3 once")
    b3 = [v for k, v in by_name.items() if "indicator_kernel" in k]
    log(f"one scan block's phase 1 ({BLOCK} variants, C = "
        f"{pm.vs4.shape[2]}) traced by torch.profiler: no layout of the "
        f"slices made (the model's, packed once in {t_pack * 1e3:.1f} ms "
        f"with both kernels' layouts), one B3 launch ("
        + (f"its kernel {b3[0]:.4f} ms" if b3 else
           "its kernel not recorded by the profiler")
        + f"), {len(by_name)} kernels in all, "
        f"{sum(by_name.values()):.4f} ms; device ms by kernel: "
        + (", ".join(f"{kernel_name(k)[:60]} {v:.4f}"
                     for k, v in sorted(by_name.items(),
                                        key=lambda kv: -kv[1]))
           or "not measured (the profiler recorded no device events)"))


def grm_config(C: int) -> tuple:
    """B1 and B2's configuration at C slice columns: the kernels' column
    tile and whether they loop over tiles of it."""
    from saigegds_tpu_torch.ops.grm_kernel import column_tile
    return column_tile(C), C > column_tile(C)


def held_widths(what: str, widths):
    """Fail if ``what`` ran B1 and B2 at a C whose configuration
    (:func:`grm_config`) phase 3 did not hold against the plain versions
    at full width (GRM_WIDTHS)."""
    held = {grm_config(C) for C in GRM_WIDTHS}
    missing = sorted(int(C) for C in widths
                     if grm_config(int(C)) not in held)
    if missing:
        raise AssertionError(f"{what} ran B1 and B2 at C = {missing}, "
                             f"whose tile and looping phase 3 does not "
                             f"hold against the plain versions")


def random_store(M: int, N: int, device, gen):
    """uint8 [M, store_width(N)]: random codes 0..2 (code-3 bit pairs
    cleared, as in the fit's store)."""
    import torch
    from saigegds_tpu_torch.ops.packed_grm import store_width

    x = torch.randint(0, 256, (M, store_width(N)), dtype=torch.uint8,
                      device=device, generator=gen)
    m3 = x & (x >> 1) & 0x55
    return x & ~(m3 | (m3 << 1))


def check_grm(packed, N: int, C: int, gen, decoded=None) -> dict:
    """B1 and B2 on the card vs their plain versions on the same tensors: a
    store of the GRM store's width, B1's slices in [-64, 64] as the sample
    rows [N, C] that the GRM product hands kernel B1 through
    ``plane_dot_fwd_rows`` (so the time includes the wrapper's re-layout;
    the plain version and ``plane_dot_fwd`` take them zero-padded to
    [4, N4, C]), B2's operand in [-64, 64]; with ``decoded``
    (`decoded_store`), each beside its ``torch._int_mm`` yardstick
    (`grm_int_mm_ms`)."""
    import torch
    from saigegds_tpu_torch.ops import grm_kernel

    M, n4 = packed.shape
    d_rows = torch.randint(-64, 65, (N, C), dtype=torch.int8,
                           device=packed.device, generator=gen)
    d4 = torch.zeros(4 * n4, C, dtype=torch.int8, device=packed.device)
    d4[:N] = d_rows
    d4 = d4.view(4, n4, C)
    dm = torch.randint(-64, 65, (M, C), dtype=torch.int8,
                       device=packed.device, generator=gen)
    ops = 2 * M * 4 * n4 * C
    fwd = grm_kernel.plane_dot_fwd_rows(packed, d_rows, C)
    if not torch.equal(grm_kernel.plane_dot_fwd(packed, d4), fwd):
        raise AssertionError(f"plane_dot_fwd M={M} N={N} C={C}: the "
                             "wrapper of [4, N4, C] slices and the one of "
                             "sample rows disagree")
    out = {}
    for name, kern, plain, nbytes in (
            ("plane_dot_fwd",
             lambda: grm_kernel.plane_dot_fwd_rows(packed, d_rows, C),
             lambda: grm_kernel.plane_dot_fwd_plain(packed, d4),
             d_rows.numel() + 4 * M * C),
            ("plane_dot_t", lambda: grm_kernel.plane_dot_t(packed, dm),
             lambda: grm_kernel.plane_dot_t_plain(packed, dm),
             dm.numel() + 4 * 4 * n4 * C)):
        out[name] = compare_and_time(
            f"{name} M={M} N={N} C={C}", kern, plain, 5,
            bound(packed.numel() + nbytes, ops))
    layout_ms = median_ms(
        lambda: grm_kernel.fwd_rows_operand(d_rows, n4, C, packed.device), 5)
    layout = bound(d_rows.numel() + C * 4 * (-(-n4 // 32) * 32), 0)
    log(f"  of which B1's layout kernel (sample rows -> the kernel's order): "
        f"{layout_ms:.3f} ms, bound {layout['bound_ms']:.4f} ms (bytes)")
    if decoded is not None:
        lib = grm_int_mm_ms(f"M={M} N={N} C={C}", decoded, d4, dm, fwd,
                            grm_kernel.plane_dot_t(packed, dm))
        for name, ms in lib.items():
            out[name]["library_ms"] = ms
    return out


def check_slice(x, label: str) -> dict:
    """The slice kernels on the card vs the plain chain on the same f64
    [N, R] ``x``: slices and scales bit-equal; the bound reads ``x`` twice
    (the column max, then the slices) and writes 8 bytes an element."""
    from saigegds_tpu_torch.ops import grm_kernel
    from saigegds_tpu_torch.ops.packed_grm import N_SLICES, _slice_i8_plain

    N, R = x.shape
    return compare_and_time(
        f"slice_i8 N={N} R={R} {label}", lambda: grm_kernel.slice_i8(x),
        lambda: _slice_i8_plain(x, N_SLICES), 5, bound(24 * N * R, 0))


def check_gather(B: int, n_gds: int, n: int, in_order: bool, device,
                 gen) -> dict:
    """The 2-bit sample gather on the card against its plain version on
    the same random [B, ceil(n_gds / 4)] block and ``n`` distinct columns
    of its ``n_gds`` samples (sorted as the scan's GDS order, or
    shuffled), byte-equal; the bound reads the block and the int32
    columns and writes the gathered block."""
    import torch
    from saigegds_tpu_torch.ops import gather_2bit as g2

    n4 = -(-n_gds // 4)
    packed = torch.randint(0, 256, (B, n4), dtype=torch.uint8, device=device,
                           generator=gen)
    cols = torch.randperm(n_gds, device=device, generator=gen)[:n]
    if in_order:
        cols = cols.sort().values
    cols = cols.to(torch.int32)
    return compare_and_time(
        f"gather_2bit B={B} {n_gds} -> {n} samples "
        f"({'sorted' if in_order else 'shuffled'})",
        lambda: g2.gather_2bit(packed, cols),
        lambda: g2.gather_2bit_plain(packed, cols), 10,
        bound(B * n4 + B * -(-n // 4) + 4 * n, 0))


def slice_input(N: int, R: int, device, gen):
    """f64 [N, R] of normal values at column scales 1e-5 to 1e5, as the
    products' operands spread."""
    import torch
    x = torch.randn(N, R, dtype=torch.float64, device=device, generator=gen)
    return x * 10.0 ** (torch.rand(R, dtype=torch.float64, device=device,
                                   generator=gen) * 10 - 5)


WGMMA_SOURCES = ("plane_dot", "indicator_dot_2bit", "indicator_dot")


def check_build(name: str):
    """Phase 2's checks of a built source: no entry spills, and the
    libraries of B1 and B2, B3, and B4 run on the warpgroup MMA fed by TMA
    or bulk copies, with no ``mma.sync`` left (``cuobjdump -sass``)."""
    from saigegds_tpu_torch.ops import _cuda
    spills = [line.strip() for line in _cuda.BUILD_LOG.get(name, "")
              .splitlines() if "spill" in line
              and ("0 bytes spill stores, 0 bytes spill loads" not in line)]
    if spills:
        raise AssertionError(f"{name}: an entry spills: {spills}")
    if name not in WGMMA_SOURCES:
        return
    tool = os.path.join(os.path.dirname(_cuda._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", os.path.join(
        _cuda.BUILD_DIR, f"lib{name}.so")], capture_output=True,
        text=True, timeout=300, check=True).stdout
    count = {op: sass.count(op) for op in ("GMMA", "UTMALDG", "UBLKCP",
                                            "IMMA")}
    log(f"  SASS {name}: {json.dumps(count)}")
    if not count["GMMA"] or not (count["UTMALDG"] or count["UBLKCP"]) \
            or count["IMMA"]:
        raise AssertionError(f"{name}: its kernels must run warpgroup MMAs "
                             "on tiles copied by TMA or bulk copies, and no "
                             f"mma.sync (SASS {count})")


class KernelClock:
    """Device seconds of every B1 and B2 wrapper call while active: CUDA
    events around each call of ``grm_kernel.plane_dot_fwd``,
    ``plane_dot_fwd_rows`` (both B1's) and ``plane_dot_t`` (re-layout,
    kernel and the f64 result), summed by kernel after a synchronize.
    Launch counts are untouched."""

    NAMES = {"plane_dot_fwd": "plane_dot_fwd",
             "plane_dot_fwd_rows": "plane_dot_fwd",
             "plane_dot_t": "plane_dot_t"}   # wrapper -> kernel

    def __enter__(self):
        import torch
        from saigegds_tpu_torch.ops import grm_kernel
        self.events = {kernel: [] for kernel in self.NAMES.values()}
        self.saved = {name: getattr(grm_kernel, name) for name in self.NAMES}

        def timed(name):
            fn = self.saved[name]

            def call(*args):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                out = fn(*args)
                b.record()
                self.events[self.NAMES[name]].append((a, b))
                return out
            return call
        for name in self.NAMES:
            setattr(grm_kernel, name, timed(name))
        return self

    def __exit__(self, *exc):
        from saigegds_tpu_torch.ops import grm_kernel
        for name, fn in self.saved.items():
            setattr(grm_kernel, name, fn)

    def seconds(self) -> dict:
        import torch
        torch.cuda.synchronize()
        return {name: sum(a.elapsed_time(b) for a, b in ev) / 1e3
                for name, ev in self.events.items()}


def check_b4(B: int, N: int, C: int, device, gen) -> dict:
    """B4 on the card vs its plain version: int8 codes of all four values
    against int8 slices in [-64, 64], over the slices' layout made once
    beforehand (``operand``, once per model on the main path)."""
    import torch
    from saigegds_tpu_torch.ops import score_kernel

    codes = torch.randint(0, 4, (B, N), dtype=torch.int8, device=device,
                          generator=gen)
    vs = torch.randint(-64, 65, (N, C), dtype=torch.int8, device=device,
                       generator=gen)
    vsk = score_kernel.operand(vs)
    label = f"B4 B={B} N={N} C={C}"
    res = compare_and_time(
        label, lambda: score_kernel.indicator_dot(codes, vs, vsk),
        lambda: score_kernel.indicator_dot_plain(codes, vs), 10,
        bound(B * N + N * C + 4 * B * 3 * C, 2 * 3 * B * N * C))
    layout_ms = median_ms(lambda: score_kernel.operand(vs), 3)
    log(f"  of which not timed: the model's layout of the slices "
        f"(operand, once per model) {layout_ms:.3f} ms")
    res["library_ms"] = int_mm_ms(label, codes, vs,
                                  score_kernel.indicator_dot(codes, vs, vsk))
    res["C"], res["N"] = C, N
    return res


def check_b5(codes: np.ndarray, device) -> dict:
    """B5 on the card vs its plain version and the codes that were
    encoded, beside the zero-fill ``torch.zeros`` of its output (the
    yardstick: what any decode that writes the whole output pays); then
    each of its two stages (the tile table, the tile replay) vs its own
    plain version, with its own time and bound."""
    import torch
    from saigegds_tpu_torch.ops import sparse_codes as sc

    B, N = codes.shape
    entries, row_ptr = sc.encode_sparse_rows(codes)
    e = torch.from_numpy(entries).to(device)
    rp = torch.from_numpy(row_ptr).to(device)
    dense = int(np.sum(np.count_nonzero(codes, axis=1)
                       > N * sc.SPARSE_NNZ_FRAC))
    label = f"B5 {B} rows x N={N}, {len(entries)} entries, {dense} dense rows"
    res = compare_and_time(
        label, lambda: sc.decode_codes(e, rp, B, N),
        lambda: sc.decode_codes_plain(e, rp, B, N), 10,
        bound(B * N + 2 * len(entries) + 4 * (B + 1), 0),
        exact=torch.from_numpy(codes).to(device))
    res["library_ms"] = per_call_ms(
        lambda: torch.zeros(B, N, dtype=torch.int8, device=device), 10)[0]
    log(f"{label}: torch.zeros of the output (yardstick, the zero-fill "
        f"alone) {res['library_ms']:.3f} ms")
    tiles = -(-(B * N) // sc.TILE)
    s0, end = int(row_ptr[0]), int(row_ptr[-1])

    def stage1(fn):
        """The table and the words of [s0, end), as one int64 tensor."""
        table, words = fn(e, rp, B, N)
        return torch.cat([table, words[s0:end].to(torch.int64)])

    if not torch.equal(stage1(sc.tile_table), stage1(sc.tile_table_plain)):
        raise AssertionError(f"{label}: stage 1 disagrees with its plain "
                             "version")
    least = bound(4 * len(entries) + 4 * (B + 1) + 8 * (tiles + 1), 0)
    ms = float(np.median([median_ms(lambda: sc.tile_table(e, rp, B, N), 10)
                          for _ in range(2)]))
    log(f"  B5 stage 1, tile table ({tiles + 1} rows) and words: bit-equal "
        f"to the plain version; kernel {ms:.3f} ms, bound "
        f"{least['bound_ms']:.4f} ms (bytes)")
    table, words = sc.tile_table(e, rp, B, N)
    compare_and_time(
        f"  B5 stage 2, tile replay ({tiles} tiles)",
        lambda: sc.replay_tiles(table, words, B, N),
        lambda: sc.replay_tiles_plain(table, words, B, N), 10,
        bound(B * N + 2 * len(entries) + 8 * (tiles + 1), 0))
    runs = 5
    by_name = device_ms_by_kernel(lambda: sc.decode_codes(e, rp, B, N), runs)
    if by_name:
        log(f"  B5 device time per decode (torch.profiler, mean of {runs}): "
            + ", ".join(f"{kernel_name(k)} {v:.4f} ms"
                        for k, v in by_name.items())
            + f"; sum {sum(by_name.values()):.4f} ms")
    else:
        log("  B5 device time per decode: not measured (the profiler "
            "recorded no device events)")
    return res


def kernel_name(key: str) -> str:
    """A profiler key without its namespace and arguments."""
    return key.replace("(anonymous namespace)::", "").split("(")[0].strip()


def device_ms_by_kernel(fn, runs: int = 1) -> dict:
    """Device time of each kernel that ``runs`` calls of ``fn`` launch,
    by name, in ms per call (``torch.profiler``); empty when the profiler
    records no device events."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", 0.0)
        if t and ev.device_type == torch.autograd.DeviceType.CUDA:
            by_name[ev.key] = by_name.get(ev.key, 0.0) + t / 1e3 / runs
    return by_name


def ragged_stream_codes(seed: int) -> np.ndarray:
    """int8 codes [37, 49,162] whose stream is full of escapes (gaps above
    16,383): half the rows nearly empty, an empty first row, rows with gaps
    of exactly the escape step, one long escape run, an all-missing row
    and three trailing empty rows."""
    from saigegds_tpu_torch.ops.sparse_codes import ESC_STEP
    rng = np.random.default_rng(seed)
    B, N = 37, 3 * ESC_STEP + 10
    frac = np.where(np.arange(B) < B // 2, 2e-5, 0.01)[:, None]
    nz = rng.random((B, N)) < frac
    codes = np.zeros((B, N), np.int8)
    codes[nz] = rng.choice(np.int8([1, 2, 3]), size=int(nz.sum()))
    codes[0] = 0
    codes[3] = 0
    codes[3, [0, ESC_STEP, ESC_STEP + 1, N - 1]] = [1, 2, 3, 1]
    codes[4, : N - 2] = 0
    codes[5] = 3
    codes[-3:] = 0
    return codes


def make_rare_codes(n_variants: int, n_samples: int, seed: int,
                    cases=None, enriched=()) -> np.ndarray:
    """int8 codes [M, N] of an exome at biobank scale, drawn sparsely (per
    variant, minor-allele positions from the seed): 50% ultra-rare with
    1-9 minor alleles, 40% rare (MAF 1e-4 to 1e-2, log-uniform), 10%
    low-frequency (MAF 0.01-0.05); 1% ALT-major; then 0.5% missing.  The
    variants in ``enriched`` draw their minor alleles from ``cases`` (all
    of them when ultra-rare, half otherwise)."""
    rng = np.random.default_rng(seed)
    N = n_samples
    u = rng.random(n_variants)
    maf = np.where(u < 0.9, np.exp(rng.uniform(np.log(1e-4), np.log(1e-2),
                                               n_variants)),
                   rng.uniform(0.01, 0.05, n_variants))
    n_minor = np.where(u < 0.5, rng.integers(1, 10, n_variants),
                       rng.binomial(2 * N, maf))
    enriched = set(np.asarray(enriched).tolist())
    codes = np.zeros((n_variants, N), np.int8)
    for i, k in enumerate(n_minor.tolist()):
        if i in enriched:
            k_case = k if k < 10 else k // 2
            idx = np.concatenate([cases[rng.integers(0, len(cases), k_case)],
                                  rng.integers(0, N, k - k_case)])
        else:
            idx = rng.integers(0, N, k)
        pos, cnt = np.unique(idx, return_counts=True)
        codes[i, pos] = np.minimum(cnt, 2)
    alt_major = np.flatnonzero(rng.random(n_variants) < 0.01)
    codes[alt_major] = 2 - codes[alt_major]
    flat = codes.reshape(-1)
    flat[rng.integers(0, flat.size, rng.binomial(flat.size, MISS_RATE))] = 3
    return codes


def make_data(y: np.ndarray, n_variants: int, device, seed: int,
              n_assoc: int = N_ASSOC):
    """int8 codes [M, N] of the scan, for the phenotype ``y`` [N].

    Genotypes are drawn on ``device`` in chunks (two alleles per sample
    against the variant's ALT frequency): 25% rare (MAF 0.0005-0.01,
    log-uniform), 15% low-frequency (0.01-0.05), the rest common
    (0.05-0.5), a tenth of them ALT-major; the first ``n_assoc`` variants
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
        if s < n_assoc:
            # case enrichment from 2% to 24%: p-values from ~0.05 down
            # past 1e-100
            k = min(n_assoc, e) - s
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


def make_dosages(codes: np.ndarray, device, seed: int) -> np.ndarray:
    """f64 imputed dosages [M, N] from hard calls [M, N] (3 = missing),
    drawn on ``device`` in chunks: a share DS_NOISY of the entries gets a
    Gaussian imputation noise of sd DS_NOISE, every dosage is clipped to
    [0, 2] and rounded to 0.001 (as an imputed VCF's DS field carries
    it); NaN where the call is missing; the variants in DS_TYPED keep
    their hard calls."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    out = np.empty(codes.shape, np.float64)
    step = 128
    for s in range(0, len(codes), step):
        c = torch.as_tensor(codes[s : s + step], device=device)
        g = c.to(torch.float64)
        noisy = torch.rand(c.shape, generator=gen, device=device) < DS_NOISY
        noise = torch.randn(c.shape, generator=gen, device=device,
                            dtype=torch.float64) * DS_NOISE
        d = torch.round(torch.clamp(g + noise * noisy, 0.0, 2.0) * 1000) \
            / 1000
        v = torch.arange(s, s + len(c), device=device)[:, None]
        d = torch.where((v >= DS_TYPED[0]) & (v < DS_TYPED[1]), g, d)
        out[s : s + step] = torch.where(c == 3, torch.nan, d).cpu().numpy()
    return out


def with_extra_samples(codes: np.ndarray, sample_id: np.ndarray,
                       seed: int):
    """``codes`` [M, N] (hard calls or dosages) with N_EXTRA random sample
    columns that the model lacks inserted at shuffled positions, and the
    GDS's sample ids."""
    rng = np.random.default_rng(seed)
    at = np.sort(rng.integers(0, codes.shape[1] + 1, N_EXTRA))
    extra = rng.integers(0, 3, (codes.shape[0], N_EXTRA)).astype(np.int8)
    ids = np.insert(np.asarray(sample_id),
                    at, 10**7 + np.arange(N_EXTRA)).astype(np.int32)
    return np.insert(codes, at, extra, axis=1), ids


def case_fraction_pheno(rng, liability: np.ndarray, pct: float,
                        iters: int = 60) -> np.ndarray:
    """A binary phenotype of ``liability`` (logit scale) with an intercept
    set by bisection so that its expected case share is ``pct`` %."""
    lo, hi = -20.0, 20.0
    for _ in range(iters):
        c = (lo + hi) / 2
        if np.mean(1 / (1 + np.exp(-(liability + c)))) < pct / 100:
            lo = c
        else:
            hi = c
    return (rng.random(len(liability)) < 1 / (1 + np.exp(
        -(liability + c)))).astype(np.float64)


def spread_pct(k: int) -> float:
    """The k-th case % (k >= 0) of the extra PheWAS phenotypes: PHEWAS_SPREAD
    in van der Corput order, so any first few cover the range."""
    v, f, i = 0.0, 0.5, k + 1
    while i:
        v += f * (i & 1)
        i >>= 1
        f /= 2
    lo, hi = PHEWAS_SPREAD
    return lo + (hi - lo) * v


def make_fit_data(n_samples: int, n_variants: int, device, seed: int,
                  rare_share: float = 0.0, more_phenotypes: int = 0):
    """(int8 codes [M, N], data dict) of a polygenic binary trait ``y``, as
    bench.py's fit data: allele frequencies uniform in 0.05-0.5, effects
    giving a genetic variance of 0.6 on the logit scale, three covariates
    plus the intercept; genotypes drawn on ``device`` in chunks, then 0.5%
    set missing.  The column ``yq`` is a quantitative trait from the same
    genetic values and covariates, heritability H2_Q, with a right-skewed
    noise (log-normal, as for BMI), drawn after ``y`` from the same
    stream, so that ``y`` is the same with or without it.  A share
    ``rare_share`` of the variants, drawn from another stream, has allele
    frequencies 0.002-0.01 instead.  ``more_phenotypes`` binary traits
    ``yp0``, ``yp1``, ... of the same genetic values at the case fractions
    of :func:`spread_pct` come last, from a stream of their own, so that
    every other column is the same with or without them."""
    import torch
    rng = np.random.default_rng(seed)
    af = rng.uniform(0.05, 0.5, n_variants)
    if rare_share:
        rare_rng = np.random.default_rng(seed + 1)
        rare = rare_rng.random(n_variants) < rare_share
        af[rare] = rare_rng.uniform(0.002, 0.01, int(rare.sum()))
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
    g = g_eff.cpu().numpy()
    eta = X @ alpha - 1.5 + g
    y = (rng.random(n_samples) < 1 / (1 + np.exp(-eta))).astype(np.float64)
    e = np.exp(rng.normal(size=n_samples) * 0.6)
    e = (e - e.mean()) / e.std() * np.sqrt(g.var() * (1 - H2_Q) / H2_Q)
    data = {"sample.id": np.arange(1, n_samples + 1, dtype=np.int32),
            "y": y, "yq": X @ alpha + g + e}
    # the PheWAS phenotypes, drawn after y and yq: binary traits of the
    # same genetic values at other case fractions, and a second
    # quantitative trait with a fresh noise
    for pct in PHEWAS_CASES:
        data[f"yb{pct}"] = case_fraction_pheno(rng, X @ alpha + g, pct)
    e2 = np.exp(rng.normal(size=n_samples) * 0.6)
    data["yq2"] = X @ alpha + g + (e2 - e2.mean()) / e2.std() * np.sqrt(
        g.var() * (1 - H2_Q) / H2_Q)
    more = np.random.default_rng(seed + 7)
    for k in range(more_phenotypes):
        data[f"yp{k}"] = case_fraction_pheno(more, X @ alpha + g,
                                             spread_pct(k), iters=30)
    data.update({f"x{i}": X[:, i] for i in range(1, N_COV + 1)})
    return codes, data


def profile_product(device, gen) -> dict:
    """One GRM product at PROFILE_COLS columns over a random store of the
    fit's size (M_FIT x N_SAMPLES, MISS_RATE of the pairs missing, allele
    frequencies 0.05-0.5): its median time by CUDA events, then one product
    under ``torch.profiler`` with the device time of each kernel, in ms."""
    import torch
    from saigegds_tpu_torch.ops.packed_grm import Packed2GRM

    M, N = M_FIT, N_SAMPLES
    af = torch.rand(M, dtype=torch.float64, device=device,
                    generator=gen) * 0.45 + 0.05
    nnz = int(np.random.default_rng(SEED).binomial(M * N, MISS_RATE))
    grm = Packed2GRM(
        random_store(M, N, device, gen), af,
        1.0 / torch.sqrt(2.0 * af * (1.0 - af)),
        torch.ones(N, dtype=torch.float64, device=device),
        torch.randint(0, M, (nnz,), device=device, generator=gen),
        torch.randint(0, N, (nnz,), device=device, generator=gen), N)
    b = torch.randn(N, PROFILE_COLS, dtype=torch.float64, device=device,
                    generator=gen)
    grm.matvec(b)
    ms = median_ms(lambda: grm.matvec(b), 3)
    by_name = device_ms_by_kernel(lambda: grm.matvec(b))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    log(f"GRM product at R = {PROFILE_COLS} over a random store of {M} "
        f"variants x {N} samples, {nnz} missing pairs: {ms:.3f} ms (median "
        f"of 3, CUDA events)")
    if top:
        log(f"  device time by kernel (ms, torch.profiler, one product; "
            f"sum {sum(by_name.values()):.3f}):")
        for name, t in top:
            log(f"    {t:9.3f}  {name[:110]}")
    else:
        log("  device time by kernel: not measured (the profiler recorded "
            "no device events)")
    forms = correction_forms(grm, b, gen)
    return dict(ms=ms, kernels=dict(top), corrections=forms)


def correction_forms(grm, B, gen) -> dict:
    """The product's two missing-pair corrections (per variant: the sum of
    B over its missing samples; per sample: the sum of a [M, R] matrix
    over its missing variants) in five forms on the same pairs: the ms of
    each (median of 3, CUDA events) and whether two runs agree bit for
    bit.  The port runs the last, ``embedding_bag`` sums over the pair
    lists sorted at build time; ``index_add_`` with f64 atomics ran
    before."""
    import warnings
    import torch

    M, N = grm.n_variants, grm.n_samples
    W = torch.randn(M, B.shape[1], dtype=torch.float64, device=B.device,
                    generator=gen)
    miss = grm.miss
    mv, ms = miss.variants().long(), miss.samp.long()
    P = len(ms)
    starts_v = torch.cat([miss.var_start.long(), mv.new_tensor([P])])
    starts_s = torch.cat([miss.samp_start.long(), mv.new_tensor([P])])
    vs = miss.var.long()
    ones = torch.ones(P, dtype=torch.float64, device=B.device)

    def zeros(n):
        return torch.zeros(n, B.shape[1], dtype=torch.float64,
                           device=B.device)

    def deterministic(fn):
        def run():
            torch.use_deterministic_algorithms(True)
            try:
                return fn()
            finally:
                torch.use_deterministic_algorithms(False)
        return run

    def csr(crow, col, n_rows, n_cols, rhs):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return torch.sparse_csr_tensor(crow, col, ones,
                                           (n_rows, n_cols)) @ rhs

    per_variant = {
        "index_add_": lambda: zeros(M).index_add_(0, mv, B[ms]),
        "segment_reduce": lambda: torch.segment_reduce(
            B[ms], "sum", lengths=starts_v.diff(), unsafe=True),
        "CSR SpMM": lambda: csr(starts_v, ms, M, N, B),
        "embedding_bag": lambda: miss.per_variant(B)}
    per_sample = {
        "index_add_": lambda: zeros(N).index_add_(0, ms, W[mv]),
        "segment_reduce": lambda: torch.segment_reduce(
            W[vs], "sum", lengths=starts_s.diff(), unsafe=True),
        "CSR SpMM": lambda: csr(starts_s, vs, N, M, W),
        "embedding_bag": lambda: miss.per_sample(W)}
    for forms in (per_variant, per_sample):
        forms["index_add_ deterministic"] = deterministic(forms["index_add_"])
    out = {}
    for name in ("index_add_", "index_add_ deterministic", "segment_reduce",
                 "CSR SpMM", "embedding_bag"):
        row = dict(repeat_equal=True)
        for which, forms in (("per_variant", per_variant),
                             ("per_sample", per_sample)):
            same = torch.equal(forms[name](), forms[name]())
            row["repeat_equal"] = row["repeat_equal"] and same
            row[f"{which}_ms"] = median_ms(forms[name], 3)
            torch.cuda.empty_cache()
        row["ms"] = row["per_variant_ms"] + row["per_sample_ms"]
        out[name] = row
    log(f"  the missing-pair corrections alone at R = {B.shape[1]}, {P} "
        f"pairs kept in {miss.nbytes} B on the card "
        f"({miss.nbytes / max(P, 1):.2f} B per pair; two int64 lists were "
        f"16) (ms per variant + per sample, median of 3, CUDA events; "
        f"bit-equal when run twice): "
        + "; ".join(f"{k} {v['per_variant_ms']:.3f} + "
                    f"{v['per_sample_ms']:.3f} ({v['repeat_equal']})"
                    for k, v in out.items())
        + "; the port runs embedding_bag")
    if not out["embedding_bag"]["repeat_equal"]:
        raise AssertionError("the port's corrections differ from run to run")
    return out


def fit(gds: str, data: dict, device: str, quant: bool = False, mesh=None,
        keep: dict = None, **cfg):
    """(model, instrument dict) of one fit_null_glmm run, of the binary
    trait ``y`` or (``quant``) the quantitative ``yq`` with the default
    ``inv_norm``, over ``mesh`` if given; ``cfg`` holds further
    NullModelConfig fields; the dict also holds its wall seconds.  With
    ``keep``, ``keep["grm"]`` receives the fit's GRM operator (by wrapping
    ``fitnull._prepare_fit``)."""
    import torch
    from saigegds_tpu_torch import NullModelConfig, fit_null_glmm
    from saigegds_tpu_torch.models import fitnull

    inst = {}
    real = fitnull._prepare_fit

    def keeping(*a, **k):
        out = real(*a, **k)
        keep["grm"] = out["grm"]
        return out

    if keep is not None:
        fitnull._prepare_fit = keeping
    t0 = time.perf_counter()
    cfg = NullModelConfig(trait_type="quantitative" if quant else "binary",
                          **cfg)
    try:
        model = fit_null_glmm(FORMULA_Q if quant else FORMULA, data, gds,
                              cfg, instrument=inst, device=device, mesh=mesh)
    finally:
        fitnull._prepare_fit = real
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    inst["wall_s"] = time.perf_counter() - t0
    return model, inst


def check_fit(model):
    ratio = np.asarray(model.var_ratio["ratio"], float)
    if not model.converged:
        raise AssertionError("the fit did not converge")
    if not model.tau[1] > 0:
        raise AssertionError(f"tau_G = {model.tau[1]} is not positive")
    if model.trait_type == "quantitative" and not model.tau[0] > 0:
        raise AssertionError(f"tau_E = {model.tau[0]} is not positive")
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


def same_fit(what: str, got, inst_got: dict, want, inst_want: dict,
             counts=("outer_iterations", "pcg_iterations", "matvecs")):
    """``got`` equals ``want`` bit for bit: tau, coefficients, fitted
    values, variance ratios and their markers, and the ``counts`` of
    their instrument dicts."""
    for k in counts:
        if inst_got[k] != inst_want[k]:
            raise AssertionError(f"{what}: {k} {inst_got[k]} against "
                                 f"{inst_want[k]}")
    for k in ("tau", "coefficients", "fitted_values", "linear_predictors"):
        if not np.array_equal(getattr(got, k), getattr(want, k)):
            raise AssertionError(f"{what}: {k} differs, max relative "
                                 f"{max_rel(getattr(got, k), getattr(want, k), k):.3e}")
    for k in ("id", "ratio"):
        if not np.array_equal(got.var_ratio[k], want.var_ratio[k]):
            raise AssertionError(f"{what}: variance-ratio {k} differs")


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


def scan(gds: str, model, device: str, variant_mask=None,
         packed_2bit: bool = True, block: int = BLOCK, dsnode: str = "",
         mesh=None):
    """(table, instrument dict, wall seconds) of one assoc_spa run."""
    import torch
    from saigegds_tpu_torch import ScanConfig, assoc_spa

    inst = {}
    t0 = time.perf_counter()
    tab = assoc_spa(gds, model, ScanConfig(block_size=block,
                                           packed_2bit=packed_2bit,
                                           dsnode=dsnode),
                    variant_mask=variant_mask, instrument=inst,
                    device=device, mesh=mesh)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return tab, inst, time.perf_counter() - t0


@contextlib.contextmanager
def phase1_payloads():
    """The bytes of each phase-1 payload the scans in the block upload, in
    order: read where the scan's ``_upload`` hands a block's payload to
    ``_to_device``."""
    from saigegds_tpu_torch.assoc import single

    shipped, real = [], single._to_device

    def to_device(a, device):
        if sys._getframe(1).f_code.co_name == "_upload":
            shipped.append(a.nbytes)
        return real(a, device)

    single._to_device = to_device
    try:
        yield shipped
    finally:
        single._to_device = real


def check_table(tab: dict):
    p = tab["pval"]
    if not (len(p) and np.all(np.isfinite(p)) and np.all((p >= 0) & (p <= 1))):
        raise AssertionError("p-values outside [0, 1] or not finite")
    for c in ("AF.alt", "beta", "SE", "p.norm"):
        if c in tab and np.isnan(tab[c]).any():
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
        if c in cpu and not np.array_equal(np.asarray(gpu[c])[sel],
                                           np.asarray(cpu[c])):
            raise AssertionError(f"column {c} differs between card and CPU")
    worst = 0.0
    for c in (c for c in ("pval", "p.norm", "beta", "SE") if c in cpu):
        a, b = gpu[c][sel], cpu[c]
        rel = np.abs(a - b) / np.maximum(np.abs(b), np.finfo(float).tiny)
        worst = max(worst, float(rel.max(initial=0.0)))
    if worst > RTOL:
        raise AssertionError(f"card vs CPU max relative error {worst:.3e} "
                             f"> {RTOL}")
    return worst


def compare_dense(got: dict, want: dict, rtol: float) -> float:
    """Rows of ``want`` against the same rows of ``got`` where a dense f64
    route is involved: ids, counts, converged flags and the SPA set
    (``p.norm <= spa_pval``) exact; AF.alt, mac and the statistics within
    ``rtol`` with the same NaN pattern (f64 sums over samples run in
    another order on each side)."""
    if list(got) != list(want):
        raise AssertionError("column order differs")
    sel = np.isin(got["id"], want["id"])
    if sel.sum() != len(want["id"]):
        raise AssertionError("the table lacks rows of the other")
    for c in ("id", "chr", "pos", "rs.id", "ref", "alt", "num",
              "converged"):
        if c in want and not np.array_equal(np.asarray(got[c])[sel],
                                            np.asarray(want[c])):
            raise AssertionError(f"column {c} differs")
    if "p.norm" in want and not np.array_equal(got["p.norm"][sel] <= 0.05,
                                               want["p.norm"] <= 0.05):
        raise AssertionError("the SPA sets differ")
    worst = max(max_rel(got[c][sel], want[c], c)
                for c in ("AF.alt", "mac", "pval", "p.norm", "beta", "SE")
                if c in want)
    if worst > rtol:
        raise AssertionError(f"max relative error {worst:.3e} > {rtol}")
    return worst


def unit_sizes(seed: int) -> np.ndarray:
    """N_UNITS unit sizes in [8, 64] that add up to N_AGG (32 on average)."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(8, 57, N_UNITS)
    while sizes.sum() != N_AGG:
        i = rng.integers(N_UNITS)
        step = int(np.sign(N_AGG - sizes.sum()))
        if 8 <= sizes[i] + step <= 64:
            sizes[i] += step
    return sizes


def max_rel(a, b, what: str) -> float:
    """Max relative difference of two p-value columns that must share
    their NaN pattern."""
    a, b = np.asarray(a, float), np.asarray(b, float)
    if not np.array_equal(np.isnan(a), np.isnan(b)):
        raise AssertionError(f"{what}: NaN patterns differ")
    m = ~np.isnan(a)
    rel = np.abs(a[m] - b[m]) / np.maximum(np.abs(b[m]),
                                           np.finfo(float).tiny)
    return float(rel.max(initial=0.0))


def aggregate(model, y: np.ndarray, work: str) -> dict:
    """Phase 7: the aggregate tests at full width on the card, held
    against themselves (burden, ACAT-V) and the CPU (first units)."""
    import torch
    from saigegds_tpu_torch import (AggregateConfig, assoc_acat_o,
                                    assoc_acat_v, assoc_burden, shard_units,
                                    units_from_groups)
    from saigegds_tpu_torch.io.gds_write import write_seqarray_gds
    from saigegds_tpu_torch.io.seqarray import SeqData

    t0 = time.perf_counter()
    sizes = unit_sizes(SEED + 3)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    enriched = np.concatenate([np.arange(starts[u], starts[u] + sizes[u])
                               for u in ENRICHED_UNITS])
    codes = make_rare_codes(N_AGG, len(y), SEED + 2,
                            cases=np.flatnonzero(y > 0.5), enriched=enriched)
    t_gen = time.perf_counter() - t0
    nnz = np.count_nonzero(codes, axis=1)
    gds = os.path.join(work, "exome.gds")
    write_seqarray_gds(gds, codes, compress="ZIP_ra")
    del codes
    groups = {f"unit{u:03d}": list(range(a + 1, a + n + 1))
              for u, (a, n) in enumerate(zip(starts.tolist(),
                                             sizes.tolist()))}
    units = units_from_groups(SeqData(gds), groups)
    log(f"aggregate setup: {N_AGG} variants x {len(y)} samples, "
        f"{nnz.sum() / N_AGG:.0f} nonzero codes per variant (median "
        f"{np.median(nnz):.0f}), {len(units)} units of {sizes.min()}-"
        f"{sizes.max()} variants, GDS "
        f"{os.path.getsize(gds) / 1e6:.0f} MB; drawn in {t_gen:.1f} s, "
        f"{time.perf_counter() - t0:.1f} s with the write; the tests run "
        f"the first {N_UNITS_RUN} units")
    units = shard_units(units, 0, N_UNITS // N_UNITS_RUN)

    cfg = AggregateConfig()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    inst = {}
    t0 = time.perf_counter()
    tab = assoc_acat_o(gds, model, units, cfg, instrument=inst,
                       device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    pay = inst["payloads"]
    n_sparse = pay.get("burden_sparse", 0) + pay.get("single_sparse", 0)
    counts = expect_launches("ACAT-O", {
        "decode_codes": n_sparse,
        "indicator_dot": pay.get("single_sparse", 0),
        "indicator_dot_2bit": pay.get("single_2bit", 0),
        "slice_i8": packed_model_builds(pay)})
    if not (counts["decode_codes"] and counts["indicator_dot"]):
        raise AssertionError(f"B4 or B5 never launched: payloads {pay}")
    pcols = [c for c in tab if c.startswith("pval")]
    for c in pcols:
        p = tab[c][np.isfinite(tab[c])]
        if not (len(p) and np.all((p >= 0) & (p <= 1))):
            raise AssertionError(f"{c}: no finite p-value, or outside [0, 1]")
    if not inst.get("spa_n"):
        raise AssertionError("no row went through SPA")
    host = {k: round(inst.get(k, 0.0), 3)
            for k in ("fetch_s", "tally_s", "encode_s", "upload_s")}
    log(f"ACAT-O on the card: {len(units)} units, {wall:.2f} s wall = host "
        f"{sum(host.values()):.2f} s {json.dumps(host)} + waiting on the "
        f"card {inst.get('wait_s', 0.0):.2f} s + SPA {inst['spa_s']:.2f} s "
        f"({inst['spa_n']} rows) + the rest; device time of phase 1 "
        f"{inst.get('device_s', 0.0):.3f} s; payloads {json.dumps(pay)}; "
        f"launches B5 {counts['decode_codes']}, B4 "
        f"{counts['indicator_dot']}, B3 {counts['indicator_dot_2bit']}; "
        f"{int(np.isfinite(tab['pval']).sum())} finite p, min "
        f"{np.nanmin(tab['pval']):.3e}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # burden and ACAT-V over the first units against ACAT-O's columns
    t0 = time.perf_counter()
    first = shard_units(units, 0, N_UNITS_RUN // AGG_SUB)
    worst_sub = 0.0
    for fn, tag in ((assoc_burden, "pval.b"), (assoc_acat_v, "pval.v")):
        sub = fn(gds, model, first, cfg, device="cuda")
        for c in (c for c in sub if c.startswith(tag)):
            worst_sub = max(worst_sub, max_rel(sub[c], tab[c][:AGG_SUB], c))
    if worst_sub > RTOL_AGG:
        raise AssertionError(f"burden/ACAT-V vs ACAT-O: relative error "
                             f"{worst_sub:.3e} > {RTOL_AGG}")
    log(f"burden and ACAT-V on the card, first {AGG_SUB} units: ACAT-O's "
        f"columns within {worst_sub:.3e} (limit {RTOL_AGG}), "
        f"{time.perf_counter() - t0:.1f} s")

    # the first units on the CPU
    t0 = time.perf_counter()
    cpu = assoc_acat_o(gds, model,
                       shard_units(units, 0, N_UNITS_RUN // AGG_CPU), cfg,
                       device="cpu")
    if not np.array_equal(cpu["numvar"], tab["numvar"][:AGG_CPU]):
        raise AssertionError("numvar differs between card and CPU")
    worst_cpu = max(max_rel(tab[c][:AGG_CPU], cpu[c], c) for c in pcols)
    if worst_cpu > RTOL:
        raise AssertionError(f"ACAT-O card vs CPU: relative error "
                             f"{worst_cpu:.3e} > {RTOL}")
    log(f"first {AGG_CPU} units on the CPU: every p-value column within "
        f"{worst_cpu:.3e} of the card (limit {RTOL}), "
        f"{time.perf_counter() - t0:.1f} s")
    return dict(launches=counts, wall=wall, gds=gds, units=units)


def quant_burden(model, gds: str, units) -> dict:
    """Phase 10: the burden test of the quantitative model over the
    aggregate phase's GDS and units on the card (B5 once per sparse
    payload, no row to SPA), its first units on the CPU, and ACAT-O
    refusing the model."""
    import torch
    from saigegds_tpu_torch import (AggregateConfig, assoc_acat_o,
                                    assoc_burden, shard_units)

    cfg = AggregateConfig()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    inst = {}
    t0 = time.perf_counter()
    tab = assoc_burden(gds, model, units, cfg, instrument=inst,
                       device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    pay = inst["payloads"]
    counts = expect_launches("the quantitative burden test", {
        "decode_codes": pay.get("burden_sparse", 0),
        "slice_i8": packed_model_builds(pay)})
    if not counts["decode_codes"]:
        raise AssertionError(f"B5 never launched: payloads {pay}")
    if inst.get("spa_n") or any(c.startswith(("p.norm", "cvg"))
                                for c in tab):
        raise AssertionError("a quantitative burden row went to SPA, or "
                             "the table has p.norm / cvg columns")
    pcols = [c for c in tab if c.startswith("pval")]
    for c in pcols:
        p = tab[c][np.isfinite(tab[c])]
        if not (len(p) and np.all((p >= 0) & (p <= 1))):
            raise AssertionError(f"{c}: no finite p-value, or outside [0, 1]")
    spans = {k: round(inst.get(k, 0.0), 3)
             for k in ("fetch_s", "tally_s", "encode_s", "upload_s",
                       "wait_s")}
    log(f"quantitative burden on the card: {len(units)} units, {wall:.2f} s "
        f"wall; "
        f"spans {json.dumps(spans)}, device time of phase 1 "
        f"{inst.get('device_s', 0.0):.3f} s; payloads {json.dumps(pay)}; "
        f"launches B5 {counts['decode_codes']}, B4 "
        f"{counts['indicator_dot']}, B3 {counts['indicator_dot_2bit']}; "
        f"{int(np.isfinite(tab['pval.b1_1']).sum())} finite p, min "
        f"{np.nanmin(tab['pval.b1_1']):.3e}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    t0 = time.perf_counter()
    first = shard_units(units, 0, N_UNITS_RUN // AGG_CPU)
    cpu = assoc_burden(gds, model, first, cfg, device="cpu")
    if not np.array_equal(cpu["numvar"], tab["numvar"][:AGG_CPU]):
        raise AssertionError("numvar differs between card and CPU")
    worst = max(max_rel(tab[c][:AGG_CPU], cpu[c], c) for c in pcols)
    if worst > RTOL:
        raise AssertionError(f"quantitative burden card vs CPU: relative "
                             f"error {worst:.3e} > {RTOL}")
    log(f"first {AGG_CPU} units on the CPU: every p-value column within "
        f"{worst:.3e} of the card (limit {RTOL}), "
        f"{time.perf_counter() - t0:.1f} s")
    try:
        assoc_acat_o(gds, model, first, cfg, device="cuda")
    except NotImplementedError as e:
        log(f"ACAT-O on the quantitative model raises NotImplementedError "
            f"({e})")
    else:
        raise AssertionError("ACAT-O accepted a quantitative model")
    return dict(launches=counts, wall=wall)


def dense_phase1_ms(model, ds: np.ndarray, device) -> dict:
    """The dense phase 1 of one DS_BLOCK block of dosages (model order) on
    the card, by CUDA events, beside its bound: the block's f64 bytes and
    the model's vectors read once at the device memory rate, against its
    f64 operations (the imputation, the covariate projection of 4K + 12
    per entry, the score and variance sums) at the FP64 peak."""
    import torch
    from saigegds_tpu_torch.ops.score import ScanParams, score_stats_binary

    sm = model.scan_model(device=device)
    params = ScanParams(maf=-1.0, mac=10.0, missing=0.1, spa_pval=0.05)
    G = torch.as_tensor(ds[:DS_BLOCK], device=device)
    run = lambda: score_stats_binary(sm, params, G)
    run()
    ms = median_ms(run, 5)
    B, N = G.shape
    K = sm.XV.shape[0]
    nbytes = B * N * 8 + (2 + 2 * K) * N * 8
    ops = B * N * (4 * K + 12)
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, ops / F64_OPS_S * 1e3
    out = dict(ms=ms, bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations")
    log(f"dense phase 1, one block of {B} dosage rows x {N} samples (f64, "
        f"K = {K}): {ms:.3f} ms (median of 5, CUDA events), bound "
        f"{out['bound_ms']:.3f} ms by {out['bound_by']} ({nbytes / 1e9:.3f} "
        f"GB at 3.35 TB/s, {ops / 1e9:.2f} GFLOP at 34 TFLOP/s), "
        f"{out['bound_ms'] / ms * 100:.1f}% of the bound")
    del G
    return out


def ds_scan(y: np.ndarray, sample_id: np.ndarray, model, model_q,
            work: str, device) -> dict:
    """Phase 11: the scans of an imputed DS node at full width, on the
    card and (first block) on the CPU."""
    import torch
    from saigegds_tpu_torch.io.gds_write import write_dosage_gds

    t0 = time.perf_counter()
    ds = make_dosages(make_data(y, N_DS, device, SEED + 6, n_assoc=DS_ASSOC),
                      device, SEED + 7)
    ds_x, ids = with_extra_samples(ds, sample_id, SEED + 8)
    gds = os.path.join(work, "dosage.gds")
    write_dosage_gds(gds, ds_x, sample_id=ids, compress="ZIP_ra")
    del ds_x
    head = ds[:, :4096]
    frac = np.mean(np.any(np.isfinite(head) & (head != np.floor(head)),
                          axis=1))
    log(f"DS setup: {N_DS} imputed variants x {len(ids)} samples "
        f"({N_SAMPLES} in the model, {N_EXTRA} outside it at shuffled "
        f"positions), {np.isnan(ds).mean() * 100:.2f}% missing, "
        f"{frac * 100:.0f}% of the variants fractional, variants "
        f"{DS_TYPED[0]}-{DS_TYPED[1] - 1} typed; GDS "
        f"{os.path.getsize(gds) / 1e6:.0f} MB, "
        f"{time.perf_counter() - t0:.1f} s")
    phase1 = dense_phase1_ms(model, ds, device)

    mask = np.zeros(N_DS, bool)
    mask[:DS_BLOCK] = True
    n_blocks = N_DS // DS_BLOCK
    tables = {}
    for name, m in (("binary", model), ("quantitative", model_q)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        with phase1_payloads() as shipped:
            tab, inst, wall = scan(gds, m, "cuda", block=DS_BLOCK)
        expect_launches(f"the DS scan ({name})", {})
        peak = torch.cuda.max_memory_allocated() / 2**30
        check_table(tab)
        if name == "binary":
            refined = int(np.sum(tab["pval"] != tab["p.norm"]))
            if inst["spa_n"] == 0 or refined == 0:
                raise AssertionError("no DS variant went through SPA")
        elif inst["spa_n"] or "p.norm" in tab:
            raise AssertionError("a quantitative DS variant went to SPA")
        if len(inst["gather_s"]) != n_blocks:
            raise AssertionError("the DS scan did not gather every block")
        if len(shipped) != n_blocks:
            raise AssertionError("the DS scan did not upload every block")
        stages = {k: round(float(np.sum(inst[k])), 3)
                  for k in ("decode_s", "gather_s")}
        f32 = sum(b == DS_BLOCK * N_SAMPLES * 4 for b in shipped)
        log(f"DS scan on the card ({name}): {len(tab['pval'])} of {N_DS} "
            f"variants tested, {inst['spa_n']} through SPA, min p "
            f"{tab['pval'].min():.3e}, {wall:.2f} s wall, "
            f"{N_DS / wall:.1f} variants/s; {f32} of {n_blocks} blocks "
            f"shipped f32, {sum(shipped) / 1e9:.2f} GB in all; peak "
            f"device memory {peak:.2f} GiB")
        log(f"  stage sums (s, stages overlap): {json.dumps(stages)}, "
            f"spa_s {inst['spa_s']:.3f}; per block: decode "
            f"{stages['decode_s'] / n_blocks:.3f} s, sample gather "
            f"{stages['gather_s'] / n_blocks:.3f} s")
        cpu, _, wall_cpu = scan(gds, m, "cpu", variant_mask=mask & (
            np.arange(N_DS) < DS_CPU_ROWS), block=DS_BLOCK)
        worst = compare_dense(tab, cpu, RTOL)
        log(f"first DS block's first {DS_CPU_ROWS} variants on the CPU "
            f"({name}): {len(cpu['pval'])} rows "
            f"within {worst:.3e} of the card (limit {RTOL}), the same NaN "
            f"pattern and SPA set, {wall_cpu:.1f} s")
        tables[name] = dict(tab=tab, wall=wall, stages=stages,
                            spa_s=inst["spa_s"], peak_gib=peak)
    # the first block alone on the card, for assoc_spa_user (phase 12):
    # SPA batches the flagged rows of the whole scan, so a row of the
    # whole scan and of a scan of its block differ in the last bits
    tables["binary"]["first"], _, _ = scan(gds, model, "cuda",
                                           variant_mask=mask, block=DS_BLOCK)
    return dict(gds=gds, first=ds[:DS_BLOCK].copy(), tables=tables,
                phase1=phase1)


def dense_vs_packed(gds7: str, tab7: dict, model, ds: dict):
    """Phase 12: the dense route over phase 7's hard calls against phase
    7's packed table; assoc_spa_user against the DS scan."""
    from saigegds_tpu_torch import ScanConfig, assoc_spa_user

    import torch
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    mask = np.zeros(N_VARIANTS, bool)
    mask[:N_ALT] = True
    with phase1_payloads() as shipped:
        tab, inst, wall = scan(gds7, model, "cuda", dsnode="$dosage_alt",
                               variant_mask=mask)
    expect_launches("the $dosage_alt scan", {})
    peak = torch.cuda.max_memory_allocated() / 2**30
    # phase 7's GDS numbers its variants 1..N_VARIANTS
    if not np.array_equal(tab["id"], tab7["id"][tab7["id"] <= N_ALT]):
        raise AssertionError("$dosage_alt and the packed route tested "
                             "different variants")
    worst = compare_dense(tab7, tab, RTOL)
    log(f"$dosage_alt scan of phase 7's first {N_ALT} variants on the card: "
        f"{len(tab['id'])} variants, {inst['spa_n']} through SPA, "
        f"{wall:.2f} s wall ({N_ALT / wall:.1f} variants/s, decode "
        f"{np.sum(inst['decode_s']):.2f} s, sample gather "
        f"{np.sum(inst['gather_s']):.2f} s, SPA {inst['spa_s']:.2f} s), "
        f"{sum(b == BLOCK * N_SAMPLES * 4 for b in shipped)} of "
        f"{len(shipped)} blocks shipped f32; peak device memory "
        f"{peak:.2f} GiB; the packed table within {worst:.3e} (limit "
        f"{RTOL}), the same SPA set")

    first = ds["first"]
    want = dict(ds["tables"]["binary"]["first"])
    t0 = time.perf_counter()
    reset_launches()
    got = assoc_spa_user(lambda a, b: first[a:b], DS_BLOCK, model,
                         ScanConfig(block_size=DS_BLOCK), device="cuda")
    expect_launches("assoc_spa_user", {})
    for c in ("chr", "pos", "rs.id", "ref", "alt"):
        del want[c]
    worst_u = compare_dense(got, want, RTOL_USER)
    log(f"assoc_spa_user over the first {DS_BLOCK} dosages from a numpy "
        f"callback: {len(got['id'])} rows within {worst_u:.3e} of the DS "
        f"scan of the same variants (limit {RTOL_USER}), "
        f"{time.perf_counter() - t0:.1f} s")


def ds_gene_tests(gds: str, model, model_q):
    """Phase 13: ACAT-O (binary) and the burden test (quantitative) over DS
    units on the card, the first units on the CPU."""
    import torch
    from saigegds_tpu_torch import (AggregateConfig, assoc_acat_o,
                                    assoc_burden, shard_units,
                                    units_from_groups)
    from saigegds_tpu_torch.io.seqarray import SeqData

    groups = {f"ds{u:02d}": list(range(u * DS_UNIT + 1, (u + 1) * DS_UNIT + 1))
              for u in range(DS_UNITS)}
    units = units_from_groups(SeqData(gds), groups)
    cfg = AggregateConfig()
    out = {}
    for fn, m, name in ((assoc_acat_o, model, "ACAT-O"),
                        (assoc_burden, model_q, "quantitative burden")):
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        inst = {}
        t0 = time.perf_counter()
        tab = fn(gds, m, units, cfg, instrument=inst, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        pay = inst["payloads"]
        counts = expect_launches(f"{name} over DS units", {
            "decode_codes": pay.get("single_sparse", 0),
            "indicator_dot": pay.get("single_sparse", 0),
            "indicator_dot_2bit": pay.get("single_2bit", 0),
            "slice_i8": packed_model_builds(pay)})
        if name == "ACAT-O" and not (inst.get("rows_packed")
                                     and sum(counts.values())):
            raise AssertionError(f"no DS row went the packed way: {pay}")
        pcols = [c for c in tab if c.startswith("pval")]
        for c in pcols:
            p = tab[c][np.isfinite(tab[c])]
            if not (len(p) and np.all((p >= 0) & (p <= 1))):
                raise AssertionError(f"{c}: no finite p-value, or outside "
                                     f"[0, 1]")
        spans = {k: round(inst.get(k, 0.0), 3)
                 for k in ("fetch_s", "tally_s", "encode_s", "upload_s",
                           "wait_s", "spa_s")}
        log(f"{name} over {len(units)} DS units on the card: {wall:.2f} s "
            f"wall; rows packed {inst.get('rows_packed', 0)}, dense "
            f"{inst.get('rows_dense', 0)}; payloads {json.dumps(pay)}; "
            f"launches B5 {counts['decode_codes']}, B4 "
            f"{counts['indicator_dot']}, B3 {counts['indicator_dot_2bit']}; "
            f"spans {json.dumps(spans)}, {inst.get('spa_n', 0)} rows through "
            f"SPA, device time of phase 1 {inst.get('device_s', 0.0):.3f} s; "
            f"peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        t0 = time.perf_counter()
        cpu = fn(gds, m, shard_units(units, 0, DS_UNITS // DS_CPU_UNITS),
                 cfg, device="cpu")
        worst = max(max_rel(tab[c][:DS_CPU_UNITS], cpu[c], c) for c in pcols)
        if worst > RTOL:
            raise AssertionError(f"{name} over DS units card vs CPU: "
                                 f"relative error {worst:.3e} > {RTOL}")
        log(f"first {DS_CPU_UNITS} DS units on the CPU: every p-value column "
            f"within {worst:.3e} of the card (limit {RTOL}), "
            f"{time.perf_counter() - t0:.1f} s")
        out[name] = dict(wall=wall, launches=counts,
                         rows_packed=inst.get("rows_packed", 0),
                         rows_dense=inst.get("rows_dense", 0))
    return out


def r_files(model, gds7: str, work: str):
    """Phase 14: the model through .rds and .rda, and a table through
    .rds."""
    from saigegds_tpu_torch import NullModel, save_assoc
    from saigegds_tpu_torch.io.rds import read_rds, strip

    mask = np.zeros(N_VARIANTS, bool)
    mask[:BLOCK] = True
    want, _, _ = scan(gds7, model, "cuda", variant_mask=mask)
    for ext in (".rds", ".rda"):
        path = os.path.join(work, "model" + ext)
        t0 = time.perf_counter()
        model.save(path)
        t1 = time.perf_counter()
        back = NullModel.load(path)
        t2 = time.perf_counter()
        reset_launches()
        got, _, _ = scan(gds7, back, "cuda", variant_mask=mask)
        expect_launches(f"the scan from the {ext} model",
                        {"indicator_dot_2bit": 1, "gather_2bit": 1,
                         "slice_i8": 1})
        for c in want:
            if not np.array_equal(got[c], want[c]):
                raise AssertionError(f"the scan from the {ext} model "
                                     f"differs in column {c}")
        log(f"model {ext}: {os.path.getsize(path) / 1e6:.1f} MB, saved in "
            f"{t1 - t0:.1f} s, loaded in {t2 - t1:.1f} s; the scan of phase "
            f"7's first block from it equals the in-memory model's bit for "
            f"bit")
    path = os.path.join(work, "scan.rds")
    save_assoc(want, path)
    obj = read_rds(path)
    for c in want:
        if not np.array_equal(np.asarray(strip(obj[c])), want[c]):
            raise AssertionError(f"scan.rds column {c} differs")
    log(f"scan table .rds ({len(want['id'])} rows, "
        f"{os.path.getsize(path) / 1e3:.0f} kB) reads back equal")


def fit_options(work: str, device, gds_s: str, data_s: dict,
                small: tuple):
    """Phase 15: MAC-categorized variance ratios and a resumed fit at the
    small fit's size."""
    from saigegds_tpu_torch.io.gds_write import write_seqarray_gds
    from saigegds_tpu_torch.models import fitnull

    n_s, m_s = FIT_SMALL
    codes_c, data_c = make_fit_data(n_s, m_s, device, SEED + 9,
                                    rare_share=RARE_SHARE)
    gds_c = os.path.join(work, "fit_cat.gds")
    write_seqarray_gds(gds_c, codes_c)
    m_gpu, inst_gpu = fit(gds_c, data_c, "cuda", maf=0.0,
                          var_ratio_mac_cat=CAT_EDGES)
    m_cpu, inst_cpu = fit(gds_c, data_c, "cpu", maf=0.0,
                          var_ratio_mac_cat=CAT_EDGES)
    worst = compare_fits(m_gpu, m_cpu, inst_gpu, inst_cpu)
    cat = m_cpu.var_ratio["mac_cat"]
    if not np.array_equal(m_gpu.var_ratio["mac_cat"], cat):
        raise AssertionError("MAC categories differ between card and CPU")
    per_cat = np.bincount(np.asarray(cat, int), minlength=len(CAT_EDGES) + 1)
    if not per_cat.all():
        raise AssertionError(f"an empty MAC category: {per_cat.tolist()}")
    log(f"MAC-categorized fit ({n_s} x {m_s}, edges {list(CAT_EDGES)}): "
        f"markers per category {per_cat.tolist()}, the same on both; card "
        f"vs CPU max relative error {worst:.3e} (limit {RTOL_FIT}); "
        f"{inst_gpu['wall_s']:.1f} s on the card, {inst_cpu['wall_s']:.1f} s "
        f"on the CPU")

    class Crash(RuntimeError):
        pass

    ck = os.path.join(work, "ck_small")
    real = fitnull._fit_tau_binary
    calls = [0]

    def crash(*a, **k):
        calls[0] += 1
        if calls[0] == 2:
            raise Crash("outer iteration 2")
        return real(*a, **k)

    fitnull._fit_tau_binary = crash
    try:
        fit(gds_s, data_s, "cuda", checkpoint=ck)
    except Crash:
        pass
    else:
        raise AssertionError("the wrapped fit did not crash")
    finally:
        fitnull._fit_tau_binary = real
    if not os.path.exists(ck + ".fit.npz"):
        raise AssertionError("no checkpoint after outer iteration 1")
    m_res, inst_res = fit(gds_s, data_s, "cuda", checkpoint=ck)
    m_ref, inst_ref = small
    # the resumed run counts only the products it ran itself
    same_fit("the resumed fit", m_res, inst_res, m_ref, inst_ref,
             counts=("outer_iterations",))
    left = [f for f in os.listdir(work) if f.startswith("ck_small")]
    if left:
        raise AssertionError(f"checkpoint files left: {left}")
    log(f"fit killed in outer iteration 2 and resumed on the card: equal to "
        f"the uninterrupted card fit bit for bit (tau, coefficients, fitted "
        f"values, variance ratios, markers; {inst_res['outer_iterations']} "
        f"outer iterations on both), checkpoint files removed; resume "
        f"{inst_res['wall_s']:.1f} s")


def phewas_lanes(n: int, K: int, nrun: int, op_bytes: int,
                 device) -> int:
    """The least P that ``fit_device._lane_groups`` splits into two groups
    or more for a binary PheWAS fit on this card, reckoned before the fit:
    the free memory now less the ``op_bytes`` its ingest adds (the store,
    its pair lists and vectors).  The fitter sees less free memory (the
    design, the probe pool and its products come out of it too), so its
    groups for this P are two or more."""
    import torch
    from saigegds_tpu_torch.models import fit_device as fd
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info(device)[0] - op_bytes
    return fd._group_budget(free, n) // fd._lane_bytes(
        n, K, 1 + max(K, nrun)) + 1


def op_bytes(op) -> int:
    """Device bytes of a fit's operator: the store, its missing-pair lists
    and its vectors."""
    return op.packed.numel() + op.miss.nbytes + 8 * (
        op.af.numel() + op.inv.numel() + op.diag.numel())


def var_ratio_lanes(vr: tuple, L: int):
    """``calc_var_ratio_multi`` over ``L`` lanes: those of the PheWAS fit
    whose arguments ``vr`` holds, repeated in turn; its rows."""
    from saigegds_tpu_torch.models import fitnull
    args, kw = vr
    grm, codes, fit0s, glmms, noks = args[:5]
    pick = lambda xs: [xs[i % len(xs)] for i in range(L)]
    return fitnull.calc_var_ratio_multi(grm, codes, pick(fit0s),
                                        pick(glmms), pick(noks), *args[5:],
                                        **kw)


def peak_of(device, fn) -> tuple:
    """``fn()`` with the device's peaks reset first: its result, the peak
    allocated beyond what was allocated before, the peak reserved, the
    free bytes at entry and the seconds."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info(device)[0]
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, torch.cuda.max_memory_allocated(device) - base,
            torch.cuda.max_memory_reserved(device), free,
            time.perf_counter() - t0)


def lane_bytes_on_card(op, K: int, device, vr: tuple,
                       lanes=(2, 4, 6)) -> dict:
    """The device bytes a lane adds, measured on ``op`` (the PheWAS fit's
    operator at full width) for both fitters and the variance-ratio pass:
    the peak allocated at each count of ``lanes`` over a fit that stops
    after its first AI-REML stage (``maxiter=0``, three PCG iterations a
    solve, two IRLS steps), or over the PheWAS fit's variance-ratio pass
    (``vr``, its arguments; its lanes repeated in turn); the slope
    between each two beside the group rule's reckoning of the same slope,
    ``fit_device._lane_bytes`` of the widest stacked solve plus the change
    in the product's slice padding (``kernel_cols``: 8 B a padded column
    at the product's peak, which the rule reserves whole).  One lane is
    not measured: its stacked right-hand sides are a view, not a copy."""
    import torch
    from saigegds_tpu_torch.models import fit_device as fd, fitnull
    from saigegds_tpu_torch.ops.packed_grm import N_SLICES, kernel_cols
    n = op.n_samples
    gen = torch.Generator(device=device).manual_seed(SEED + 9)
    f64 = dict(dtype=torch.float64, device=device)
    X = torch.cat([torch.ones(n, 1, **f64),
                   torch.randn(n, K - 1, generator=gen, **f64)], dim=1)
    U = torch.randint(0, 2, (n, 60), generator=gen, device=device).to(
        torch.float64) * 2 - 1
    cfg = vr[0][5]
    out = {}
    for trait, cols in (("binary", 1 + max(K, 30)),
                        ("quantitative", 1 + K + 30),
                        ("variance ratio", fitnull._var_ratio_cols(cfg, K))):
        peaks = {}
        for L in lanes:
            tau = torch.tensor([[1.0, 0.5]] * L, **f64)
            if trait == "binary":
                Y = (torch.rand(L, n, generator=gen, **f64) < 0.3).double()
                eta = torch.zeros(L, n, **f64)
                run = lambda: fd.fit_glmm_binary_device_multi(
                    op, Y, X, tau, eta, U, 0.02, 1e-5, maxiter=0,
                    maxiter_pcg=3, maxiter_coef=2)
            elif trait == "quantitative":
                Y = torch.randn(L, n, generator=gen, **f64)
                run = lambda: fd.fit_glmm_quant_device_multi(
                    op, Y, X, tau, U, 0.02, 1e-5, maxiter=0, maxiter_pcg=3)
            else:
                run = lambda: var_ratio_lanes(vr, L)
            got, peaks[L], *_ = peak_of(device, run)
            del got
        pad = lambda L: kernel_cols(L * cols) - N_SLICES * L * cols
        out[trait] = dict(cols=cols, peaks=peaks, slopes=[dict(
            lanes=(lo, hi), measured=(peaks[hi] - peaks[lo]) // (hi - lo),
            reckoned=fd._lane_bytes(n, K, cols)
            + n * (pad(hi) - pad(lo)) * 8 // (hi - lo))
            for lo, hi in zip(lanes, lanes[1:])])
    return out


def edge_groups_on_card(op, K: int, device, vr: tuple) -> dict:
    """The largest group the rule allows now over ``op`` (the PheWAS fit's
    operator at full width), run as one group with the lanes' phenotypes
    and starts on the host, as the PheWAS fit keeps them: the binary
    fitter (random phenotypes at 30% cases) and the quantitative one (one
    random phenotype in every lane) through their first outer iteration
    with real solves, and the variance-ratio pass (``vr``: the PheWAS
    fit's arguments, its lanes repeated in turn) whole; each with its
    peak allocated and reserved beside the free memory at entry.  The
    lanes are counted from the free memory less what a fitter allocates
    before its rule reads it (the probe pool's products)."""
    import torch
    from saigegds_tpu_torch.models import fit_device as fd, fitnull
    n, nrun, pool = op.n_samples, 30, 60
    gen = torch.Generator(device=device).manual_seed(SEED + 13)
    f64 = dict(dtype=torch.float64, device=device)
    X = torch.cat([torch.ones(n, 1, **f64),
                   torch.randn(n, K - 1, generator=gen, **f64)], dim=1)
    U = torch.randint(0, 2, (n, pool), generator=gen, device=device).to(
        torch.float64) * 2 - 1
    host = torch.Generator().manual_seed(SEED + 13)
    cfg = vr[0][5]
    out = {}
    for what, cols in (("binary", 1 + max(K, nrun)),
                       ("quantitative", 1 + K + nrun),
                       ("variance ratio", fitnull._var_ratio_cols(cfg, K))):
        torch.cuda.empty_cache()
        free = torch.cuda.mem_get_info(device)[0]
        if what != "variance ratio":
            free -= 8 * n * pool
        L = fd._group_budget(free, n) // fd._lane_bytes(n, K, cols)
        tau = torch.tensor([[1.0, 0.5]] * L, dtype=torch.float64)
        if what == "binary":
            Y = (torch.rand(L, n, generator=host, dtype=torch.float64)
                 < 0.3).double()
            eta = torch.full((L, n), float(np.log(0.3 / 0.7)),
                             dtype=torch.float64)
            run = lambda: fd._binary_multi(op, Y, X, tau, eta, U, 0.02,
                                           1e-5, maxiter=1)
        elif what == "quantitative":
            Y = torch.randn(n, generator=host,
                            dtype=torch.float64).expand(L, n)
            run = lambda: fd._quant_multi(op, Y, X, tau, U, 0.02, 1e-5,
                                          maxiter=1)
        else:
            run = lambda: var_ratio_lanes(vr, L)
        got, alloc, reserved, free_in, secs = peak_of(device, run)
        if what == "variance ratio":
            groups = list(vr[0][0].var_ratio_groups)
            good = all(np.isfinite(r["ratio"]).all() for r in got)
        else:
            groups = list(got.lane_groups)
            good = bool(torch.isfinite(got.tau).all())
        if groups != [L]:
            raise AssertionError(f"the {what} edge group of {L} lanes ran "
                                 f"in groups {groups}")
        if not good:
            raise AssertionError(f"the {what} edge group's results are not "
                                 f"finite")
        out[what] = dict(lanes=int(L), free=free_in, allocated=alloc,
                         reserved=reserved, seconds=secs,
                         planned=int(L) * fd._lane_bytes(n, K, cols))
        del got
    return out


def force_groups(most: int):
    """Replace the group rule by groups of at most ``most`` lanes; returns
    the function that puts it back."""
    from saigegds_tpu_torch.models import fit_device as fd
    real = fd._lane_groups
    fd._lane_groups = lambda P, *a, **k: fd._balanced(P, most)

    def restore():
        fd._lane_groups = real
    return restore


def groups_on_card(gds_s: str, data_s: dict) -> float:
    """The small fit's PheWAS fit (y and the yb phenotypes) on the card with
    the groups forced to 1 and 2 lanes against the rule's one group:
    within RTOL_GROUP, the same iterations, markers and flags."""
    from saigegds_tpu_torch import NullModelConfig, fit_null_glmm_multi
    from saigegds_tpu_torch.models import fit_device as fd
    formulas = [f"{r} ~ x1 + x2 + x3"
                for r in ["y"] + [f"yb{pct}" for pct in PHEWAS_CASES]]
    runs = {}
    for most in (0, 1, 2):
        restore = force_groups(most) if most else (lambda: None)
        inst = {}
        try:
            runs[most] = (fit_null_glmm_multi(formulas, data_s, gds_s,
                                              NullModelConfig(),
                                              instrument=inst,
                                              device="cuda"), inst)
        finally:
            restore()
    one, inst1 = runs[0]
    if inst1["lane_groups"] != [len(formulas)]:
        raise AssertionError(f"the small PheWAS fit ran in groups "
                             f"{inst1['lane_groups']}")
    worst = 0.0
    for most in (1, 2):
        got, inst = runs[most]
        want = [g.stop - g.start
                for g in fd._balanced(len(formulas), most)]
        if inst["lane_groups"] != want or inst["var_ratio_groups"] != want:
            raise AssertionError(f"groups of {most}: {inst['lane_groups']}, "
                                 f"{inst['var_ratio_groups']}")
        if inst["outer_iterations"] != inst1["outer_iterations"]:
            raise AssertionError(f"groups of {most}: outer iterations "
                                 f"{inst['outer_iterations']} against "
                                 f"{inst1['outer_iterations']}")
        for a, b in zip(got, one):
            if a.converged != b.converged or not np.array_equal(
                    a.var_ratio["id"], b.var_ratio["id"]):
                raise AssertionError(f"groups of {most}: converged or "
                                     f"markers differ")
            worst = max([worst] + [max_rel(getattr(a, k), getattr(b, k), k)
                                   for k in ("tau", "coefficients",
                                             "fitted_values")]
                        + [max_rel(a.var_ratio["ratio"],
                                   b.var_ratio["ratio"], "ratio")])
    if worst > RTOL_GROUP:
        raise AssertionError(f"grouped against one group on the card: "
                             f"{worst:.3e} > {RTOL_GROUP}")
    log(f"the small PheWAS fit ({FIT_SMALL[0]} x {FIT_SMALL[1]}, "
        f"{len(formulas)} lanes) on the card in groups of 1 and 2 lanes "
        f"(AI-REML and variance ratios) against one group: max relative "
        f"error {worst:.3e} (limit {RTOL_GROUP}), outer iterations "
        f"{inst1['outer_iterations']} in all three")
    return worst


def one_lane_fits(codes_s: np.ndarray, data_s: dict) -> float:
    """The public one-lane fitters ``fit_glmm_binary_device`` (``y``) and
    ``fit_glmm_quant_device`` (``yq``, standardized) over the small fit's
    2-bit operator on the card and on the CPU: within RTOL_FIT, the same
    iterations and flags."""
    import torch
    from saigegds_tpu_torch import (fit_glmm_binary_device,
                                    fit_glmm_quant_device)
    from saigegds_tpu_torch.models.glm import glm_binomial
    from saigegds_tpu_torch.ops.packed_grm import build_packed2_grm
    n = codes_s.shape[1]
    X = np.column_stack([np.ones(n)] + [data_s[f"x{i}"]
                                        for i in range(1, N_COV + 1)])
    y = data_s["y"]
    eta = glm_binomial(X, y).linear_predictors
    yq = (data_s["yq"] - data_s["yq"].mean()) / data_s["yq"].std()
    U = np.random.default_rng(SEED + 11).choice([-1.0, 1.0], size=(n, 60))
    out = {}
    for dev in ("cuda", "cpu"):
        op = build_packed2_grm(codes_s, device=dev)
        t = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=dev)
        t0 = time.perf_counter()
        b = fit_glmm_binary_device(op, t(y), t(X), t([1.0, 0.5]), t(eta),
                                   t(U), 0.02, 1e-5)
        q = fit_glmm_quant_device(op, t(yq), t(X), t([0.5, 0.5]), t(U),
                                  0.02, 1e-5)
        out[dev] = (b, q, time.perf_counter() - t0)
    worst = 0.0
    for k, (g, c) in enumerate(zip(out["cuda"][:2], out["cpu"][:2])):
        for f in ("iterations", "converged", "trace_capped"):
            if getattr(g, f).item() != getattr(c, f).item():
                raise AssertionError(f"one-lane fit {k}: {f} "
                                     f"{getattr(g, f).item()} on the card, "
                                     f"{getattr(c, f).item()} on the CPU")
        if g.tau.shape != (2,) or g.mu.shape != (n,):
            raise AssertionError(f"one-lane fit {k} has a lane axis")
        worst = max([worst] + [max_rel(getattr(g, f).cpu().numpy(),
                                       getattr(c, f).numpy(), f)
                               for f in ("tau", "coefficients")])
    if worst > RTOL_FIT:
        raise AssertionError(f"one-lane fitters card vs CPU: {worst:.3e} > "
                             f"{RTOL_FIT}")
    b, q, tg = out["cuda"]
    log(f"fit_glmm_binary_device and fit_glmm_quant_device "
        f"({FIT_SMALL[0]} x {FIT_SMALL[1]}): card vs CPU max relative error "
        f"{worst:.3e} (limit {RTOL_FIT}), iterations {int(b.iterations)} "
        f"and {int(q.iterations)} on both, tau {b.tau.tolist()} and "
        f"{q.tau.tolist()}; {tg:.1f} s on the card, {out['cpu'][2]:.1f} s "
        f"on the CPU")
    return worst


def phewas_fit(gds: str, data: dict, one_fit: dict, gds_s: str,
               data_s: dict, codes_s: np.ndarray, op4, device):
    """Phase 16: the PheWAS fit at full width at the least P that the group
    rule splits into two groups or more on this card (P binary lanes over
    one ingest of phase 4's GDS), the bytes a lane adds measured against
    the rule's reckoning; then at the small fit's size the groups forced
    to 1 and 2 lanes on the card, the public one-lane fitters on the card
    and on the CPU, and the quantitative PheWAS fit on both."""
    import torch
    from saigegds_tpu_torch import NullModelConfig, fit_null_glmm_multi
    from saigegds_tpu_torch.models import fitnull

    cfg = NullModelConfig()
    K = N_COV + 1
    P = phewas_lanes(N_SAMPLES, K, cfg.nrun, op_bytes(op4), device)
    base = ["y"] + [f"yb{pct}" for pct in PHEWAS_CASES]
    if P - len(base) > PHEWAS_MORE:
        raise AssertionError(f"the group rule needs P = {P} lanes for two "
                             f"groups here, past the {len(base)} + "
                             f"{PHEWAS_MORE} phenotypes made")
    resps = base + [f"yp{k}" for k in range(max(P - len(base), 0))]
    formulas = [f"{r} ~ {FORMULA.split('~')[1].strip()}" for r in resps]
    ingests, vrs = [], []
    real, real_vr = fitnull._prepare_fit, fitnull.calc_var_ratio_multi

    def counted(*a, **k):
        out = real(*a, **k)
        ingests.append(out["grm"])
        return out

    def kept_vr(*a, **k):
        vrs.append((a, k))
        return real_vr(*a, **k)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    inst = {}
    fitnull._prepare_fit = counted
    fitnull.calc_var_ratio_multi = kept_vr
    t0 = time.perf_counter()
    try:
        models = fit_null_glmm_multi(formulas, data, gds, cfg,
                                     instrument=inst, device=device)
    finally:
        fitnull._prepare_fit = real
        fitnull.calc_var_ratio_multi = real_vr
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    reserved = torch.cuda.max_memory_reserved()
    total = torch.cuda.mem_get_info(device)[1]
    counts = expect_launches("the PheWAS fit", {
        "plane_dot_fwd": inst["matvecs"], "plane_dot_t": inst["matvecs"],
        "slice_i8": 2 * inst["matvecs"]})
    if len(ingests) != 1:
        raise AssertionError(f"the PheWAS fit ingested {len(ingests)} times")
    held_widths("the PheWAS fit", inst["product_widths"])
    if len(inst["lane_groups"]) < 2:
        raise AssertionError(f"the PheWAS fit of {P} lanes ran in one group "
                             f"({inst['lane_groups']})")
    for m in models:
        check_fit(m)
    log(f"PheWAS fit on the card: P = {P} binary phenotypes (the least P "
        f"the group rule splits on this card, reckoned beforehand; case "
        f"fractions {', '.join(f'{data[r].mean():.3f}' for r in resps)}) "
        f"over one ingest, AI-REML in lane groups {inst['lane_groups']}, "
        f"variance ratios in {inst['var_ratio_groups']}; tau_G "
        f"{[round(float(m.tau[1]), 6) for m in models]}, outer iterations "
        f"{inst['outer_iterations']}, {inst['pcg_iterations']} PCG "
        f"iterations, {inst['matvecs']} GRM products (by C: "
        f"{json.dumps(inst['product_widths'])}), B1 launches "
        f"{counts['plane_dot_fwd']}, B2 {counts['plane_dot_t']}; "
        f"{wall:.1f} s wall = ingest {inst['ingest_s']:.1f} + AI-REML "
        f"{inst['aireml_s']:.1f} + variance ratio {inst['var_ratio_s']:.1f} s "
        f"({[len(m.var_ratio['ratio']) for m in models]} markers); peak "
        f"device memory {peak / 2**30:.2f} GiB allocated, "
        f"{reserved / 2**30:.2f} GiB reserved, of the card's "
        f"{total / 2**30:.2f} GiB")
    log(f"  beside phase 4's one fit of y: {one_fit['matvecs']} products "
        f"(by C: {json.dumps(one_fit['product_widths'])}), "
        f"{one_fit['pcg_iterations']} PCG iterations, "
        f"{one_fit['wall_s']:.1f} s wall; {P} fits one by one would take "
        f"about {P * one_fit['matvecs']} products and {P} ingests (phase "
        f"4's counts times {P}; the other {P - 1} single fits are not run)")

    # the bytes a lane adds, on the fit's operator, against the reckoning
    t0 = time.perf_counter()
    ingests_op = ingests.pop()
    vr = vrs.pop()
    lane = lane_bytes_on_card(ingests_op, K, device, vr)
    log(f"bytes a lane adds at N = {N_SAMPLES} (K = {K}), the group rule's "
        f"reckoning against the slope of the card's max_memory_allocated "
        f"(peaks over fits stopped after their first stage, and over the "
        f"PheWAS fit's variance-ratio pass): " + "; ".join(
            f"{t} ({v['cols']} columns a lane; peaks by lanes "
            f"{json.dumps(v['peaks'])} B): " + ", ".join(
                f"{a['lanes'][0]} to {a['lanes'][1]} lanes reckoned "
                f"{a['reckoned']} B, measured {a['measured']} B "
                f"({a['measured'] / a['reckoned']:.4f} of it)"
                for a in v["slopes"]) for t, v in lane.items())
        + f"; {time.perf_counter() - t0:.1f} s")
    for t, v in lane.items():
        for a in v["slopes"]:
            if a["measured"] > a["reckoned"]:
                raise AssertionError(
                    f"the group rule's reckoning of a {t} lane "
                    f"({a['reckoned']} B) is below the card's slope from "
                    f"{a['lanes'][0]} to {a['lanes'][1]} lanes "
                    f"({a['measured']} B)")

    # the largest group the rule allows, on the same operator
    edge = edge_groups_on_card(ingests_op, K, device, vr)
    del ingests_op, vr
    log("the largest group the rule allows now at full width, in one "
        "group (the fitters through their first outer iteration, the "
        "variance-ratio pass whole): " + "; ".join(
            f"{what} {e['lanes']} lanes ({e['planned']} B planned for them) "
            f"in {e['seconds']:.1f} s, peak {e['allocated'] / 2**30:.2f} GiB "
            f"allocated beyond its inputs, {e['reserved'] / 2**30:.2f} GiB "
            f"reserved in all, of {e['free'] / 2**30:.2f} GiB free at entry"
            for what, e in edge.items()))

    # at the small fit's size: groups forced on the card, the one-lane
    # fitters on the card and the CPU
    groups_on_card(gds_s, data_s)
    one_lane_fits(codes_s, data_s)

    # the quantitative PheWAS fit, small, on the card and on the CPU
    quant = ["yq ~ x1 + x2 + x3", "yq2 ~ x1 + x2 + x3"]
    cfg = NullModelConfig(trait_type="quantitative")
    out = {}
    for dev in ("cuda", "cpu"):
        inst_s = {}
        t0 = time.perf_counter()
        ms = fit_null_glmm_multi(quant, data_s, gds_s, cfg,
                                 instrument=inst_s, device=dev)
        out[dev] = (ms, inst_s, time.perf_counter() - t0)
    (gpu, ig, tg), (cpu, ic, tc) = out["cuda"], out["cpu"]
    for k in ("outer_iterations", "pcg_iterations", "matvecs"):
        if ig[k] != ic[k]:
            raise AssertionError(f"quantitative PheWAS fit {k}: {ig[k]} on "
                                 f"the card, {ic[k]} on the CPU")
    worst = 0.0
    for a, b in zip(gpu, cpu):
        check_fit(b)
        if not np.array_equal(a.var_ratio["id"], b.var_ratio["id"]):
            raise AssertionError("quantitative PheWAS markers differ")
        worst = max([worst] + [max_rel(getattr(a, k), getattr(b, k), k)
                               for k in ("tau", "coefficients")]
                    + [max_rel(a.var_ratio["ratio"], b.var_ratio["ratio"],
                               "ratio")])
    if worst > RTOL_FIT:
        raise AssertionError(f"quantitative PheWAS fit card vs CPU: "
                             f"{worst:.3e} > {RTOL_FIT}")
    log(f"quantitative PheWAS fit ({FIT_SMALL[0]} x {FIT_SMALL[1]}, "
        f"{len(quant)} lanes): card vs CPU max relative error {worst:.3e} "
        f"(limit {RTOL_FIT}), outer iterations {ic['outer_iterations']} and "
        f"{ic['pcg_iterations']} PCG iterations on both; {tg:.1f} s on the "
        f"card, {tc:.1f} s on the CPU")
    return models, dict(inst, wall_s=wall, P=P, lane=lane)


def phewas_scan(gds7: str, models: list, model_q, scan7: dict,
                tab8: dict):
    """Phase 17: assoc_spa_multi over phase 7's GDS with the PheWAS lanes
    and phase 6's quantitative model, in one pass of the genotypes."""
    import torch
    from saigegds_tpu_torch import ScanConfig, assoc_spa_multi

    lanes = list(models) + [model_q]
    P = len(lanes)
    n_blocks = -(-N_VARIANTS // BLOCK)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    inst = {}
    t0 = time.perf_counter()
    tabs = assoc_spa_multi(gds7, lanes, ScanConfig(block_size=BLOCK),
                           instrument=inst, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = expect_launches("the PheWAS scan",
                             {"indicator_dot_2bit": P * n_blocks,
                              "gather_2bit": n_blocks, "slice_i8": P})
    if len(inst["decode_s"]) != n_blocks or \
            len(inst["gather_s"]) != n_blocks:
        raise AssertionError("the PheWAS scan did not decode each block "
                             "once")
    for tab in tabs:
        check_table(tab)
        if not np.array_equal(tab["id"], tabs[0]["id"]):
            raise AssertionError("the lanes tested different variants")
    if "p.norm" in tabs[-1] or "converged" in tabs[-1]:
        raise AssertionError("the quantitative lane has p.norm/converged")
    worst_q = compare_tables(tabs[-1], tab8)
    decode = float(np.sum(inst["decode_s"]))
    log(f"PheWAS scan on the card: {P} models ({P - 1} binary, 1 "
        f"quantitative) x {N_VARIANTS} variants in one pass, "
        f"{len(tabs[0]['id'])} tested per model, {inst['spa_n']} rows "
        f"through SPA; {wall:.2f} s wall, {N_VARIANTS * P / wall:.1f} "
        f"variants x models / s against phase 7's "
        f"{N_VARIANTS / scan7['wall']:.1f} variants/s for one model; B3 "
        f"launches {counts['indicator_dot_2bit']} ({P} per block); decode "
        f"{decode:.2f} s for {n_blocks} blocks, phase 7's "
        f"{scan7['decode_s']:.2f} s; the quantitative lane within "
        f"{worst_q:.3e} of phase 8's table (limit {RTOL}); peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    mask = np.zeros(N_VARIANTS, bool)
    mask[:BLOCK] = True
    t0 = time.perf_counter()
    cpu = assoc_spa_multi(gds7, lanes[:1], ScanConfig(block_size=BLOCK),
                          variant_mask=mask & (np.arange(N_VARIANTS)
                                               < CPU_ROWS),
                          device="cpu")[0]
    worst = compare_tables(tabs[0], cpu)
    log(f"lane 0's first {CPU_ROWS} variants on the CPU: "
        f"{len(cpu['pval'])} rows within "
        f"{worst:.3e} of the card's (limit {RTOL}), "
        f"{time.perf_counter() - t0:.1f} s")

    # the first block again on the sparse route: its rare rows ship as the
    # gap-coded stream, which each model decodes (B5) and scores (B4)
    from saigegds_tpu_torch.assoc.single import _match_samples, _packed_parts
    from saigegds_tpu_torch.io.seqarray import SeqData
    seq = SeqData(gds7)
    cols, _ = _match_samples(seq.sample_id, lanes[0].sample_id)
    _, G = next(seq.iter_code_blocks(BLOCK, variant_mask=mask))
    parts = _packed_parts(np.take(G, cols, axis=1))
    del G
    n_sparse = sum(isinstance(pl, tuple) for _, pl in parts)
    n_rows = sum(len(r) for r, pl in parts if isinstance(pl, tuple))
    if not n_sparse:
        raise AssertionError("the first block has no sparse payload")
    reset_launches()
    t0 = time.perf_counter()
    static = assoc_spa_multi(
        gds7, lanes, ScanConfig(block_size=BLOCK, transport_policy="static"),
        variant_mask=mask, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = expect_launches("the PheWAS scan's sparse route", {
        "decode_codes": P * n_sparse, "indicator_dot": P * n_sparse,
        "indicator_dot_2bit": P * (len(parts) - n_sparse), "slice_i8": P})
    worst_s = compare_tables(static[0], cpu)
    worst_l = max(compare_tables(tab, st) for tab, st in zip(tabs, static))
    log(f"the first block on the sparse route (transport_policy=\"static\"), "
        f"{P} models: {n_rows} of {BLOCK} rows in {n_sparse} sparse "
        f"payload(s), {len(parts) - n_sparse} 2-bit; B5 "
        f"{got['decode_codes']}, B4 {got['indicator_dot']}, B3 "
        f"{got['indicator_dot_2bit']} launches; lane 0 within {worst_s:.3e} "
        f"of the CPU's, every lane within {worst_l:.3e} of the 2-bit "
        f"pass (limit {RTOL}), {wall:.1f} s")
    return counts


def gxg_phase(gds_fit: str, gds7: str, tab7: dict, data: dict, gds_s: str,
              data_s: dict):
    """Phase 18: GxG at full width with approximate tau (phase 4's GDS as
    the GRM, cut to its first GXG_M variants, and phase 7's GDS as the
    tested SNPs), batched, and its first pair from the default start;
    then at the small fit's size the batched
    approximate-tau path against the serial one with the GLM screen, and
    full per-pair refits on the card and on the CPU."""
    import torch
    from saigegds_tpu_torch import NullModelConfig, gxg_spa

    # pairs of common variants of phase 7's GDS, past its enriched ones
    af = tab7["AF.alt"]
    common = tab7["id"][(tab7["id"] > N_ASSOC) & (af > 0.1) & (af < 0.9)]
    ids = common[:2 * N_PAIRS]
    pairs = {"snp1": ids[0::2], "snp2": ids[1::2]}
    panel = np.arange(1, GXG_M + 1)
    formula = FORMULA
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    inst = {}
    t0 = time.perf_counter()
    tab = gxg_spa(formula, data, gds_fit, pairs, gds_assoc=gds7,
                  config=NullModelConfig(tau_init=GXG_TAU_INIT),
                  use_approx_tau=True, variant_id=panel, instrument=inst,
                  device="cuda", pair_batch=GXG_BATCH)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = expect_launches("GxG, batched", {
        "plane_dot_fwd": inst["matvecs"], "plane_dot_t": inst["matvecs"],
        "slice_i8": 2 * inst["matvecs"]})
    p = tab["pval"]
    if not (np.isfinite(p).all() and ((p >= 0) & (p <= 1)).all()):
        raise AssertionError("GxG batched: p-values outside [0, 1]")
    if not tab["tau_G"][0] > 0:
        raise AssertionError(f"GxG batched: approximate tau_G "
                             f"{tab['tau_G'][0]} is not positive")
    n = len(p)
    log(f"GxG on the card, batched ({n} pairs, GRM panel {GXG_M} x "
        f"{N_SAMPLES}, tested SNPs from phase 7's GDS, approximate tau "
        f"{tab['tau_G'][0]:.6f}): {wall:.1f} s wall = GRM build "
        f"{inst['ingest_s']:.1f} + base fit {inst['base_fit_s']:.1f} + pairs "
        f"{inst['pairs_s']:.1f} s, {inst['pairs_s'] / n:.3f} s per pair; "
        f"{inst['matvecs']} GRM products, B1 {counts['plane_dot_fwd']}, B2 "
        f"{counts['plane_dot_t']}, {inst['pcg_iterations']} PCG iterations; "
        f"min p {p.min():.3e}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    out = {"batched": (tab, counts)}

    # the default start, as users run it, on the first pair: the
    # approximate tau_G ends at 0 at this panel shape
    reset_launches()
    inst = {}
    t0 = time.perf_counter()
    first = gxg_spa(formula, data, gds_fit,
                    {k: v[:1] for k, v in pairs.items()}, gds_assoc=gds7,
                    use_approx_tau=True, variant_id=panel, instrument=inst,
                    device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    expect_launches("GxG, default start", {"plane_dot_fwd": inst["matvecs"],
                                           "plane_dot_t": inst["matvecs"],
                                           "slice_i8": 2 * inst["matvecs"]})
    p = first["pval"]
    if not (np.isfinite(p).all() and ((p >= 0) & (p <= 1)).all()):
        raise AssertionError("GxG default start: p-value outside [0, 1]")
    log(f"GxG from the default start (1, 0.5), one pair: approximate tau "
        f"{first['tau_G'][0]:.6f} (0 in both packages at N = 4,000, "
        f"tests/test_torch_gxg_start.py), p {p[0]:.6e} against "
        f"{tab['pval'][0]:.6e} from tau_G = {GXG_TAU_INIT[1]}; "
        f"{wall:.1f} s wall = GRM build {inst['ingest_s']:.1f} + base fit "
        f"{inst['base_fit_s']:.1f} + pair {inst['pairs_s']:.1f} s, "
        f"{inst['matvecs']} GRM products")

    # the batched approximate-tau path against the serial one (with the
    # GLM screen), at the small size on the card
    small = {"snp1": [a for a, _ in GXG_SMALL_PAIRS],
             "snp2": [b for _, b in GXG_SMALL_PAIRS]}
    approx = {}
    for name, kw in (("batched", dict(pair_batch=len(GXG_SMALL_PAIRS))),
                     ("serial", dict(glm_threshold=1.0))):
        approx[name] = gxg_spa(formula, data_s, gds_s, small,
                               config=NullModelConfig(tau_init=GXG_TAU_INIT),
                               use_approx_tau=True, device="cuda", **kw)
    batched, serial = approx["batched"], approx["serial"]
    if not np.isfinite(serial["p.glm"]).all():
        raise AssertionError("the GLM screen gave no p-value")
    worst = max(max_rel(batched[c], serial[c], c)
                for c in ("beta", "SE", "pval", "p.norm", "tau_G"))
    if worst > RTOL:
        raise AssertionError(f"GxG batched vs serial: {worst:.3e} > {RTOL}")
    log(f"GxG approximate tau, pair_batch={len(GXG_SMALL_PAIRS)} against the "
        f"serial path (with the GLM screen), {FIT_SMALL[0]} x {FIT_SMALL[1]} "
        f"on the card: max relative error {worst:.3e} (limit {RTOL}), "
        f"tau_G {batched['tau_G'][0]:.6f}")

    # full per-pair refits at the small size, card against CPU
    res = {}
    for dev in ("cuda", "cpu"):
        for pb in (0, len(GXG_SMALL_PAIRS)):
            inst = {}
            t0 = time.perf_counter()
            tab = gxg_spa(formula, data_s, gds_s, small, pair_batch=pb,
                          instrument=inst, device=dev)
            res[dev, pb] = (tab, inst, time.perf_counter() - t0)
    worst = 0.0
    for pb in (0, len(GXG_SMALL_PAIRS)):
        (tg, ig, wg), (tc, ic, wc) = res["cuda", pb], res["cpu", pb]
        for k in ("matvecs", "pcg_iterations"):
            if ig[k] != ic[k]:
                raise AssertionError(f"GxG refits (pair_batch={pb}) {k}: "
                                     f"{ig[k]} on the card, {ic[k]} on the "
                                     f"CPU")
        worst = max([worst] + [max_rel(tg[c], tc[c], c) for c in
                               ("beta", "SE", "pval", "p.norm", "tau_G")])
        log(f"GxG full refits, pair_batch={pb}, {FIT_SMALL[0]} x "
            f"{FIT_SMALL[1]}: {ic['pcg_iterations']} PCG iterations and "
            f"{ic['matvecs']} products on both; {wg:.1f} s on the card "
            f"({ig['pairs_s'] / len(GXG_SMALL_PAIRS):.3f} s per pair), "
            f"{wc:.1f} s on the CPU")
    if worst > RTOL_FIT:
        raise AssertionError(f"GxG refits card vs CPU: {worst:.3e} > "
                             f"{RTOL_FIT}")
    log(f"GxG full refits card vs CPU: max relative error {worst:.3e} "
        f"(limit {RTOL_FIT})")
    return out


def mesh_phase(gds_s: str, data_s: dict, model, op4, gds7: str,
               tab7: dict, scan7: dict, work: str) -> dict:
    """Phase 19: the sample-sharded fit and the variant-sharded scan over a
    mesh of two shards on the one card (``make_mesh(devices=["cuda:0"] *
    2)``): it proves the code path and measures what sharding costs on
    one card, not a speed-up.  The fit runs at the small fit's size (the
    fit across processes of phase 20 keeps the full width); the products
    run at both sizes.  ``model`` and ``op4`` are phase 4's model and GRM
    operator."""
    import torch
    from saigegds_tpu_torch import ScanConfig
    from saigegds_tpu_torch.parallel.distributed import assoc_spa_sharded, \
        merge_shards
    from saigegds_tpu_torch.parallel.mesh import ShardedGrmHandle, make_mesh

    mesh = make_mesh(devices=["cuda:0"] * MESH_SHARDS)
    log(f"mesh {mesh}: {MESH_SHARDS} shards on one card, so what follows "
        f"proves the sharded paths and measures what sharding costs on one "
        f"card, not a speed-up")

    # the sample-sharded fit, through from_streamed_blocks, against the
    # one-store fit of the same streamed build
    kept1, kept = {}, {}
    model1, inst1 = fit(gds_s, data_s, "cuda", keep=kept1, stream_geno=True)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    model_m, inst_m = fit(gds_s, data_s, "cuda", mesh=mesh, keep=kept,
                          stream_geno=True,
                          checkpoint=os.path.join(work, "ck_mesh"))
    h, op_s = kept["grm"], kept1["grm"]
    if not isinstance(h, ShardedGrmHandle):
        raise AssertionError(f"the mesh fit built a {type(h).__name__}")
    expect_launches("the sharded fit", {
        "plane_dot_fwd": MESH_SHARDS * inst_m["matvecs"],
        "plane_dot_t": MESH_SHARDS * inst_m["matvecs"],
        "slice_i8": 2 * inst_m["matvecs"]})
    same_fit("the sharded fit", model_m, inst_m, model1, inst1)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"sharded fit on the card ({FIT_SMALL[0]} x {FIT_SMALL[1]}, "
        f"streamed ingest): equal to the one-store fit bit for bit (tau "
        f"{model_m.tau.tolist()}, coefficients, fitted values, "
        f"{len(model_m.var_ratio['ratio'])} variance ratios; "
        f"{inst_m['outer_iterations']} outer, {inst_m['pcg_iterations']} PCG "
        f"iterations, {inst_m['matvecs']} products on both); "
        f"{inst_m['wall_s']:.1f} s wall against {inst1['wall_s']:.1f} s; "
        f"store bytes per shard {h.store_bytes} (one store "
        f"{op_s.packed.numel()}); peak device memory {peak:.2f} GiB")
    for k in ("af", "inv", "diag"):
        if not torch.equal(getattr(h, k), getattr(op_s, k)):
            raise AssertionError(f"the sharded build's {k} differs")

    # the sharded product: the fit's streamed build, and phase 4's store
    # wrapped into shards at full width
    wrapped = ShardedGrmHandle(op4, mesh)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    prod = {}
    for R in (1, PROFILE_COLS):
        for name, op, one in (("streamed", h, op_s), ("wrapped", wrapped,
                                                      op4)):
            b = torch.randn(one.n_samples, R, dtype=torch.float64,
                            device="cuda", generator=gen)
            b = b[:, 0] if R == 1 else b
            want = one.matvec(b)
            reset_launches()
            got = op.matvec(b)
            expect_launches(f"one sharded product ({name}, R = {R})", {
                "plane_dot_fwd": MESH_SHARDS, "plane_dot_t": MESH_SHARDS,
                "slice_i8": 2})
            if not torch.equal(got, want):
                raise AssertionError(f"sharded product ({name}, R = {R}) "
                                     f"differs from the unsharded one")
        prod[R] = dict(sharded_ms=median_ms(lambda: wrapped.matvec(b), 3),
                       unsharded_ms=median_ms(lambda: op4.matvec(b), 3))
        log(f"GRM product at R = {R}: sharded ({MESH_SHARDS} shards, built "
            f"streamed at the small size and wrapped at full width) equal "
            f"to the unsharded one bit for bit; at full width "
            f"{prod[R]['sharded_ms']:.3f} ms sharded against "
            f"{prod[R]['unsharded_ms']:.3f} ms unsharded (median of 3, CUDA "
            f"events, one card)")
    del wrapped, h, kept, kept1

    # the variant-sharded scan of phase 7's GDS
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    tab, inst, wall = scan(gds7, model, "cuda", mesh=mesh)
    n_blocks = -(-N_VARIANTS // BLOCK)
    expect_launches("the sharded scan",
                    {"indicator_dot_2bit": MESH_SHARDS * n_blocks,
                     "slice_i8": 1})
    for c in tab7:
        if not np.array_equal(tab[c], tab7[c]):
            raise AssertionError(f"sharded scan: column {c} differs from "
                                 f"phase 7's table")
    log(f"sharded scan on the card: phase 7's table bit for bit "
        f"({len(tab['pval'])} rows, {inst['spa_n']} through SPA), B3 "
        f"launched {MESH_SHARDS} times per block; {wall:.2f} s wall, "
        f"{N_VARIANTS / wall:.1f} variants/s against phase 7's "
        f"{N_VARIANTS / scan7['wall']:.1f}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # the variant-range shard API, then the merge
    prefix = os.path.join(work, "shards")
    t0 = time.perf_counter()
    reset_launches()
    for pid in range(2):
        assoc_spa_sharded(gds7, model, prefix, ScanConfig(block_size=BLOCK),
                          process_id=pid, process_count=2, device="cuda")
    merged = merge_shards(prefix)
    t_shards = time.perf_counter() - t0
    for c in tab7:
        if not np.array_equal(merged[c], tab7[c]):
            raise AssertionError(f"merged shards: column {c} differs from "
                                 f"phase 7's table")
    log(f"assoc_spa_sharded, process 0 and 1 of 2, then merge_shards: "
        f"phase 7's table bit for bit ({len(merged['pval'])} rows; B3 "
        f"launches {launches()['indicator_dot_2bit']}); {t_shards:.1f} s")
    return dict(fit_wall=inst_m["wall_s"], peak_gib=peak, product=prod,
                scan_vs=N_VARIANTS / wall)


def run_ranks(work: str, role: str, timeout: float) -> tuple:
    """Start this script as ranks 0 .. DIST_RANKS - 1 of one gloo group
    (``--rank``, ``--role``; see :func:`dist_child`), each writing its
    output to ``_smoke/dist_<role>_<rank>.log``; wait at most ``timeout``
    seconds for all of them, kill any left, and return their exit codes
    and logs."""
    init = f"file://{os.path.join(work, 'rendezvous_' + role)}"
    paths = [os.path.join(work, f"dist_{role}_{r}.log")
             for r in range(DIST_RANKS)]
    files = [open(path, "w") for path in paths]
    procs = []
    try:
        for r, f in enumerate(files):
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--rank", str(r),
                 "--world", str(DIST_RANKS), "--init", init, "--role", role,
                 "--work", work], stdout=f, stderr=subprocess.STDOUT,
                cwd=ROOT))
        deadline = time.monotonic() + timeout
        for p in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"the ranks ({role}) did not end within "
                                     f"{timeout} s") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in files:
            f.close()
    logs = []
    for path in paths:
        with open(path) as f:
            logs.append(f.read())
    return [p.returncode for p in procs], logs


def dist_phase(work: str, data: dict, model, fit4: dict, op4, data_s: dict,
               card: str):
    """Phase 20: the fit across two processes on the one card.  Two ranks
    of a gloo group (NCCL refuses two ranks on one device), each its own
    CUDA context holding one half of the store: phase 4's fit, streamed
    ingest and ``checkpoint=``, and products at R = 1 and 30, all bit for
    bit against phase 4, with B1 and B2 once per product on each rank;
    then phase 5's small fit, whose lead fails in outer iteration 2, which
    must end both ranks non-zero.  ``op4`` is phase 4's GRM operator; the
    ranks read ``fit.gds`` and ``fit_small.gds`` in ``work``."""
    import torch

    np.savez(os.path.join(work, "dist_data.npz"), **data)
    np.savez(os.path.join(work, "dist_small.npz"), **data_s)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    bs, want = {}, {}
    for R in (1, PROFILE_COLS):
        b = torch.randn(N_SAMPLES, R, dtype=torch.float64, device="cuda",
                        generator=gen)
        b = b[:, 0] if R == 1 else b
        want[R] = op4.matvec(b).cpu().numpy()
        bs[f"b{R}"] = b.cpu().numpy()
    np.savez(os.path.join(work, "dist_b.npz"), **bs)
    torch.cuda.empty_cache()
    # the ranks ingest phase 4's GDS at once on this host: hand the memory
    # this process freed in earlier phases back to the system first, the
    # heap that glibc's arenas keep (the threaded decode leaves it there)
    # and the pinned upload buffers that PyTorch caches
    rss = host_rss_gib()
    gc.collect()
    ctypes.CDLL("libc.so.6").malloc_trim(0)
    trimmed = host_rss_gib()
    torch._C._host_emptyCache()
    log(f"host RSS before the ranks start: {rss:.2f} GiB, {trimmed:.2f} "
        f"after malloc_trim, {host_rss_gib():.2f} after emptying the "
        f"pinned-memory cache")

    t0 = time.perf_counter()
    codes, logs = run_ranks(work, "fit", DIST_TIMEOUT_S)
    wall = time.perf_counter() - t0
    for r, text in enumerate(logs):
        for line in text.splitlines():
            log(f"  [rank {r}] {line}")
    if any(codes):
        raise AssertionError(f"the fit across processes: exit codes {codes}")
    res = []
    for r in range(DIST_RANKS):
        with open(os.path.join(work, f"dist_{r}.json")) as f:
            res.append(json.load(f))
    outs = [np.load(os.path.join(work, f"dist_{r}.npz"))
            for r in range(DIST_RANKS)]
    n = fit4["matvecs"]
    for r, (got, arrs) in enumerate(zip(res, outs)):
        for k in ("tau", "coefficients", "fitted_values",
                  "linear_predictors"):
            if not np.array_equal(arrs[k], getattr(model, k)):
                raise AssertionError(f"rank {r}: {k} differs from phase "
                                     f"4's fit")
        for k in ("id", "ratio"):
            if not np.array_equal(arrs["vr_" + k], model.var_ratio[k]):
                raise AssertionError(f"rank {r}: variance-ratio {k} "
                                     f"differs from phase 4's fit")
        for k in ("outer_iterations", "pcg_iterations", "matvecs"):
            if got["inst"][k] != fit4[k]:
                raise AssertionError(f"rank {r}: {k} {got['inst'][k]} "
                                     f"against phase 4's {fit4[k]}")
        # the lead (rank 0) slices each product's operands, twice a product
        want_l = {"plane_dot_fwd": n, "plane_dot_t": n,
                  **({"slice_i8": 2 * n} if r == 0 else {})}
        if {k: v for k, v in got["fit_launches"].items() if v} != want_l:
            raise AssertionError(f"rank {r}: the fit's launches "
                                 f"{got['fit_launches']}, expected {want_l}")
        m = got["products"]
        want_l = {"plane_dot_fwd": m, "plane_dot_t": m,
                  **({"slice_i8": 2 * m} if r == 0 else {})}
        if {k: v for k, v in got["product_launches"].items() if v} \
                != want_l:
            raise AssertionError(f"rank {r}: the products' launches "
                                 f"{got['product_launches']}, expected "
                                 f"{want_l}")
    if res[1]["products"] != res[0]["products"]:
        raise AssertionError("rank 1 served another number of products")
    for R in (1, PROFILE_COLS):
        if not np.array_equal(outs[0][f"p{R}"], want[R]):
            raise AssertionError(f"the product across processes at R = {R} "
                                 f"differs from phase 4's operator's")
    left = [f for f in os.listdir(work) if f.startswith("ck_dist")]
    if left:
        raise AssertionError(f"checkpoint files left: {left}")
    lead, inst = res[0], res[0]["inst"]
    log(f"{card}: the fit across {DIST_RANKS} processes on the one card "
        f"(gloo, staged through host memory): every rank's model equal to "
        f"phase 4's bit for bit (tau {model.tau.tolist()}, coefficients, "
        f"fitted values, {len(model.var_ratio['ratio'])} variance ratios; "
        f"{inst['outer_iterations']} outer, {inst['pcg_iterations']} PCG "
        f"iterations, {n} products, B1 and B2 launched {n} times on each "
        f"rank); checkpoint files removed; the ranks' wall {wall:.1f} s "
        f"(process start included); the lead's fit "
        f"{inst['wall_s']:.1f} s = ingest {inst['ingest_s']:.1f} + AI-REML "
        f"{inst['aireml_s']:.1f} + variance ratio "
        f"{inst['var_ratio_s']:.1f} s against phase 4's "
        f"{fit4['wall_s']:.1f} = {fit4['ingest_s']:.1f} + "
        f"{fit4['aireml_s']:.1f} + {fit4['var_ratio_s']:.1f} s; wire_s "
        f"{inst['wire_s']:.3f} s, wire_bytes {inst['wire_bytes']} "
        f"({inst['wire_bytes'] / n:.0f} per product); rank 1 ingest "
        f"{res[1]['inst']['ingest_s']:.1f} s, serving "
        f"{res[1]['inst']['serve_s']:.1f} s")
    for R in (1, PROFILE_COLS):
        pr = lead["product"][str(R)]
        log(f"{card}: GRM product across {DIST_RANKS} processes at R = {R}: "
            f"phase 4's bit for bit, B1 and B2 once per product on each "
            f"rank; {pr['ms']:.3f} ms (median of {DIST_RUNS}, CUDA events "
            f"on the lead), wire bytes per product {pr['wire_bytes']:.0f}, "
            f"wire_s per product {pr['wire_s'] * 1e3:.3f} ms")
    for r, got in enumerate(res):
        log(f"{card}: rank {r}: store bytes {got['store_bytes']} (phase 4's "
            f"one store {op4.packed.numel()}), peak device memory "
            f"{got['peak_gib']:.2f} GiB (torch.cuda.max_memory_allocated), "
            f"host RSS at its end {got['host_gib']:.2f} GiB")

    t0 = time.perf_counter()
    codes, logs = run_ranks(work, "abort", DIST_ABORT_S)
    took = time.perf_counter() - t0
    if not all(codes):
        raise AssertionError(f"the induced failure: exit codes {codes}, "
                             f"expected both non-zero")
    for r, (text, marker) in enumerate(zip(logs, (
            "induced failure of the lead", "the lead rank aborted the fit"))):
        if marker not in text:
            raise AssertionError(f"rank {r} did not end by the abort: "
                                 f"{text[-2000:]}")
    log(f"induced failure of the lead in outer iteration 2 of the small fit "
        f"({FIT_SMALL[0]} x {FIT_SMALL[1]}) across {DIST_RANKS} processes: "
        f"exit codes {codes}, rank 1 ended by the abort; {took:.1f} s "
        f"(limit {DIST_ABORT_S} s, group timeout {DIST_TIMEOUT_S} s)")
    return dict(wall=wall, inst=inst, products=lead["product"])


def dist_child(argv: list) -> int:
    """A rank of phase 20 (``--rank``, ``--world``, ``--init``,
    ``--role``, ``--work``): role ``fit`` fits phase 4's data over a mesh
    of this process's card and the other ranks', then takes (the lead) or
    serves (the others) the products; role ``abort`` fits the small data,
    and the lead fails in outer iteration 2.  Writes
    ``dist_<rank>.json``/``.npz`` to ``--work``; never prints a result
    line."""
    import argparse
    import torch
    from saigegds_tpu_torch.models import fitnull
    from saigegds_tpu_torch.parallel.distributed import init_distributed
    from saigegds_tpu_torch.parallel.mesh import make_mesh

    ap = argparse.ArgumentParser()
    for k in ("--rank", "--world"):
        ap.add_argument(k, type=int, required=True)
    for k in ("--init", "--role", "--work"):
        ap.add_argument(k, required=True)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("a rank of the fit across processes needs a card")
    init_distributed(a.init, a.world, a.rank, device="cuda",
                     backend="gloo", timeout_s=DIST_TIMEOUT_S)
    mesh = make_mesh(devices=["cuda:0"])
    if not (mesh.spans and mesh.size == a.world):
        raise AssertionError(f"the mesh {mesh} does not span the group")
    lead = a.rank == 0
    log(f"mesh {mesh}")

    if a.role == "abort":
        data_s = dict(np.load(os.path.join(a.work, "dist_small.npz")))
        if lead:
            real, calls = fitnull._fit_tau_binary, [0]

            def failing(*args, **kw):
                calls[0] += 1
                if calls[0] == 2:
                    raise RuntimeError("induced failure of the lead")
                return real(*args, **kw)

            fitnull._fit_tau_binary = failing
        fit(os.path.join(a.work, "fit_small.gds"), data_s, "cuda:0",
            mesh=mesh)
        raise AssertionError("the fit with an induced failure returned")

    data = dict(np.load(os.path.join(a.work, "dist_data.npz")))
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    kept = {}
    model, inst = fit(os.path.join(a.work, "fit.gds"), data, "cuda:0",
                      mesh=mesh, keep=kept,
                      checkpoint=os.path.join(a.work, "ck_dist"))
    h = kept["grm"]
    out = {k: getattr(model, k) for k in ("tau", "coefficients",
                                          "fitted_values",
                                          "linear_predictors")}
    out.update({"vr_" + k: np.asarray(model.var_ratio[k])
                for k in ("id", "ratio")})
    res = dict(rank=a.rank, fit_launches=launches(),
               inst={k: v for k, v in inst.items()
                     if isinstance(v, (int, float))},
               store_bytes=h.store_bytes)
    log(f"fit: {json.dumps(res['inst'])}; launches "
        f"{json.dumps(res['fit_launches'])}")
    reset_launches()
    if lead:
        bs = np.load(os.path.join(a.work, "dist_b.npz"))
        res["product"] = {}
        for R in (1, PROFILE_COLS):
            b = torch.from_numpy(bs[f"b{R}"]).to("cuda:0")
            out[f"p{R}"] = h.matvec(b).cpu().numpy()
            s0, b0 = h.wire.seconds, h.wire.bytes
            ms = median_ms(lambda: h.matvec(b), DIST_RUNS)
            res["product"][R] = dict(
                ms=ms, wire_s=(h.wire.seconds - s0) / DIST_RUNS,
                wire_bytes=(h.wire.bytes - b0) / DIST_RUNS)
        h.wire.stop()
        res["products"] = 2 * (1 + DIST_RUNS)
    else:
        res["products"] = h.serve()
    res["product_launches"] = launches()
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    res["host_gib"] = host_rss_gib()
    log(f"products: {res['products']}, launches "
        f"{json.dumps(res['product_launches'])}")
    np.savez(os.path.join(a.work, f"dist_{a.rank}.npz"), **out)
    with open(os.path.join(a.work, f"dist_{a.rank}.json"), "w") as f:
        json.dump(res, f)
    import torch.distributed as dist
    dist.destroy_process_group()
    return 0


def cli_phase(work: str, gds_s: str, data_s: dict, card: str):
    """Phase 21: ``python -m saigegds_tpu_torch`` with ``--device cuda``
    in subprocesses, those that need no other's output at once: fit
    (--pheno-cols), scan (two --model, the API's models), gxg, merge and
    info on the small fit's data, each output against the API's on the
    card."""
    import csv
    from saigegds_tpu_torch import (NullModel, fit_null_glmm_multi,
                                    gxg_spa, load_pval, assoc_spa_multi)

    pheno = os.path.join(work, "pheno.tsv")
    cols = ["sample.id", "y", "yb20", "x1", "x2", "x3"]
    with open(pheno, "w", newline="") as f:
        w = csv.writer(f, delimiter="\t")
        w.writerow(cols)
        for row in zip(*(data_s[c].tolist() for c in cols)):
            w.writerow([repr(x) if isinstance(x, float) else x
                        for x in row])
    pairs = os.path.join(work, "pairs.tsv")
    with open(pairs, "w") as f:
        f.write("a\tb\n" + "".join(f"{a}\t{b}\n"
                                   for a, b in GXG_SMALL_PAIRS))
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs, walls = {}, {}

    def start(name, *args):
        procs[name] = (subprocess.Popen(
            [sys.executable, "-m", "saigegds_tpu_torch", name, *args,
             "--device", "cuda"], cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True), time.perf_counter())

    def finish(name):
        proc, t0 = procs[name]
        try:
            out, err = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            raise AssertionError(f"CLI {name} did not end within 600 s") \
                from None
        if proc.returncode:
            raise AssertionError(f"CLI {name} failed: {err[-2000:]}")
        walls[name] = time.perf_counter() - t0
        return out

    models = os.path.join(work, "cli_m_{}.npz")
    api_models = os.path.join(work, "api_m_{}.npz")
    shards = os.path.join(work, "cli.part{}.tsv")
    gx = os.path.join(work, "cli_gxg.tsv")
    merged = os.path.join(work, "cli_merged.tsv")
    try:
        # the commands that need no other's output start at once; the
        # scan reads the API's models, the merge the scan's shards
        start("fit", "--formula", FORMULA, "--pheno-cols", "y,yb20",
              "--pheno", pheno, "--gds", gds_s, "--out", models)
        start("gxg", "--formula", FORMULA, "--pheno", pheno, "--gds", gds_s,
              "--pairs", pairs, "--out", gx, "--use-approx-tau",
              "--pair-batch", "4")
        start("info")
        api = fit_null_glmm_multi([FORMULA, FORMULA.replace("y ~", "yb20 ~")],
                                  data_s, gds_s, device="cuda")
        for i, m in enumerate(api):
            m.save(api_models.format(i))
        start("scan", "--gds", gds_s, "--model", api_models.format(0),
              "--model", api_models.format(1), "--out", shards)

        finish("fit")
        worst_fit = 0.0
        for i, m in enumerate(api):
            got = NullModel.load(models.format(i))
            worst_fit = max([worst_fit] + [
                max_rel(getattr(got, k), getattr(m, k), k)
                for k in ("tau", "coefficients")] + [
                max_rel(got.var_ratio["ratio"], m.var_ratio["ratio"],
                        "ratio")])
        if worst_fit > RTOL_FIT:
            raise AssertionError(f"CLI fit vs API: {worst_fit:.3e} > "
                                 f"{RTOL_FIT}")

        want = assoc_spa_multi(gds_s, [api_models.format(0),
                                       api_models.format(1)], device="cuda")
        finish("scan")
        worst_scan = 0.0
        for i in range(2):
            got = load_pval(shards.format(i))
            worst_scan = max([worst_scan] + [
                max_rel(got[c], want[i][c], c)
                for c in ("pval", "p.norm", "beta", "SE")])
        if worst_scan > RTOL:
            raise AssertionError(f"CLI scan vs API: {worst_scan:.3e} > "
                                 f"{RTOL}")
        start("merge", "--prefix", os.path.join(work, "cli"), "--out",
              merged)

        want_g = gxg_spa(FORMULA, data_s, gds_s,
                         {"a": [a for a, _ in GXG_SMALL_PAIRS],
                          "b": [b for _, b in GXG_SMALL_PAIRS]},
                         use_approx_tau=True, pair_batch=4, device="cuda")
        finish("gxg")
        got_g = load_pval(gx)
        worst_gxg = max(max_rel(got_g[c], want_g[c], c)
                        for c in ("beta", "SE", "pval", "p.norm", "tau_G"))
        if worst_gxg > RTOL_FIT:
            raise AssertionError(f"CLI gxg vs API: {worst_gxg:.3e} > "
                                 f"{RTOL_FIT}")

        finish("merge")
        got_m = load_pval(merged)
        want_m = load_pval([shards.format(0), shards.format(1)])
        for c in want_m:
            if not np.array_equal(np.asarray(got_m[c]).astype(str),
                                  np.asarray(want_m[c]).astype(str)):
                raise AssertionError(f"CLI merge: column {c} differs")
        info = finish("info")
        if card.split(",")[0].strip() not in info:
            raise AssertionError(f"CLI info does not name the card: "
                                 f"{info!r}")
    finally:
        for proc, _t0 in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    log(f"CLI (--device cuda, one process each, up to four at once): fit "
        f"--pheno-cols within "
        f"{worst_fit:.3e} of the API's models (limit {RTOL_FIT}), scan with "
        f"two --model within {worst_scan:.3e} (limit {RTOL}), gxg within "
        f"{worst_gxg:.3e} (limit {RTOL_FIT}), merge equal, info "
        f"{info.strip()!r}; wall s {json.dumps({k: round(v, 1) for k, v in walls.items()})}")


def main() -> int:
    import torch
    from saigegds_tpu_torch.ops import _cuda
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
    mark('2. build, one nvcc per source, all at once')
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        list(pool.map(_cuda.load, SOURCES))
    log(f"build: {', '.join(SOURCES)} in {time.perf_counter() - t0:.1f} s")
    for name in SOURCES:
        for line in _cuda.BUILD_LOG.get(name, "").splitlines():
            if "entry function" in line or "registers" in line \
                    or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
        check_build(name)

    # 3. kernels vs plain versions
    mark('3. kernels vs plain versions')
    gen = torch.Generator(device=device).manual_seed(SEED)
    checks = [check_kernel(B, N, C, device, gen)
              for B, N, C in KERNEL_SHAPES]
    grm_checks = [check_grm(random_store(M, N, device, gen), N, C, gen)
                  for M, N, C in GRM_SHAPES]
    store = random_store(M_FIT, N_SAMPLES, device, gen)
    decoded = decoded_store(store)
    grm_checks += [check_grm(store, N_SAMPLES, C, gen, decoded)
                   for C in GRM_WIDTHS]
    del store, decoded
    slice_checks = [check_slice(slice_input(N_SAMPLES, R, device, gen),
                                "row-major") for R in SLICE_COLS]
    slice_checks.append(check_slice(
        slice_input(SLICE_T, N_SAMPLES, device, gen).T, "transposed"))
    torch.cuda.empty_cache()
    b4_checks = [check_b4(B, N, C, device, gen) for B, N, C in B4_SHAPES]
    rare = make_rare_codes(max(B5_ROWS), N_SAMPLES, SEED + 4)
    b5_checks = [check_b5(ragged_stream_codes(SEED), device)] + \
        [check_b5(rare[:rows], device) for rows in B5_ROWS]
    del rare
    gather_checks = [check_gather(*shape, device, gen)
                     for shape in GATHER_SHAPES]
    torch.cuda.empty_cache()

    launch_widths = LaunchWidths()
    work = os.path.join(ROOT, "_smoke")
    os.makedirs(work, exist_ok=True)
    try:
        # 4. the fit at full width
        launch_widths.mark('4. the fit at full width')
        t0 = time.perf_counter()
        codes, data = make_fit_data(N_SAMPLES, M_FIT, device, SEED,
                                    more_phenotypes=PHEWAS_MORE)
        gds_fit = os.path.join(work, "fit.gds")
        write_seqarray_gds(gds_fit, codes, compress="ZIP_ra")
        log(f"fit setup: {M_FIT} GRM variants x {N_SAMPLES} samples, "
            f"{data['y'].mean():.4f} cases, GDS "
            f"{os.path.getsize(gds_fit) / 1e6:.0f} MB, "
            f"{time.perf_counter() - t0:.1f} s")

        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        ck = os.path.join(work, "ck_fit")
        kept4 = {}
        with KernelClock() as clock:
            model, inst = fit(gds_fit, data, "cuda", checkpoint=ck,
                              keep=kept4)
        fit4 = inst
        fit_launches = expect_launches("the fit", {
            "plane_dot_fwd": inst["matvecs"], "plane_dot_t": inst["matvecs"],
            "slice_i8": 2 * inst["matvecs"]})
        check_fit(model)
        if [f for f in os.listdir(work) if f.startswith("ck_fit")]:
            raise AssertionError("the fit left its checkpoint files")
        log(f"fit on the card: tau {model.tau.tolist()}, "
            f"{inst['outer_iterations']} outer iterations, "
            f"{inst['pcg_iterations']} PCG iterations, {inst['matvecs']} GRM "
            f"products, B1 launches {fit_launches['plane_dot_fwd']}, B2 "
            f"launches {fit_launches['plane_dot_t']}; {inst['wall_s']:.1f} s "
            f"wall = ingest {inst['ingest_s']:.1f} + AI-REML "
            f"{inst['aireml_s']:.1f} + variance ratio "
            f"{inst['var_ratio_s']:.1f} s ({len(model.var_ratio['ratio'])} "
            f"markers, mean ratio {model.mean_var_ratio:.4f}), checkpoints "
            f"on and removed after; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        secs = clock.seconds()
        log(f"the fit's GRM products by kernel column count C: "
            f"{json.dumps(inst['product_widths'])}; B1 + B2 device time "
            f"{sum(secs.values()):.3f} s (B1 {secs['plane_dot_fwd']:.3f} s, "
            f"B2 {secs['plane_dot_t']:.3f} s, CUDA events around each "
            f"wrapper call)")
        widths = {int(c): n for c, n in inst["product_widths"].items()}
        by_c = {}
        for C, res in zip(GRM_WIDTHS, grm_checks[len(GRM_SHAPES):]):
            by_c[C] = {"fit_products": widths.get(C, 0), **{
                k: {f: res[k].get(f) for f in ("ms", "bound_ms", "plain_ms",
                                               "library_ms")}
                for k in ("plane_dot_fwd", "plane_dot_t")}}
        log(f"{card}: B1 and B2 by C over the fit's store (phase 3, M = "
            f"{M_FIT}, N = {N_SAMPLES}) beside the fit's products at each C: "
            f"{json.dumps(by_c)}")
        held_widths("the fit", widths)

        profile_product(device, gen)
        trace_scan_block(model, device, gen)

        # 5. the fit held against the CPU
        launch_widths.mark('5. the fit held against the CPU')
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
        small_binary = (m_gpu, inst_gpu)
        log(f"small fit ({n_s} x {m_s}): card vs CPU max relative error "
            f"{worst_fit:.3e} (limit {RTOL_FIT}), tau_G "
            f"{m_cpu.tau[1]:.6f}, {inst_cpu['outer_iterations']} outer and "
            f"{inst_cpu['pcg_iterations']} PCG iterations on both; "
            f"{inst_gpu['wall_s']:.1f} s on the card, "
            f"{inst_cpu['wall_s']:.1f} s on the CPU")

        # 6. the quantitative fit at full width, on the fit phase's GDS
        launch_widths.mark("6. the quantitative fit at full width, on the "
                           "fit phase's GDS")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        model_q, inst_q = fit(gds_fit, data, "cuda", quant=True)
        fitq_launches = expect_launches("the quantitative fit", {
            "plane_dot_fwd": inst_q["matvecs"],
            "plane_dot_t": inst_q["matvecs"],
            "slice_i8": 2 * inst_q["matvecs"]})
        held_widths("the quantitative fit", inst_q["product_widths"])
        check_fit(model_q)
        log(f"quantitative fit on the card: tau {model_q.tau.tolist()}, "
            f"{inst_q['outer_iterations']} outer iterations, "
            f"{inst_q['pcg_iterations']} PCG iterations, "
            f"{inst_q['matvecs']} GRM products, B1 launches "
            f"{fitq_launches['plane_dot_fwd']}, B2 launches "
            f"{fitq_launches['plane_dot_t']}; {inst_q['wall_s']:.1f} s wall "
            f"= ingest {inst_q['ingest_s']:.1f} + AI-REML "
            f"{inst_q['aireml_s']:.1f} + variance ratio "
            f"{inst_q['var_ratio_s']:.1f} s "
            f"({len(model_q.var_ratio['ratio'])} markers, mean ratio "
            f"{model_q.mean_var_ratio:.4f}); peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        m_gpu, inst_gpu = fit(gds_s, data_s, "cuda", quant=True)
        m_cpu, inst_cpu = fit(gds_s, data_s, "cpu", quant=True)
        check_fit(m_cpu)
        worst_fit_q = compare_fits(m_gpu, m_cpu, inst_gpu, inst_cpu)
        log(f"small quantitative fit ({n_s} x {m_s}): card vs CPU max "
            f"relative error {worst_fit_q:.3e} (limit {RTOL_FIT}), tau "
            f"{m_cpu.tau.tolist()}, {inst_cpu['outer_iterations']} outer and "
            f"{inst_cpu['pcg_iterations']} PCG iterations on both; "
            f"{inst_gpu['wall_s']:.1f} s on the card, "
            f"{inst_cpu['wall_s']:.1f} s on the CPU")
        del m_gpu, m_cpu

        # 7. the scan from the fitted model
        launch_widths.mark('7. the scan from the fitted model')
        t0 = time.perf_counter()
        codes, sample_id = with_extra_samples(
            make_data(data["y"], N_VARIANTS, device, SEED), data["sample.id"],
            SEED + 5)
        gds = os.path.join(work, "scan.gds")
        write_seqarray_gds(gds, codes, sample_id=sample_id, compress="ZIP_ra")
        del codes
        log(f"scan setup: {N_VARIANTS} variants x {len(sample_id)} samples "
            f"({N_SAMPLES} in the model, {N_EXTRA} outside it at shuffled "
            f"positions), GDS {os.path.getsize(gds) / 1e6:.0f} MB, "
            f"{time.perf_counter() - t0:.1f} s")

        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        tab, inst, wall = scan(gds, model, "cuda")
        n_blocks = -(-N_VARIANTS // BLOCK)
        scan_launches = expect_launches("the scan",
                                        {"indicator_dot_2bit": n_blocks,
                                         "gather_2bit": n_blocks,
                                         "slice_i8": 1})
        check_table(tab)
        refined = int(np.sum(tab["pval"] != tab["p.norm"]))
        if inst["spa_n"] == 0 or refined == 0:
            raise AssertionError("no variant went through SPA")
        stages = {k: round(float(np.sum(inst[k])), 3)
                  for k in ("decode_s", "gather_s")}
        if len(inst["gather_s"]) != n_blocks:
            raise AssertionError("the scan did not gather the model's "
                                 "samples in every block")
        log(f"scan on the card: {len(tab['pval'])} of {N_VARIANTS} variants "
            f"tested, {inst['spa_n']} through SPA ({refined} changed), "
            f"min p {tab['pval'].min():.3e}, {wall:.2f} s wall, "
            f"{N_VARIANTS / wall:.1f} variants/s, B3 and gather_2bit "
            f"launches {n_blocks} each, "
            f"peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        scan7 = dict(wall=wall, decode_s=stages["decode_s"])
        log(f"  stage sums (s, stages overlap): "
            f"{json.dumps(stages)}, spa_s {inst['spa_s']:.3f}; per block: "
            f"decode {stages['decode_s'] / n_blocks:.3f} s, sample gather "
            f"{stages['gather_s'] / n_blocks:.3f} s (the host's part: the "
            f"launch of gather_2bit)")

        # the first block's first CPU_ROWS variants on the CPU
        mask = np.zeros(N_VARIANTS, bool)
        mask[:BLOCK] = True
        tab_cpu, _, wall_cpu = scan(gds, model, "cpu",
                                    variant_mask=mask & (np.arange(
                                        N_VARIANTS) < CPU_ROWS))
        worst = compare_tables(tab, tab_cpu)
        log(f"first block's first {CPU_ROWS} variants on the CPU: "
            f"{len(tab_cpu['pval'])} rows agree with "
            f"the card's, max relative error {worst:.3e} (limit {RTOL}), "
            f"{wall_cpu:.1f} s")
        # the first block on the card through the int8 route (B4)
        reset_launches()
        tab_i8, _, wall_i8 = scan(gds, model, "cuda", variant_mask=mask,
                                  packed_2bit=False)
        expect_launches("the int8 route", {"indicator_dot": 1,
                                           "slice_i8": 1})
        worst_i8 = compare_tables(tab_i8, tab_cpu)
        log(f"first block on the card, int8 route: one B4 launch, the CPU's "
            f"table within {worst_i8:.3e} (limit {RTOL}), {wall_i8:.1f} s")
        tab7 = tab
        del tab_cpu, tab_i8

        # 8. the scan from the quantitative model
        launch_widths.mark('8. the scan from the quantitative model')
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        tab, inst, wall = scan(gds, model_q, "cuda")
        scanq_launches = expect_launches("the quantitative scan",
                                         {"indicator_dot_2bit": n_blocks,
                                          "gather_2bit": n_blocks,
                                          "slice_i8": 1})
        check_table(tab)
        if inst["spa_n"] or "p.norm" in tab or "converged" in tab:
            raise AssertionError("a quantitative variant went to SPA, or "
                                 "the table has p.norm / converged")
        stages = {k: round(float(np.sum(inst[k])), 3)
                  for k in ("decode_s", "gather_s")}
        log(f"quantitative scan on the card: {len(tab['pval'])} of "
            f"{N_VARIANTS} variants tested, none through SPA, min p "
            f"{tab['pval'].min():.3e}, {wall:.2f} s wall, "
            f"{N_VARIANTS / wall:.1f} variants/s, B3 launches "
            f"{scanq_launches['indicator_dot_2bit']}, peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        log(f"  stage sums (s, stages overlap): {json.dumps(stages)}, "
            f"spa_s {inst['spa_s']:.3f}")
        tab_cpu, _, wall_cpu = scan(gds, model_q, "cpu", variant_mask=mask)
        worst = compare_tables(tab, tab_cpu)
        log(f"first block on the CPU: {len(tab_cpu['pval'])} rows agree with "
            f"the card's, max relative error {worst:.3e} (limit {RTOL}), "
            f"{wall_cpu:.1f} s")
        reset_launches()
        tab_i8, _, wall_i8 = scan(gds, model_q, "cuda", variant_mask=mask,
                                  packed_2bit=False)
        expect_launches("the quantitative int8 route",
                        {"indicator_dot": 1, "slice_i8": 1})
        worst_i8 = compare_tables(tab_i8, tab_cpu)
        log(f"first block on the card, int8 route: one B4 launch, the CPU's "
            f"table within {worst_i8:.3e} (limit {RTOL}), {wall_i8:.1f} s")
        tab8 = tab
        del tab_cpu, tab_i8

        # 9. the aggregate tests from the fitted model
        launch_widths.mark('9. the aggregate tests from the fitted model')
        agg = aggregate(model, data["y"], work)

        # 10. the burden test of the quantitative model
        launch_widths.mark('10. the burden test of the quantitative model')
        quant_burden(model_q, agg["gds"], agg["units"])

        # 11. the scans of imputed dosages
        launch_widths.mark('11. the scans of imputed dosages')
        ds = ds_scan(data["y"], data["sample.id"], model, model_q, work,
                     device)

        # 12. the dense route against the packed route; assoc_spa_user
        launch_widths.mark('12. the dense route against the packed route; '
                           'assoc_spa_user')
        dense_vs_packed(gds, tab7, model, ds)

        # 13. the gene tests over the DS file
        launch_widths.mark('13. the gene tests over the DS file')
        ds_gene_tests(ds["gds"], model, model_q)

        # 14. R files
        launch_widths.mark('14. R files')
        r_files(model, gds, work)

        # 15. fit options at the small fit's size
        launch_widths.mark("15. fit options at the small fit's size")
        fit_options(work, device, gds_s, data_s, small_binary)

        # 16. the PheWAS fit at full width; the small quantitative one
        launch_widths.mark('16. the PheWAS fit at full width; the small '
                           'quantitative one')
        phewas_models, _ = phewas_fit(gds_fit, data, fit4, gds_s, data_s,
                                      codes_s, kept4["grm"], "cuda")

        # 17. the PheWAS scan: the lanes and the quantitative model
        launch_widths.mark('17. the PheWAS scan: the lanes and the '
                           'quantitative model')
        phewas_scan(gds, phewas_models[:len(PHEWAS_CASES) + 1], model_q,
                    scan7, tab8)
        del phewas_models
        del tab8

        # 18. GxG
        launch_widths.mark('18. GxG')
        gxg_phase(gds_fit, gds, tab7, data, gds_s, data_s)

        # 19. the sample-sharded fit and the variant-sharded scan
        launch_widths.mark('19. the sample-sharded fit and the '
                           'variant-sharded scan')
        op4 = kept4.pop("grm")
        mesh_phase(gds_s, data_s, model, op4, gds, tab7, scan7, work)

        # 20. the fit across two processes on the one card
        launch_widths.mark('20. the fit across two processes on the one card')
        dist_phase(work, data, model, fit4, op4, data_s, card)
        del op4

        # 21. the command line
        launch_widths.mark('21. the command line')
        cli_phase(work, gds_s, data_s, card)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    launch_widths.check(
        {f"indicator_dot_2bit C={c['C']}" for c in checks
         if c["N"] == N_SAMPLES} |
        {f"indicator_dot C={c['C']}" for c in b4_checks
         if c["N"] == N_SAMPLES})

    def entry(name, source, line, count, checks, main):
        # line: the TPU kernel replaced (None: the kernel replaces none)
        keys = ("ms", "plain_ms", "bound_ms", "bound_by")
        return dict(name=name, route="cuda",
                    source=f"saigegds_tpu_torch/csrc/{source}.cu",
                    replaces=line, launches=count,
                    max_abs_err=max(c["max_abs_err"] for c in checks),
                    **{k: main[k] for k in keys},
                    library_ms=main.get("library_ms"))

    grm_fwd = [c["plane_dot_fwd"] for c in grm_checks]
    grm_t = [c["plane_dot_t"] for c in grm_checks]
    agg_launches = agg["launches"]
    kernels = [
        entry("plane_dot_fwd", "plane_dot",
              "saigegds_tpu/ops/pallas_grm.py:86",
              fit_launches["plane_dot_fwd"], grm_fwd, grm_fwd[GRM_MAIN]),
        entry("plane_dot_t", "plane_dot",
              "saigegds_tpu/ops/pallas_grm.py:166",
              fit_launches["plane_dot_t"], grm_t, grm_t[GRM_MAIN]),
        entry("slice_i8", "plane_dot", "saigegds_tpu/ops/packed_grm.py:140",
              fit_launches["slice_i8"], slice_checks,
              slice_checks[SLICE_MAIN]),
        entry("indicator_dot_2bit", "indicator_dot_2bit",
              "saigegds_tpu/ops/pallas_score.py:171",
              scan_launches["indicator_dot_2bit"], checks,
              checks[SCAN_MAIN]),
        entry("indicator_dot", "indicator_dot",
              "saigegds_tpu/ops/pallas_score.py:225",
              agg_launches["indicator_dot"], b4_checks,
              b4_checks[SCAN_MAIN]),
        entry("decode_codes", "decode_codes",
              "saigegds_tpu/ops/pallas_sparse.py:160",
              agg_launches["decode_codes"], b5_checks, b5_checks[1]),
        entry("gather_2bit", "gather_2bit", None,
              scan_launches["gather_2bit"], gather_checks,
              gather_checks[GATHER_MAIN]),
    ]
    mark("all phases done")
    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(dist_child(sys.argv[1:]) if len(sys.argv) > 1 else main())
