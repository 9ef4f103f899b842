"""The PheWAS null fit: each call fits ``phenotypes_per_call`` fresh
phenotypes lock-step over ONE GRM operator built in set-up
(``fit_glmm_binary_device_multi`` or ``fit_glmm_quant_device_multi`` by
the configuration's trait), its outputs brought to the host.

Set-up draws the GRM markers on the device from the seed and builds the
program's store from them with ``build_packed2_grm_streamed`` (no GDS
ingest), draws the covariates, the polygenic bases of the phenotypes and
the Rademacher probe pool, and takes one product at each column tile the
fitter uses; it writes nothing to disk.  The fitter gets the operator
through :class:`Operator`, the benchmark's own wrapper: CUDA events around
each product in a traced run, and in every run a few products' columns
kept for the check."""

from __future__ import annotations

import time

import numpy as np
import torch

from ..data.genotypes import GrmMarkers
from ..data.phenotypes import F64, covariates, fit_lanes as lane_inputs
from ..reference.fit import Params
from ..reference.fit_check import gaps, reference_answers
from ..seeds import device_gen, host_rng

# products at these column counts R take every column tile of kernels B1
# and B2 that a call reaches (C = 8 R padded: 16 ... 256, then 384 on
# tiles of 128 and 512 on tiles of 256)
WARM_COLUMNS = (1, 2, 4, 8, 16, 32, 48, 64)


class Operator:
    """The program's GRM operator as the fitter sees it (``matvec`` and
    ``diag``), with the benchmark's spans: CUDA events around each
    product when ``timed``; the columns ``cols`` of product number ``k``
    of a call (its input and output) kept when ``k`` is in ``keep``."""

    def __init__(self, op, timed: bool):
        self.op, self.diag, self.timed = op, op.diag, timed
        self.events = []
        self.keep, self.kept, self.count, self.rng = set(), [], 0, None

    def start_call(self, keep, rng):
        self.keep, self.count, self.rng = set(keep), 0, rng

    def matvec(self, b):
        k = self.count
        self.count += 1
        if self.timed:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        out = self.op.matvec(b)
        if self.timed:
            ev[1].record()
            self.events.append(ev)
        if k in self.keep:
            b2 = b if b.dim() == 2 else b[:, None]
            o2 = out if out.dim() == 2 else out[:, None]
            cols = torch.as_tensor(np.sort(self.rng.choice(
                b2.shape[1], min(4, b2.shape[1]), replace=False)),
                device=b2.device)
            self.kept.append((b2[:, cols].clone(), o2[:, cols].clone()))
        return out

    def product_ms(self) -> list:
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.events]


class FitLanes:
    """One run's state: the program's operator and the benchmark's
    inputs; :meth:`call` is one closed-loop call."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device,
                 timed: bool, log, workdir: str):
        from saigegds_tpu_torch.ops.packed_grm import \
            build_packed2_grm_streamed

        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.dev = torch.device(device)
        self.trait = cfg["trait"]
        self.fit_args = cfg["null_model"]
        n, m = cfg["n_samples"], cfg["grm_markers"]
        self.markers = GrmMarkers(n, m, cfg["grm_af_range"],
                                  cfg["missing_rate"], seed, self.dev)
        beta = torch.as_tensor(self.markers.beta, dtype=F64, device=self.dev)
        bases = torch.zeros(n, self.markers.bases, dtype=F64,
                            device=self.dev)
        t0 = time.perf_counter()

        def host_blocks():
            nonlocal bases
            for s, g, codes in self.markers.blocks():
                bases += g.T.to(F64) @ beta[s:s + g.shape[0]]
                yield np.arange(s, s + g.shape[0]), codes.cpu().numpy()

        op = build_packed2_grm_streamed(host_blocks(), n, m,
                                        device=self.dev)
        self.bases = bases - bases.mean(0)
        log(f"store built: {time.perf_counter() - t0:.2f} s")
        self.X = covariates(n, cfg["covariates"], seed, self.dev,
                            cfg["binary_covariates"])
        gen = device_gen(seed, "probes", self.dev)
        R = self.fit_args["probe_pool"]
        self.U = torch.randint(0, 2, (n, R), generator=gen,
                               device=self.dev).to(F64) * 2.0 - 1.0
        self.op = Operator(op, timed)
        for r in WARM_COLUMNS:
            op.matvec(torch.ones(n, r, dtype=F64, device=self.dev))
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
        op.matvecs, op.widths = 0, {}
        import saigegds_tpu_torch as sg
        self.entry = sg.fit_glmm_binary_device_multi \
            if self.trait["type"] == "binary" else \
            sg.fit_glmm_quant_device_multi
        self.kept_lanes = []     # the lanes of each call that may be checked

    def call(self, c: int) -> dict:
        """Call ``c``: fresh phenotypes and their starts, one fit of them
        all, every output on the host; one lane of each lane group that
        the program formed is kept for the check, its slot in the group
        drawn from the seed."""
        Y, tau, eta, info = lane_inputs(self.X, self.bases, self.trait,
                                        self.mix, c, self.seed)
        rng = host_rng(self.seed, f"check.{c}")
        sel = self.mix["check"]
        self.op.start_call([int(rng.integers(0, sel["early_products"])),
                            int(rng.integers(sel["early_products"],
                                             sel["late_products"]))], rng)
        a = self.fit_args
        common = dict(maxiter=a["maxiter"], maxiter_pcg=a["maxiter_pcg"],
                      nrun=a["nrun"], trace_cv_cutoff=a["trace_cv_cutoff"])
        if eta is None:
            fit = self.entry(self.op, Y, self.X, tau, self.U, a["tol"],
                             a["tol_pcg"], **common)
        else:
            fit = self.entry(self.op, Y, self.X, tau, eta, self.U, a["tol"],
                             a["tol_pcg"], maxiter_coef=a["maxiter_coef"],
                             **common)
        out = {f: getattr(fit, f).cpu() for f in (
            "coefficients", "tau", "eta", "mu", "cov", "iterations",
            "converged", "trace_capped")}
        groups = [int(g) for g in fit.lane_groups] or [Y.shape[0]]
        start = 0
        for size in groups:
            k = start + int(rng.integers(size))
            self.kept_lanes.append(dict(
                call=c, lane=k, y=Y[k].cpu(), tau_init=tau[k].cpu(),
                eta_init=None if eta is None else eta[k].cpu()))
            start += size
        out.update(lane_groups=groups, pcg_iterations=fit.pcg_iterations,
                   products=self.op.count, **info)
        return out

    def work(self, rec: dict) -> int:
        return int(rec["tau"].shape[0])

    def failed(self, rec: dict) -> int:
        return int((~rec["converged"]).sum())

    def counters(self, records: list) -> dict:
        op = self.op.op
        return dict(matvecs=op.matvecs, widths=dict(op.widths),
                    phenotypes=sum(self.work(r) for r in records),
                    product_ms=self.op.product_ms() if self.op.timed
                    else None,
                    n_samples=self.cfg["n_samples"],
                    grm_markers=self.cfg["grm_markers"])

    def release(self, records: list) -> dict:
        """The program's answers that the check compares, on the host;
        the program's device state is dropped."""
        op = self.op.op
        miss = op.miss
        prog = dict(
            af=op.af.cpu(), inv=op.inv.cpu(), diag=op.diag.cpu(),
            pairs_samp=miss.samp.cpu(), pairs_start=miss.var_start.cpu(),
            products=[(b.cpu(), o.cpu()) for b, o in self.op.kept],
            lanes=[])
        for kept in self.kept_lanes:
            rec = records[kept["call"]]
            k = kept["lane"]
            prog["lanes"].append(dict(kept, **{
                f: rec[f][k] for f in ("tau", "coefficients", "eta",
                                       "converged", "iterations")}))
        self.op = None
        self.entry = None
        return prog

    def _reference(self, prog: dict, dtype) -> dict:
        a = self.fit_args
        params = Params(a["tol"], a["tol_pcg"], a["maxiter"],
                        a["maxiter_pcg"], a["maxiter_coef"], a["nrun"],
                        a["trace_cv_cutoff"])
        return reference_answers(self.markers.code_blocks(),
                                 self.cfg["n_samples"],
                                 self.cfg["grm_markers"], prog, self.X,
                                 self.U, self.trait["type"], params, dtype,
                                 self.dev)

    def readings(self, prog: dict, dtypes=()):
        """The numbers compared, against one float64 reference: the
        program's, and for each of ``dtypes`` the reference's computed in
        that type in the program's place (the control).  The lanes
        compared are those kept of ``check["calls"]`` calls drawn from
        the seed: one in each lane group of each."""
        calls = sorted({k["call"] for k in prog["lanes"]})
        rng = host_rng(self.seed, "check.calls")
        pick = set(rng.choice(calls, min(self.mix["check"]["calls"],
                                         len(calls)), replace=False))
        prog = dict(prog, lanes=[k for k in prog["lanes"]
                                 if k["call"] in pick])
        ref = self._reference(prog, F64)
        got = gaps(dict(prog, products=[o for _b, o in prog["products"]]),
                   ref)
        return got, [gaps(self._reference(prog, d), ref) for d in dtypes]

    def close(self):
        pass


Entry = FitLanes
