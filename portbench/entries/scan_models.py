"""The PheWAS scan: each call is one ``assoc_spa_multi`` of fresh null
models (one per case share of the mix) over ONE GDS file written in
set-up, its tables on the host.

Set-up draws the scanned variants' codes on the device from the seed
(the GDS's samples: the model's and, at shuffled positions, the cohort's
others), writes them with the benchmark's frozen GDS writer under the
run's work directory, draws the covariates and a pool of causal
variants, and runs the scan once over the first block.  A call's models
are made on the device from the seed and the call's index (the design
the same in every call and under every seed, the draws by the seed and
the call): binary traits of a few causal
variants at the mix's case shares, the benchmark's own
logistic GLM of each on the covariates, SPAtest's projections, and a
variance-ratio table; no GRM fit runs."""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..data.gds import write_genotype_gds
from ..data.genotypes import scan_codes, scan_variant_afs
from ..data.phenotypes import F64, case_intercepts, covariates, \
    glm_logistic
from ..reference.scan_check import gaps, reference_tables
from ..seeds import device_gen, host_rng


class ScanModels:
    """One run's state; :meth:`call` is one closed-loop call."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device,
                 timed: bool, log, workdir: str):
        from saigegds_tpu_torch import ScanConfig

        if cfg["trait"]["type"] != "binary":
            raise NotImplementedError(
                "scan_models makes binary null models; a scan of other "
                "traits is a driver of its own, entries/<name>.py")
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.dev = torch.device(device)
        self.timed = timed
        n, n_gds, V = cfg["n_samples"], cfg["gds_samples"], mix["variants"]
        t0 = time.perf_counter()
        af = scan_variant_afs(V, mix["maf_classes"], mix["alt_major"], seed)
        rng = host_rng(seed, "scan.samples")
        cols = np.sort(rng.choice(n_gds, n, replace=False))
        ids = np.arange(1, n_gds + 1, dtype=np.int32)
        self.sample_id = ids[cols]
        # the GDS holds every sample; the reference reads the model's
        geno, self.codes = scan_codes(af, n_gds, cols, cfg["missing_rate"],
                                      seed, self.dev)
        log(f"codes drawn: {time.perf_counter() - t0:.2f} s")
        self.path = os.path.join(workdir, "scan.gds")
        self.gds_bytes = write_genotype_gds(self.path, geno, ids)
        del geno
        log(f"GDS written: {self.gds_bytes} B, "
            f"{time.perf_counter() - t0:.2f} s")
        self.X = covariates(n, cfg["covariates"], seed, self.dev,
                            cfg["binary_covariates"])
        maf = np.minimum(af, 1.0 - af)
        pool = rng.choice(np.flatnonzero(maf >= mix["causal_maf_min"]),
                          mix["causal_pool"], replace=False)
        G = torch.as_tensor(self.codes[np.sort(pool)], device=self.dev)
        g = torch.where(G == 3, 0, G).to(F64)
        m = g.sum(1, keepdim=True) / (G != 3).sum(1, keepdim=True)
        g = torch.where(G == 3, m, g) - m
        self.causal = g / g.std(1, keepdim=True)
        self.config = ScanConfig(block_size=mix["block_size"],
                                 spa_pval=mix["spa_pval"], mac=mix["mac"],
                                 missing=mix["missing"])
        self.kept = []          # every model of each call, for the check
        self.instrument = {}
        self._warm()

    def _models(self, c: int):
        """The null models of call ``c`` and their arrays."""
        from saigegds_tpu_torch import NullModel

        mix = self.mix
        pct = torch.as_tensor(mix["models_case_pct"], dtype=F64,
                              device=self.dev)
        P = len(pct)
        n, K = self.X.shape
        gen = device_gen(self.seed, f"models.{c}", self.dev)
        # the models' design (covariate and causal effects, which of the
        # pool's variants are causal, the variance ratios) is the same in
        # every call and under every seed, so that every call does alike
        # work
        rng = host_rng(0, "models")
        alpha = torch.as_tensor(rng.normal(size=(P, K - 1)) *
                                self.cfg["trait"]["covariate_effect_sd"],
                                dtype=F64, device=self.dev)
        eff = np.zeros((P, self.causal.shape[0]))
        lo, hi = mix["causal_effect"]
        for p in range(P):
            at = rng.choice(self.causal.shape[0], mix["causal_per_model"],
                            replace=False)
            eff[p, at] = rng.uniform(lo, hi, len(at)) * rng.choice(
                [-1.0, 1.0], len(at))
        L = alpha @ self.X[:, 1:].T + torch.as_tensor(
            eff, dtype=F64, device=self.dev) @ self.causal + \
            mix["background_sd"] * torch.randn(P, n, generator=gen,
                                               device=self.dev, dtype=F64)
        cint = case_intercepts(L, pct)
        Y = (torch.rand(P, n, generator=gen, device=self.dev, dtype=F64)
             < torch.sigmoid(L + cint[:, None])).to(F64)
        beta, eta, mu = glm_logistic(self.X, Y)
        V = mu * (1.0 - mu)
        XVX_inv = torch.linalg.inv(torch.einsum("nk,pn,nj->pkj", self.X, V,
                                                self.X))
        XXVX_inv = torch.einsum("nk,pkj->pnj", self.X, XVX_inv)
        XV = torch.einsum("nk,pn->pkn", self.X, V)
        lo, hi = mix["var_ratio_range"]
        ratio = rng.uniform(lo, hi, (P, mix["var_ratio_markers"]))
        h = lambda t: t.cpu().numpy()
        X1 = h(self.X)
        models, arrays = [], []
        for p in range(P):
            y, m_ = h(Y[p]), h(mu[p])
            arrays.append(dict(y=y, mu=m_, XV=h(XV[p]),
                               XXVX_inv=h(XXVX_inv[p]),
                               var_ratio=float(np.mean(ratio[p]))))
            models.append(NullModel.from_arrays(dict(
                trait_type="binary", coefficients=h(beta[p]),
                coef_names=["(Intercept)"] + [f"x{k}" for k in range(1, K)],
                tau=np.array([1.0, 0.0]), linear_predictors=h(eta[p]),
                fitted_values=m_, residuals=y - m_, cov=h(XVX_inv[p]),
                converged=True, y=y, mu=m_, res=y - m_, V=h(V[p]), X1=X1,
                XV=arrays[-1]["XV"], XXVX_inv=arrays[-1]["XXVX_inv"],
                var_ratio=dict(id=np.arange(1, len(ratio[p]) + 1),
                               ratio=ratio[p]),
                sample_id=self.sample_id)))
        return models, arrays

    def _scan(self, models, variant_mask=None, instrument=None):
        from saigegds_tpu_torch import assoc_spa_multi
        return assoc_spa_multi(self.path, models, self.config,
                               variant_mask=variant_mask,
                               instrument=instrument, device=self.dev)

    def _warm(self):
        models, _ = self._models(-1)
        mask = np.zeros(self.mix["variants"], bool)
        mask[:self.mix["block_size"]] = True
        self._scan(models, mask)

    def call(self, c: int) -> dict:
        models, arrays = self._models(c)
        inst = {} if self.timed else None
        tabs = self._scan(models, instrument=inst)
        for k, t in enumerate(tabs):
            self.kept.append(dict(arrays[k], call=c, model=k, table=dict(
                {c_: np.asarray(t[c_]) for c_ in (
                    "AF.alt", "mac", "num", "beta", "SE", "pval", "p.norm",
                    "converged")},
                idx=np.asarray(t["id"]).astype(np.int64) - 1)))
        if inst is not None:
            for key, v in inst.items():
                if isinstance(v, list):
                    self.instrument.setdefault(key, []).extend(v)
                else:
                    self.instrument[key] = self.instrument.get(key, 0) + v
        return dict(tests=sum(len(t["pval"]) for t in tabs),
                    failed=sum(int((~np.isfinite(t["pval"])).sum()
                                   + (~np.asarray(t["converged"])).sum())
                               for t in tabs),
                    spa_rows=inst.get("spa_n") if inst else None)

    def work(self, rec: dict) -> int:
        return rec["tests"]

    def failed(self, rec: dict) -> int:
        return rec["failed"]

    def counters(self, records: list) -> dict:
        return dict(instrument=self.instrument,
                    tests=sum(r["tests"] for r in records))

    def release(self, records: list) -> dict:
        return dict(kept=self.kept)

    def _params(self) -> dict:
        return {k: self.mix[k] for k in ("spa_pval", "mac", "missing")}

    def readings(self, prog: dict, dtypes=()):
        """The numbers compared, against one float64 reference: the
        program's, and for each of ``dtypes`` the reference's computed in
        that type in the program's place (the control).  The tables
        compared are every model's of ``check["calls"]`` calls drawn from
        the seed."""
        calls = sorted({k["call"] for k in prog["kept"]})
        rng = host_rng(self.seed, "check.calls")
        pick = set(rng.choice(calls, min(self.mix["check"]["calls"],
                                         len(calls)), replace=False))
        kept = [k for k in prog["kept"] if k["call"] in pick]
        ref = reference_tables(self.codes, kept, self._params(), F64,
                               self.dev)
        got = gaps([k["table"] for k in kept], ref)
        return got, [gaps(reference_tables(self.codes, kept, self._params(),
                                           d, self.dev), ref)
                     for d in dtypes]

    def close(self):
        if os.path.exists(self.path):
            os.remove(self.path)


Entry = ScanModels
