"""The quantitative PheWAS scan: each call is one ``assoc_spa_multi`` of
fresh quantitative null models (one per heritability of the mix) over
ONE GDS file written in set-up, its tables on the host.

Set-up is :class:`ScanModels`'s: the GDS, the covariates, the pool of
causal variants, one block scanned.  A call's models are made on the
device from the seed and the call's index, the design fixed by slot as
there (covariate and causal effects, which of the pool's variants are
causal, the heritability, the variance ratios), the draws by the seed
and the call: a few causal variants and a polygenic background,
log-normal noise scaled to the slot's heritability, the covariates'
residuals inverse-normal transformed (SAIGEgds's ``inv.norm``), the
benchmark's own least squares on the covariates as the null model (tau
= (residual variance, 0), SAIGEgds's quantitative projection with V =
1), and variance ratios of the mix's range over tau0; no GRM fit runs.
A quantitative model sends nothing to SPA, so its table has no
``p.norm`` or ``converged``."""

from __future__ import annotations

import numpy as np
import torch

from ..data.phenotypes import F64, least_squares, rank_normal
from ..reference.scan_check import gaps
from ..reference.scan_quant import quant_tables
from ..seeds import device_gen, host_rng
from .scan_models import ScanModels

COLUMNS = ("AF.alt", "mac", "num", "beta", "SE", "pval")


class ScanQuantModels(ScanModels):
    """One run's state; :meth:`call` is one closed-loop call."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device,
                 timed: bool, log, workdir: str):
        if cfg["trait"]["type"] != "quantitative":
            raise NotImplementedError(
                "scan_quant_models makes quantitative null models")
        # the set-up does not depend on the trait; only its guard reads
        # the trait's type
        super().__init__(dict(cfg, trait=dict(cfg["trait"], type="binary")),
                         mix, seed, device, timed, log, workdir)
        self.cfg = cfg

    def _models(self, c: int):
        """The null models of call ``c`` and their arrays."""
        from saigegds_tpu_torch import NullModel

        mix, trait = self.mix, self.cfg["trait"]
        h2 = torch.as_tensor(mix["models_h2"], dtype=F64, device=self.dev)
        P = len(h2)
        n, K = self.X.shape
        gen = device_gen(self.seed, f"models.{c}", self.dev)
        # the models' design is the same in every call and under every
        # seed, so that every call does alike work
        rng = host_rng(0, "models")
        alpha = torch.as_tensor(rng.normal(size=(P, K - 1)) *
                                trait["covariate_effect_sd"],
                                dtype=F64, device=self.dev)
        eff = np.zeros((P, self.causal.shape[0]))
        lo, hi = mix["causal_effect"]
        for p in range(P):
            at = rng.choice(self.causal.shape[0], mix["causal_per_model"],
                            replace=False)
            eff[p, at] = rng.uniform(lo, hi, len(at)) * rng.choice(
                [-1.0, 1.0], len(at))
        genetic = torch.as_tensor(eff, dtype=F64, device=self.dev) @ \
            self.causal + mix["background_sd"] * torch.randn(
                P, n, generator=gen, device=self.dev, dtype=F64)
        e = torch.exp(torch.randn(P, n, generator=gen, device=self.dev,
                                  dtype=F64) * trait["lognormal_sigma"])
        e = (e - e.mean(1, keepdim=True)) / e.std(1, keepdim=True)
        noise_sd = torch.sqrt(genetic.var(1) * (1.0 - h2) / h2)
        yq = alpha @ self.X[:, 1:].T + genetic + noise_sd[:, None] * e
        resid = yq - least_squares(self.X, yq) @ self.X.T
        Y = rank_normal(resid) * resid.std(1, keepdim=True)
        beta = least_squares(self.X, Y)
        mu = beta @ self.X.T
        tau0 = ((Y - mu) ** 2).sum(1) / (n - K)
        XtX_inv = torch.linalg.inv(self.X.T @ self.X)
        # SAIGEgds's quantitative variance ratio is the full model's
        # variance over g~ . g~ without 1 / tau0, so it carries that
        # factor: the mix's range is the GRM's inflation, as in scan_models
        lo, hi = mix["var_ratio_range"]
        ratio = rng.uniform(lo, hi, (P, mix["var_ratio_markers"])) / \
            tau0.cpu().numpy()[:, None]
        h = lambda t: t.cpu().numpy()
        X1 = h(self.X)
        XXVX_inv = h(self.X @ XtX_inv)
        models, arrays = [], []
        for p in range(P):
            y, m_, t0 = h(Y[p]), h(mu[p]), float(tau0[p])
            arrays.append(dict(y=y, mu=m_, XV=X1.T, XXVX_inv=XXVX_inv,
                               tau0=t0, var_ratio=float(np.mean(ratio[p]))))
            models.append(NullModel.from_arrays(dict(
                trait_type="quantitative", coefficients=h(beta[p]),
                coef_names=["(Intercept)"] + [f"x{k}" for k in range(1, K)],
                tau=np.array([t0, 0.0]), linear_predictors=m_,
                fitted_values=m_, residuals=y - m_, cov=h(XtX_inv) * t0,
                converged=True, y=y, mu=m_, res=y - m_, V=np.ones(n),
                X1=X1, XV=X1.T, XXVX_inv=XXVX_inv,
                var_ratio=dict(id=np.arange(1, len(ratio[p]) + 1),
                               ratio=ratio[p]),
                sample_id=self.sample_id)))
        return models, arrays

    def call(self, c: int) -> dict:
        models, arrays = self._models(c)
        inst = {} if self.timed else None
        tabs = self._scan(models, instrument=inst)
        for k, t in enumerate(tabs):
            self.kept.append(dict(arrays[k], call=c, model=k, table=dict(
                {c_: np.asarray(t[c_]) for c_ in COLUMNS},
                idx=np.asarray(t["id"]).astype(np.int64) - 1)))
        if inst is not None:
            for key, v in inst.items():
                if isinstance(v, list):
                    self.instrument.setdefault(key, []).extend(v)
                else:
                    self.instrument[key] = self.instrument.get(key, 0) + v
        return dict(tests=sum(len(t["pval"]) for t in tabs),
                    failed=sum(int((~np.isfinite(t["pval"])).sum())
                               for t in tabs))

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
        ref = quant_tables(self.codes, kept, self._params(), F64, self.dev)
        got = gaps([k["table"] for k in kept], ref)
        return got, [gaps(quant_tables(self.codes, kept, self._params(), d,
                                       self.dev), ref) for d in dtypes]


Entry = ScanQuantModels
