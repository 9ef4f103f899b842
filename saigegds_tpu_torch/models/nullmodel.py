"""Null-model container: fit results, (de)serialization, scan preparation.

The counterpart of ``saigegds_tpu/models/nullmodel.py``.  ``NullModel``
mirrors the reference's ``ClassSAIGE_NullModel`` S3 object
(``R/saige_main.r:616-628``) and holds numpy arrays.  It reads and writes
the JAX package's ``.npz`` and the reference's ``.rds`` / ``.rda`` files,
so a model fitted by the R package, the JAX package or this one loads in
the other two.
:meth:`NullModel.scan_model` places the scan's float64 state on a torch
device.
"""

from __future__ import annotations

import dataclasses
import json
import warnings
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..io.rds import RObject, read_rds, strip
from ..ops._cuda import check_device


@dataclass
class NullModel:
    trait_type: str                   # "binary" | "quantitative"
    coefficients: np.ndarray          # [K]
    coef_names: list
    tau: np.ndarray                   # [2] (Sigma_E, Sigma_G)
    linear_predictors: np.ndarray     # [N]
    fitted_values: np.ndarray         # [N] mu
    residuals: np.ndarray             # [N] y - mu
    cov: np.ndarray                   # [K, K]
    converged: bool
    # obj.noK (the SPAtest-style projection state)
    y: np.ndarray                     # [N]
    mu: np.ndarray                    # [N]
    res: np.ndarray                   # [N]
    V: np.ndarray                     # [N]
    X1: np.ndarray                    # [N, K]
    XV: np.ndarray                    # [K, N]
    XXVX_inv: np.ndarray              # [N, K]
    # variance ratio table (id, maf, mac, var1, var2, ratio)
    var_ratio: dict = field(default_factory=dict)
    sample_id: np.ndarray = None
    variant_id: np.ndarray = None
    fit_log: list = None              # the fit's telemetry events

    @property
    def n_samples(self) -> int:
        return len(self.y)

    @property
    def mean_var_ratio(self) -> float:
        """NaN-skipping mean like the reference's
        mean(var.ratio$ratio, na.rm=TRUE), which also hard-errors on a
        non-finite result (R/assoc_single.r:157, .init_nullmod:21-22)."""
        r = np.asarray(self.var_ratio.get("ratio", [1.0]), dtype=float)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")   # all-NaN mean warns
            v = float(np.nanmean(r))
        if not np.isfinite(v):
            raise ValueError("the variance ratio is not finite")
        return v

    # ---- carrying a model across ----

    @classmethod
    def from_arrays(cls, d: dict) -> "NullModel":
        """Build from a mapping of the JAX ``NullModel``'s fields as numpy
        arrays (e.g. ``vars(jax_model)``); fields this class does not hold
        are ignored."""
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in names}
        kw["trait_type"] = str(kw["trait_type"])
        kw["coef_names"] = list(kw["coef_names"])
        kw["converged"] = bool(kw["converged"])
        kw["var_ratio"] = {k: np.asarray(v)
                           for k, v in dict(kw.get("var_ratio") or {}).items()}
        for k in ("coefficients", "tau", "linear_predictors",
                  "fitted_values", "residuals", "cov", "y", "mu", "res", "V",
                  "X1", "XV", "XXVX_inv"):
            kw[k] = np.asarray(kw[k], dtype=np.float64)
        return cls(**kw)

    # ---- persistence ----

    @classmethod
    def load(cls, path_or_obj) -> "NullModel":
        """Load from .rds / .rda / .RData (R package format), .npz (the
        JAX package's), or pass through."""
        if isinstance(path_or_obj, NullModel):
            return path_or_obj
        path = str(path_or_obj)
        low = path.lower()
        if low.endswith(".rds"):
            return cls.from_r_object(read_rds(path))
        if low.endswith((".rda", ".rdata")):
            # the reference's .check_modobj does get(load(fn)): take the
            # single stored object
            from ..io.rds import read_rdata
            objs = read_rdata(path)
            return cls.from_r_object(next(iter(objs.values())))
        if path.endswith(".npz"):
            return cls.from_npz(path)
        raise ValueError(f"unknown model file format: {path}")

    @classmethod
    def from_r_object(cls, m) -> "NullModel":
        """Decode a ClassSAIGE_NullModel read from an R file."""
        nok = m["obj.noK"]
        N = len(strip(nok["y"]))
        coef = m["coefficients"]
        coef_names = coef.names if isinstance(coef, RObject) else None
        K = len(strip(coef))

        def mat(x, shape):      # R's column-major payload, C-ordered here
            return np.ascontiguousarray(np.asarray(
                strip(x), dtype=np.float64).reshape(shape, order="F"))

        def vec(x):
            return np.asarray(strip(x), np.float64)

        vr = m["var.ratio"]
        vrd = {k: np.asarray(strip(vr[k])) for k in vr.names} \
            if vr is not None else {}
        if isinstance(vr, RObject) and "mac.bins" in vr.attributes:
            vrd["mac_bins"] = np.asarray(strip(vr.attributes["mac.bins"]))
        return cls(
            trait_type=str(strip(m["trait.type"])[0]),
            coefficients=vec(coef),
            coef_names=list(coef_names) if coef_names
            else [f"b{i}" for i in range(K)],
            tau=vec(m["tau"]),
            linear_predictors=vec(m["linear.predictors"]),
            fitted_values=vec(m["fitted.values"]),
            residuals=vec(m["residuals"]),
            cov=mat(m["cov"], (K, K)),
            converged=bool(np.asarray(strip(m["converged"]))[0]),
            y=vec(nok["y"]), mu=vec(nok["mu"]), res=vec(nok["res"]),
            V=vec(nok["V"]),
            X1=mat(nok["X1"], (N, K)),
            XV=mat(nok["XV"], (K, N)),
            XXVX_inv=mat(nok["XXVX_inv"], (N, K)),
            var_ratio=vrd,
            sample_id=np.asarray(strip(m["sample.id"])),
            variant_id=np.asarray(strip(m["variant.id"])),
        )

    def to_r_object(self) -> RObject:
        """The R-side ``ClassSAIGE_NullModel`` structure (the inverse of
        :meth:`from_r_object`; layout per R/saige_main.r:616-628).
        Matrices are written column-major; the category bounds of
        MAC-categorized ratios travel as the ``mac.bins`` attribute of the
        ``var.ratio`` data.frame (they are not per-row data)."""
        K = len(self.coefficients)
        vr = dict(self.var_ratio)
        mac_bins = vr.pop("mac_bins", None)
        vr_n = len(np.asarray(vr.get("ratio", [])))
        vr_attrs = {"class": "data.frame",
                    "row.names": np.asarray([-2147483648, -vr_n], np.int32)}
        if mac_bins is not None:
            vr_attrs["mac.bins"] = np.asarray(mac_bins, np.float64)
        var_ratio = RObject({k: np.asarray(v) for k, v in vr.items()},
                            vr_attrs)
        f64 = lambda a: np.asarray(a, np.float64)
        obj_nok = {
            "y": f64(self.y), "mu": f64(self.mu), "res": f64(self.res),
            "V": f64(self.V), "X1": f64(self.X1), "XV": f64(self.XV),
            "XXVX_inv": f64(self.XXVX_inv),
        }
        body = {
            "coefficients": RObject(
                f64(self.coefficients),
                {"names": np.asarray(self.coef_names, object)}),
            "tau": RObject(f64(self.tau),
                           {"names": np.asarray(["Sigma_E", "Sigma_G"],
                                                object)}),
            "linear.predictors": f64(self.linear_predictors),
            "fitted.values": f64(self.fitted_values),
            "residuals": f64(self.residuals),
            "cov": f64(self.cov).reshape(K, K),
            "converged": bool(self.converged),
            "obj.noK": obj_nok,
            "var.ratio": var_ratio,
            "trait.type": str(self.trait_type),
            "sample.id": self.sample_id,
            "variant.id": self.variant_id,
        }
        return RObject(body, {"class": "ClassSAIGE_NullModel"})

    def save(self, path: str):
        """Save to .npz (both Python packages), .rds or .rda / .RData (the
        reference's ``save(glmm, file=)`` container, R/saige_main.r:630-643,
        with the object named ``glmm``)."""
        low = path.lower()
        if low.endswith(".rds"):
            from ..io.rds_write import write_rds
            write_rds(path, self.to_r_object())
            return
        if low.endswith((".rda", ".rdata")):
            from ..io.rds_write import write_rdata
            write_rdata(path, {"glmm": self.to_r_object()})
            return
        if not path.endswith(".npz"):
            path += ".npz"
        np.savez_compressed(
            path,
            trait_type=self.trait_type,
            coefficients=self.coefficients,
            coef_names=np.asarray(self.coef_names, dtype=object),
            tau=self.tau,
            linear_predictors=self.linear_predictors,
            fitted_values=self.fitted_values,
            residuals=self.residuals,
            cov=self.cov,
            converged=self.converged,
            y=self.y, mu=self.mu, res=self.res, V=self.V,
            X1=self.X1, XV=self.XV, XXVX_inv=self.XXVX_inv,
            var_ratio=json.dumps({k: np.asarray(v).tolist()
                                  for k, v in self.var_ratio.items()}),
            sample_id=self.sample_id,
            variant_id=self.variant_id,
        )

    @classmethod
    def from_npz(cls, path: str) -> "NullModel":
        z = np.load(path, allow_pickle=True)
        return cls(
            trait_type=str(z["trait_type"]),
            coefficients=z["coefficients"],
            coef_names=list(z["coef_names"]),
            tau=z["tau"],
            linear_predictors=z["linear_predictors"],
            fitted_values=z["fitted_values"],
            residuals=z["residuals"],
            cov=z["cov"],
            converged=bool(z["converged"]),
            y=z["y"], mu=z["mu"], res=z["res"], V=z["V"],
            X1=z["X1"], XV=z["XV"], XXVX_inv=z["XXVX_inv"],
            var_ratio={k: np.asarray(v) for k, v in
                       json.loads(str(z["var_ratio"])).items()},
            sample_id=z["sample_id"],
            variant_id=z["variant_id"],
        )

    # ---- scan preparation (the .init_nullmod analog) ----

    def scan_model(self, sample_index: Optional[np.ndarray] = None,
                   var_ratio: float = float("nan"), *, device):
        """Build the scan's ScanModel on ``device`` (cf.
        R/assoc_single.r:17-67).

        ``sample_index[j]`` is the *model* position of the j-th genotype
        column the scan will feed in (the reference's
        ``ii <- match(sid, modobj$sample.id)``)."""
        from ..ops.score import ScanModel

        dev = check_device(device)
        t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64),
                                      dtype=torch.float64, device=dev)
        ii = np.arange(self.n_samples) if sample_index is None \
            else sample_index
        y = np.asarray(self.y, np.float64)[ii]
        mu = np.asarray(self.fitted_values, np.float64)[ii]
        vr_edges = vr_ratios = None
        if not np.isfinite(var_ratio):
            vrd = self.var_ratio
            if len(np.asarray(vrd.get("mac_bins", []))) \
                    and "mac_cat" in vrd:
                # MAC-categorized ratios: per-category means, empty
                # categories fall back to the overall mean
                edges = np.asarray(vrd["mac_bins"], float)
                cat = np.asarray(vrd["mac_cat"], int)
                rat = np.asarray(vrd["ratio"], float)
                means = np.full(len(edges) + 1, self.mean_var_ratio)
                for c in range(len(means)):
                    rc = rat[cat == c]
                    rc = rc[np.isfinite(rc)]
                    if rc.size:
                        means[c] = rc.mean()
                vr_edges = t(edges)
                vr_ratios = t(means)
            var_ratio = self.mean_var_ratio
        return ScanModel(
            trait_binary=(self.trait_type == "binary"),
            tau=t(self.tau),
            y=t(y),
            mu=t(mu),
            y_mu=t(y - mu),
            mu2=t(mu * (1.0 - mu)),
            XV=t(np.asarray(self.XV)[:, ii]),
            XXVX_inv=t(np.asarray(self.XXVX_inv)[ii, :]),
            var_ratio=float(var_ratio),
            vr_edges=vr_edges,
            vr_ratios=vr_ratios,
        )


def fit_null_glmm(*args, **kwargs):
    from .fitnull import fit_null_glmm as _fit
    return _fit(*args, **kwargs)


def fit_null_glmm_multi(*args, **kwargs):
    from .fitnull import fit_null_glmm_multi as _fit
    return _fit(*args, **kwargs)
