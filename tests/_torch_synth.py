"""Synthetic inputs shared by the PyTorch-port parity tests.

Everything is made with numpy from a seed and handed to both packages:
genotype codes with a MAF spectrum that includes rare variants, missing
entries, the corner rows of the scan (all missing, monomorphic, all-het,
ALT-major), a few rows associated with the phenotype (so phase 2 SPA has
small p-values to refine), a binary phenotype at ~10% prevalence, and a
JAX ``NullModel`` built from the GLM helpers with tau = (1, 0); for a
quantitative trait, a right-skewed phenotype and a JAX ``NullModel`` with
tau_E != 1.
"""

import numpy as np
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module's tests (import it into a test
    module to apply it there).  Their tensors are small, so the thread pool
    only adds a barrier per operation; with several test workers on one
    host, each pool's spinning threads would otherwise oversubscribe the
    cores and stall every barrier."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def synth_codes(rng, n_variants: int, n_samples: int, y=None,
                miss_rate: float = 0.03) -> np.ndarray:
    """int8 [M, N] ALT dosage codes, 3 = missing."""
    M, N = n_variants, n_samples
    af = np.concatenate([
        rng.uniform(0.0005, 0.005, M // 5),        # ultra-rare
        rng.uniform(0.005, 0.05, M // 4),          # rare
        rng.uniform(0.05, 0.5, M // 3),            # common
        rng.uniform(0.5, 0.95, M),                 # ALT-major (flip)
    ])[:M]
    rng.shuffle(af)
    codes = rng.binomial(2, af[:, None], size=(M, N)).astype(np.int8)
    if y is not None:
        # associated rows: cases carry the ALT allele more often
        case = y > 0.5
        for i, a in zip(range(6, min(M, 14)), (0.01, 0.02, 0.05, 0.2) * 2):
            codes[i] = rng.binomial(2, np.where(case, 4 * a, a))
    codes[rng.random((M, N)) < miss_rate] = 3
    if M >= 6:
        codes[0] = 3                               # all missing -> invalid
        codes[1] = 0                               # monomorphic REF
        codes[2] = 1                               # all-het (af = 0.5)
        codes[3] = np.where(codes[3] == 3, 3, 2)   # monomorphic ALT
        codes[4, :] = 0                            # singleton
        codes[4, 7] = 1
    return codes


def synth_pheno(rng, n_samples: int, n_cov: int = 3):
    """(X [N, 1 + n_cov] with an intercept column, binary y at ~10%)."""
    X = np.column_stack([np.ones(n_samples),
                         rng.normal(size=(n_samples, n_cov))])
    eta = np.log(0.1 / 0.9) + X[:, 1:] @ rng.normal(size=n_cov) * 0.4
    y = (rng.random(n_samples) < 1.0 / (1.0 + np.exp(-eta))).astype(
        np.float64)
    return X, y


def synth_quant_pheno(rng, n_samples: int, n_cov: int = 3, g=None):
    """(X [N, 1 + n_cov] with an intercept column, quantitative y): the
    covariates, an optional genetic value ``g`` [N] and a right-skewed
    (log-normal, as for BMI) noise."""
    X = np.column_stack([np.ones(n_samples),
                         rng.normal(size=(n_samples, n_cov))])
    y = 25.0 + X[:, 1:] @ rng.normal(size=n_cov) * 0.5 \
        + np.exp(rng.normal(size=n_samples) * 0.6)
    if g is not None:
        y = y + g
    return X, y


def var_ratio_table(kind: str) -> dict:
    """A variance-ratio table: one pooled ratio, or MAC categories."""
    ratio = np.array([0.97, 1.04, 1.11, 0.99, 1.02, 1.08])
    if kind == "pooled":
        return {"id": np.arange(1, 7), "ratio": ratio}
    return {"id": np.arange(1, 7), "ratio": ratio,
            "mac_cat": np.array([0, 0, 1, 1, 2, 2]),
            "mac_bins": np.array([10.5, 20.5])}


def jax_null_model(X, y, var_ratio: dict, sample_id=None):
    """A ``saigegds_tpu`` NullModel from the GLM helpers, tau = (1, 0)."""
    from saigegds_tpu.models.glm import glm_binomial, obj_nok_binary
    from saigegds_tpu.models.nullmodel import NullModel

    nok = obj_nok_binary(X, y)
    fit = glm_binomial(nok.X1, y)
    K = nok.X1.shape[1]
    return NullModel(
        trait_type="binary", coefficients=fit.coefficients,
        coef_names=[f"x{i}" for i in range(K)], tau=np.array([1.0, 0.0]),
        linear_predictors=fit.linear_predictors,
        fitted_values=nok.mu, residuals=nok.res, cov=np.eye(K),
        converged=True, y=nok.y, mu=nok.mu, res=nok.res, V=nok.V,
        X1=nok.X1, XV=nok.XV, XXVX_inv=nok.XXVX_inv,
        var_ratio=var_ratio,
        sample_id=np.arange(1, len(y) + 1, dtype=np.int32)
        if sample_id is None else sample_id,
        variant_id=None)


QUANT_TAU = (0.83, 0.31)   # tau_E != 1, so Tstat's division by it shows


def jax_quant_null_model(X, y, var_ratio: dict, sample_id=None):
    """A quantitative-trait ``saigegds_tpu`` NullModel from the GLM
    helpers (``glm_gaussian``, ``obj_nok_quant``), tau = QUANT_TAU."""
    from saigegds_tpu.models.glm import glm_gaussian, obj_nok_quant
    from saigegds_tpu.models.nullmodel import NullModel

    fit = glm_gaussian(X, y)
    nok = obj_nok_quant(X, fit)
    K = nok.X1.shape[1]
    return NullModel(
        trait_type="quantitative", coefficients=fit.coefficients,
        coef_names=[f"x{i}" for i in range(K)], tau=np.array(QUANT_TAU),
        linear_predictors=fit.linear_predictors,
        fitted_values=nok.mu, residuals=nok.res, cov=np.eye(K),
        converged=True, y=nok.y, mu=nok.mu, res=nok.res, V=nok.V,
        X1=nok.X1, XV=nok.XV, XXVX_inv=nok.XXVX_inv,
        var_ratio=var_ratio,
        sample_id=np.arange(1, len(y) + 1, dtype=np.int32)
        if sample_id is None else sample_id,
        variant_id=None)


def synth_dosages(rng, codes: np.ndarray, integer_rows=(),
                  sd: float = 0.15) -> np.ndarray:
    """f64 [M, N] imputed ALT dosages from hard calls: each call plus a
    Gaussian imputation noise, clipped to [0, 2] and rounded to 0.001 (as
    an imputed VCF's DS field carries them; not f32-exact), NaN where the
    call is missing.  ``integer_rows`` keep their hard calls (typed
    variants: f32-exact and all 0/1/2/NaN)."""
    ds = np.clip(codes + rng.normal(size=codes.shape) * sd, 0.0, 2.0)
    ds = np.round(ds, 3)
    rows = np.asarray(integer_rows, dtype=np.int64)
    ds[rows] = codes[rows]
    ds[codes == 3] = np.nan
    return ds
