"""The base fit of GxG's ``use_approx_tau`` from the default start against
the JAX package's, at the GRM panel shape of ``chip_smoke.py``'s GxG phase.

The smoke's GxG GRM is the first 4,096 of the 16,384 variants that make
its binary trait (genetic variance 0.6 on the logit scale, so the panel
holds about a quarter of it).  From the default start tau = (1, 0.5) the
first update of tau takes tau_G to 0 and the binary outer loop stops
there (src/saige_fitnull.cpp:948-1099); from tau_G = 0.1 it ends positive.
Here the same construction at N = 4,000 goes through both packages from
both starts (the JAX side with ``grm_impl="packed2"``, the port's 2-bit
operator): tau_G within 1e-6, the pair's p-value within 1e-8 relative,
and tau_G = 0 from the default start in both, so a 0 there is the
reference's answer and not the port's fault.
"""

import numpy as np
import pandas as pd
import pytest

from _torch_synth import one_torch_thread  # noqa: F401 (autouse)
import saigegds_tpu
import saigegds_tpu_torch as sgt
from saigegds_tpu.io.gds_write import write_seqarray_gds

N_SAMPLES, M_CAUSAL, PANEL = 4000, 16_384, 4096
FORMULA = "y ~ x1 + x2 + x3"
STARTS = {"default": (0.0, 0.0), "tuned": (0.0, 0.1)}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A polygenic binary trait of M_CAUSAL variants (allele frequencies
    0.05-0.5, 0.5% missing, three covariates, ~1/3 cases); the GDS holds
    the first PANEL of them and two more for the pair."""
    rng = np.random.default_rng(20261016)
    af = rng.uniform(0.05, 0.5, M_CAUSAL)
    X = rng.normal(size=(N_SAMPLES, 3))
    beta = rng.normal(size=M_CAUSAL) * np.sqrt(0.6 / M_CAUSAL) \
        / np.sqrt(2 * af * (1 - af))
    codes = rng.binomial(2, af[:, None], size=(M_CAUSAL, N_SAMPLES)
                         ).astype(np.int8)
    g = codes.T.astype(np.float64) @ beta
    eta = X @ np.array([0.3, -0.2, 0.1]) - 1.5 + g
    y = (rng.random(N_SAMPLES) < 1 / (1 + np.exp(-eta))) * 1.0
    codes[rng.random(codes.shape) < 0.005] = 3
    gds = str(tmp_path_factory.mktemp("torch_gxg_start") / "grm.gds")
    write_seqarray_gds(gds, codes[:PANEL + 2])
    cols = {"sample.id": np.arange(1, N_SAMPLES + 1), "y": y,
            "x1": X[:, 0], "x2": X[:, 1], "x3": X[:, 2]}
    return gds, cols


@pytest.mark.parametrize("start", list(STARTS))
def test_approx_tau_start_matches_jax(data, start):
    gds, cols = data
    pairs = {"snp1": [PANEL + 1], "snp2": [PANEL + 2]}
    panel = np.arange(1, PANEL + 1)
    want = saigegds_tpu.gxg_spa(
        FORMULA, pd.DataFrame(cols), gds, pd.DataFrame(pairs),
        config=saigegds_tpu.NullModelConfig(tau_init=STARTS[start],
                                            grm_impl="packed2"),
        use_approx_tau=True, variant_id=panel)
    got = sgt.gxg_spa(FORMULA, cols, gds, pairs,
                      config=sgt.NullModelConfig(tau_init=STARTS[start]),
                      use_approx_tau=True, variant_id=panel, device="cpu")
    tau = want["tau_G"].to_numpy()
    np.testing.assert_allclose(got["tau_G"], tau, rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(got["pval"], want["pval"].to_numpy(),
                               rtol=1e-8)
    if start == "default":
        assert tau[0] == 0.0 and got["tau_G"][0] == 0.0
    else:
        assert tau[0] > 0.0 and got["tau_G"][0] > 0.0
