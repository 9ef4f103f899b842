"""Phase 2 of the PyTorch port's scan (``spa_refine_binary`` and the SPA
machinery) and its special functions, against the JAX package.

Tolerances: p-values within 1e-10 relative and convergence flags equal.
Both packages run the same damped Newton iteration to eps^0.25, but their
exp/log and reductions round differently in the last bits, which moves a
root by far less than the tolerance and the p-value (stationary at the
root) by less still.  beta and SE follow the p-value.  The special
functions are compared within 1e-13 relative down to p ~ 1e-300: both wrap
erfc and ndtri implementations accurate to a few ulp.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_synth import one_torch_thread  # noqa: F401 (autouse)
from _torch_synth import jax_null_model, synth_codes, synth_pheno, \
    var_ratio_table
from saigegds_tpu.ops import score as jsc
from saigegds_tpu.ops import score_packed as jsp
from saigegds_tpu.ops import spa as jspa
from saigegds_tpu.ops import special as jspecial
from saigegds_tpu.ops.packed_grm import pack_codes_2bit
from saigegds_tpu_torch.models.nullmodel import NullModel
from saigegds_tpu_torch.ops import score as tsc
from saigegds_tpu_torch.ops import spa as tspa
from saigegds_tpu_torch.ops import special as tspecial

RTOL_P = 1e-10
N_SAMPLES = 1031


@pytest.fixture(scope="module")
def flagged():
    """Variants phase 1 flags for SPA, as int8 codes, and both models."""
    rng = np.random.default_rng(31)
    X, y = synth_pheno(rng, N_SAMPLES)
    codes = synth_codes(rng, 300, N_SAMPLES, y=y)
    jm = jax_null_model(X, y, var_ratio_table("cat"))
    jsm = jm.scan_model()
    params = jsc.ScanParams(maf=-1.0, mac=1.0, missing=0.1, spa_pval=0.05)
    res = jsp.score_stats_binary_packed(
        jsp.pack_scan_model(jsm), params, jnp.asarray(pack_codes_2bit(codes)),
        impl="xla2")
    need = np.asarray(res.need_spa)
    tsm = NullModel.from_arrays(vars(jm)).scan_model(device="cpu")
    return codes[need], jsm, tsm


def _nnz(codes):
    from saigegds_tpu.assoc.single import _spa_nnz
    return _spa_nnz(codes)


@pytest.mark.parametrize("mode", ["full", "compact_rare", "compact_all"])
def test_spa_refine_matches(flagged, mode):
    codes, jsm, tsm = flagged
    if mode == "compact_rare":
        # a rare-variant batch: the CGF runs over the top-cap lanes only
        codes = codes[_nnz(codes) < 120]
        cap = 128
    else:
        cap = 1024 if mode == "compact_all" else 0   # 1024 < N: engaged
    assert len(codes) >= 3
    packed = pack_codes_2bit(codes)
    want = jsc.spa_refine_binary(jsm, jnp.asarray(packed), cap=cap,
                                 packed_n=N_SAMPLES)
    got = tsc.spa_refine_binary(tsm, torch.from_numpy(packed), cap=cap,
                                packed_n=N_SAMPLES)
    p_want = np.asarray(want[0])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), p_want, rtol=RTOL_P)
    for i in (2, 3):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]),
                                   rtol=RTOL_P)
    assert p_want.min() < 1e-6      # the batch reaches the SPA tail


def test_saddle_prob_batch_corners():
    """Lanes out of the CGF's range, a Gaussian remainder (partial mask),
    statistics below the cutoff, and a zero SPA value."""
    rng = np.random.default_rng(5)
    B, N = 12, 64
    g = rng.normal(size=(B, N))
    mu = rng.uniform(0.02, 0.4, size=N)
    mask = rng.random((B, N)) < 0.6
    mask[:3] = True
    m1 = (g * mu).sum(axis=1)
    var2 = (g * g * mu * (1 - mu)).sum(axis=1)
    q = m1 + np.sqrt(var2) * np.array([0.5, 2.5, 4.0, 6.0, -3.0, 1.9,
                                       8.0, -7.0, 3.3, 5.1, 1e3, -1e3])
    args = (q, m1, var2, g, mu, mask)
    want = jspa.saddle_prob_batch(*map(jnp.asarray, args), cutoff=2.0)
    got = tspa.saddle_prob_batch(*map(torch.from_numpy, args), cutoff=2.0)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=RTOL_P)


def test_special_functions_to_1e300():
    x = np.concatenate([np.linspace(0, 50, 101), np.geomspace(50, 1370, 60),
                        [-1.0, np.inf, np.nan]])
    np.testing.assert_allclose(tspecial.pchisq1_sf(torch.from_numpy(x)),
                               np.asarray(jspecial.pchisq1_sf(x)), rtol=1e-13)
    z = np.concatenate([np.linspace(-8, 8, 161), np.linspace(8, 37, 30)])
    np.testing.assert_allclose(tspecial.pnorm_sf(torch.from_numpy(z)),
                               np.asarray(jspecial.pnorm_sf(z)), rtol=1e-13)
    p = np.concatenate([np.geomspace(1e-300, 0.5, 200), [0.9, 1 - 1e-12]])
    np.testing.assert_allclose(tspecial.qnorm(torch.from_numpy(p)),
                               np.asarray(jspecial.qnorm(p)), rtol=1e-13)
    assert float(tspecial.pchisq1_sf(torch.tensor(1370.0,
                                                  dtype=torch.float64))) > 0


@pytest.mark.parametrize("L", [1, 5, 511, 512, 513, 1031, 5000])
def test_row_sum_does_not_depend_on_the_batch(L):
    """A row's ``row_sum`` is the same bits alone, among other rows, at
    another place in the batch and with zero lanes appended."""
    rng = np.random.default_rng(L)
    x = torch.from_numpy(rng.normal(size=(7, L)) * 10.0 ** rng.uniform(
        -8, 8, (7, L)))
    alone = torch.stack([tspa.row_sum(x[i:i + 1])[0] for i in range(7)])
    assert torch.equal(tspa.row_sum(x), alone)
    assert torch.equal(tspa.row_sum(x.flip(0)), alone.flip(0))
    assert torch.equal(tspa.row_sum(tspa.pad_lanes(x, L + 700)), alone)
    np.testing.assert_allclose(alone.numpy(), x.numpy().sum(axis=1),
                               rtol=1e-9)


@pytest.mark.parametrize("cap", [0, 1024])
def test_spa_refine_does_not_depend_on_the_batch(flagged, cap):
    """Each flagged variant refined alone and within the whole flagged
    batch (and the batch reversed): the same p-value, beta and SE bit for
    bit, with and without the rare-variant compaction."""
    codes, _, tsm = flagged
    if cap:
        codes = codes[_nnz(codes) <= cap]
    G = torch.from_numpy(np.where(codes == 3, np.nan, codes).astype(
        np.float64))
    batch = tsc.spa_refine_binary(tsm, G, cap=cap)
    rev = tsc.spa_refine_binary(tsm, G.flip(0), cap=cap)
    for i in range(len(G)):
        one = tsc.spa_refine_binary(tsm, G[i:i + 1], cap=cap)
        for a, b, c in zip(one, batch, rev):
            assert torch.equal(a[0], b[i]) and torch.equal(a[0], c[-1 - i])
