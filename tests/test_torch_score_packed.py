"""Phase 1 of the PyTorch port's scan (``score_stats_binary_packed``)
against the JAX package's routes, and the aggregate tests' device burden
collapse (``burden_score_packed``).

Tolerance: counts exact (AF, MAC, num, validity and SPA flags are built
from exact integer contractions); S, var, p, beta and SE within 1e-12
relative.  Both packages contract the same exact integers, but they
recombine the eight slices (an einsum) and run the f64 moment algebra in
their own summation order, so the last few bits may differ; the algebra's
cancellation stays far inside 1e-12 on non-degenerate variants.  The
all-het row has a constant imputed dosage, so its covariate-adjusted
genotype is round-off and its S/var are noise in both packages; it is
checked for validity only.

The port's three routes (2-bit through B3, int8 through B4, the sparse
stream through B5 then B4) contract the same exact integers and share the
algebra after it, so they agree with each other bit for bit.  The burden
rows are an f64 product here and an exact integer-slice product in the
JAX package, each within a few ulps of the exact affine value: their
statistics agree within 1e-10 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_synth import one_torch_thread  # noqa: F401 (autouse)
from _torch_synth import jax_null_model, synth_codes, synth_pheno, \
    var_ratio_table
from saigegds_tpu.ops import score_packed as jsp
from saigegds_tpu.assoc import aggregate as jagg
from saigegds_tpu.ops.packed_grm import pack_codes_2bit
from saigegds_tpu.ops.score import ScanParams as JaxScanParams
from saigegds_tpu.ops.sparse_codes import encode_sparse_rows, pad_entries
from saigegds_tpu_torch.models.nullmodel import NullModel
from saigegds_tpu_torch.ops import score_packed as tsp
from saigegds_tpu_torch.ops.score import ScanParams
from saigegds_tpu_torch.ops.sparse_codes import \
    encode_sparse_rows as t_encode

RTOL = 1e-12
N_SAMPLES = 1031
ALL_HET_ROW = 2


@pytest.fixture(scope="module", params=["pooled", "mac_categories"])
def setup(request):
    rng = np.random.default_rng(21)
    X, y = synth_pheno(rng, N_SAMPLES)
    codes = synth_codes(rng, 150, N_SAMPLES, y=y)
    jm = jax_null_model(X, y, var_ratio_table(
        "pooled" if request.param == "pooled" else "cat"))
    jpm = jsp.pack_scan_model(jm.scan_model())
    tpm = tsp.pack_scan_model(NullModel.from_arrays(vars(jm))
                              .scan_model(device="cpu"))
    return pack_codes_2bit(codes), jpm, tpm, codes


def _params(spa_pval=0.05):
    return dict(maf=-1.0, mac=1.0, missing=0.1, spa_pval=spa_pval)


def test_moments_match(setup):
    """The f64 moment algebra around the contraction: S and var."""
    packed, jpm, tpm, _ = setup
    want = jsp._packed_phase1(jpm, JaxScanParams(**_params()),
                              jnp.asarray(packed), "xla2")
    got = tsp._packed_phase1(tpm, ScanParams(**_params()),
                             torch.from_numpy(packed))
    for f in ("valid", "flip", "af", "mac", "num"):
        np.testing.assert_array_equal(got[f].numpy(), np.asarray(want[f]),
                                      err_msg=f)
    keep = np.array(want["valid"])
    keep[ALL_HET_ROW] = False
    for f in ("S", "var"):
        np.testing.assert_allclose(got[f].numpy()[keep],
                                   np.asarray(want[f])[keep], rtol=RTOL,
                                   err_msg=f)


@pytest.mark.parametrize("impl", ["xla2", "pallas2_interpret"])
def test_score_stats_match(setup, impl):
    packed, jpm, tpm, _ = setup
    want = jsp.score_stats_binary_packed(jpm, JaxScanParams(**_params()),
                                         jnp.asarray(packed), impl=impl)
    got = tsp.score_stats_binary_packed(tpm, ScanParams(**_params()),
                                        torch.from_numpy(packed))
    for f in ("valid", "need_spa", "af", "mac", "num"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    v = np.array(want.valid)
    assert v.sum() > 100 and np.asarray(want.need_spa).sum() >= 4
    assert got.pval.dtype == torch.float64
    v[ALL_HET_ROW] = False
    for f in ("beta", "se", "pval"):
        np.testing.assert_allclose(getattr(got, f).numpy()[v],
                                   np.asarray(getattr(want, f))[v],
                                   rtol=RTOL, err_msg=f)


def test_filters_and_padding_rows(setup):
    """Filter thresholds and ragged blocks: an all-missing padded row and
    a MAC/missing cut give the same validity in both packages."""
    packed, jpm, tpm, _ = setup
    extra = np.full((3, packed.shape[1]), 0xFF, np.uint8)   # all missing
    block = np.concatenate([packed[:61], extra])
    p = dict(maf=0.01, mac=12.0, missing=0.02, spa_pval=0.2)
    want = jsp.score_stats_binary_packed(jpm, JaxScanParams(**p),
                                         jnp.asarray(block), impl="xla2")
    got = tsp.score_stats_binary_packed(tpm, ScanParams(**p),
                                        torch.from_numpy(block))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.need_spa.numpy(),
                                  np.asarray(want.need_spa))
    assert not got.valid[-3:].any()


ROUTE_FIELDS = ("valid", "need_spa", "af", "mac", "num", "beta", "se",
                "pval")


def _payloads(codes):
    """The block on the port's three routes (host arrays -> tensors)."""
    entries, row_ptr = t_encode(codes)
    return {"2bit": torch.from_numpy(pack_codes_2bit(codes)),
            "int8": torch.from_numpy(codes),
            "sparse": (torch.from_numpy(entries),
                       torch.from_numpy(row_ptr))}


def test_routes_bit_equal(setup):
    _, _, tpm, codes = setup
    params = ScanParams(**_params())
    res = {k: tsp.score_stats_binary_packed(tpm, params, p)
           for k, p in _payloads(codes).items()}
    for k in ("int8", "sparse"):
        for f in ROUTE_FIELDS:                 # NaN rows compare equal
            np.testing.assert_array_equal(getattr(res[k], f).numpy(),
                                          getattr(res["2bit"], f).numpy(),
                                          err_msg=f"{k} {f}")


@pytest.mark.parametrize("route", ["2bit", "int8", "sparse"])
def test_route_matches_jax(setup, route):
    """Each route against the JAX package's own route for it: ``xla2``,
    ``xla`` and ``sparse`` (XLA decode, then the int8 contraction)."""
    _, jpm, tpm, codes = setup
    if route == "sparse":
        e, rp = encode_sparse_rows(codes)
        jpay = (jnp.asarray(pad_entries(e)), jnp.asarray(rp))
    else:
        jpay = jnp.asarray(pack_codes_2bit(codes) if route == "2bit"
                           else codes)
    impl = {"2bit": "xla2", "int8": "xla", "sparse": "sparse"}[route]
    want = jsp.score_stats_binary_packed(jpm, JaxScanParams(**_params()),
                                         jpay, impl=impl)
    got = tsp.score_stats_binary_packed(tpm, ScanParams(**_params()),
                                        _payloads(codes)[route])
    for f in ("valid", "need_spa", "af", "mac", "num"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    v = np.array(want.valid)
    v[ALL_HET_ROW] = False
    for f in ("beta", "se", "pval"):
        np.testing.assert_allclose(getattr(got, f).numpy()[v],
                                   np.asarray(getattr(want, f))[v],
                                   rtol=RTOL, err_msg=f)


def _burden_coefficients(codes):
    """Block-diagonal (A, Bm, C) of three units' burden jobs (two weight
    schemes each), built by the JAX package's host algebra."""
    units = [np.arange(5, 20), np.arange(30, 41), np.arange(60, 100)]
    A = np.zeros((6, 66))
    Bm = np.zeros((6, 66))
    C = np.zeros(6)
    r0 = s0 = 0
    for idx in units:
        t = jagg._CodeTallies(codes[idx])
        w = np.stack([jagg._normalize(jagg.beta_weights(t.maf, b1, b2))
                      for b1, b2 in ((1.0, 1.0), (1.0, 25.0))])
        job = jagg._BurdenJob(codes[idx], w, t)
        A[r0:r0 + 2, s0:s0 + len(idx)] = job.A
        Bm[r0:r0 + 2, s0:s0 + len(idx)] = job.Bm
        C[r0:r0 + 2] = job.C
        r0, s0 = r0 + 2, s0 + len(idx)
    sel = np.concatenate(units)
    return codes[sel], A, Bm, C


@pytest.mark.parametrize("route", ["2bit", "sparse"])
def test_burden_matches_jax(setup, route):
    _, jpm, tpm, codes = setup
    codes, A, Bm, C = _burden_coefficients(codes)
    params = dict(maf=0.0, mac=0.0, missing=1.0, spa_pval=0.05)
    if route == "sparse":
        e, rp = encode_sparse_rows(codes)
        jpay = (jnp.asarray(pad_entries(e)), jnp.asarray(rp))
    else:
        jpay = jnp.asarray(pack_codes_2bit(codes))
    want = jsp.burden_score_packed(jpm.dense, JaxScanParams(**params), jpay,
                                   jnp.asarray(A), jnp.asarray(Bm),
                                   jnp.asarray(C))
    t = lambda a: torch.from_numpy(a)
    got = tsp.burden_score_packed(tpm.dense, ScanParams(**params),
                                  _payloads(codes)[route], t(A), t(Bm), t(C))
    for f in ("valid", "need_spa"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
    v = np.asarray(want.valid)
    assert v.sum() >= 5
    for f in ("af", "mac", "num", "beta", "se", "pval"):
        np.testing.assert_allclose(getattr(got, f).numpy()[v],
                                   np.asarray(getattr(want, f))[v],
                                   rtol=1e-10, err_msg=f)
