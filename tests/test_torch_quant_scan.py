"""The PyTorch port's quantitative-trait scan against the JAX package's:
the dense score test (``score_stats_quant``), the packed phase 1
(``score_stats_quant_packed``) on its three routes, the device burden
collapse with the quantitative test, and the whole scan (``assoc_spa`` on
the CPU) from a model carried over by ``NullModel.from_arrays``.

The model comes from the JAX package's GLM helpers (``glm_gaussian``,
``obj_nok_quant``) with tau_E = 0.83, so Tstat's division by tau_E shows;
the phenotype is right-skewed and tied to eight variants.  Tolerance:
counts exact; p-values, beta and SE within 1e-10 relative (the reference
contract is 1e-7): both packages contract the same exact integers and
run the same f64 algebra in their own summation order.  The all-het
corner variant has a constant imputed dosage, so its statistics are noise
in both packages and are compared only for presence and counts.
"""

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from _torch_synth import one_torch_thread  # noqa: F401 (autouse)
from _torch_synth import jax_quant_null_model, synth_codes, \
    synth_quant_pheno, var_ratio_table
import saigegds_tpu
from saigegds_tpu.assoc import aggregate as jagg
from saigegds_tpu.io.gds_write import write_seqarray_gds
from saigegds_tpu.ops import score as jscore
from saigegds_tpu.ops import score_packed as jsp
from saigegds_tpu.ops.packed_grm import pack_codes_2bit
from saigegds_tpu.ops.score import ScanParams as JaxScanParams
from saigegds_tpu.ops.sparse_codes import encode_sparse_rows, pad_entries
from saigegds_tpu_torch import NullModel, ScanConfig, assoc_spa, save_assoc
from saigegds_tpu_torch.io.gds import open_gds
from saigegds_tpu_torch.ops import score as tscore
from saigegds_tpu_torch.ops import score_packed as tsp
from saigegds_tpu_torch.ops.score import ScanParams
from saigegds_tpu_torch.ops.sparse_codes import \
    encode_sparse_rows as t_encode

RTOL = 1e-10
N_SAMPLES, N_VARIANTS, BLOCK = 1031, 300, 64     # ragged last block
ALL_HET_ROW = 2          # synth_codes' all-het row (variant.id 3)
COLUMNS = ["id", "chr", "pos", "rs.id", "ref", "alt", "AF.alt", "mac",
           "num", "beta", "SE", "pval"]
PARAMS = dict(maf=-1.0, mac=1.0, missing=0.1, spa_pval=0.05)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Codes, a GDS of them and (X, y) of a skewed phenotype that eight
    variants move."""
    tmp = tmp_path_factory.mktemp("torch_quant_scan")
    rng = np.random.default_rng(43)
    codes = synth_codes(rng, N_VARIANTS, N_SAMPLES)
    g0 = np.where(codes[6:14] == 3, 0, codes[6:14]).astype(np.float64)
    X, y = synth_quant_pheno(rng, N_SAMPLES,
                             g=np.linspace(0.1, 0.8, 8) @ g0)
    gds = str(tmp / "geno.gds")
    write_seqarray_gds(gds, codes, compress="ZIP_ra",
                       rs_id=[f"rs{i}" for i in range(N_VARIANTS)])
    return tmp, gds, codes, X, y


@pytest.fixture(scope="module", params=["pooled", "cat"])
def models(request, data):
    """(JAX model, port model) for one variance-ratio table."""
    _, _, _, X, y = data
    jm = jax_quant_null_model(X, y, var_ratio_table(request.param))
    return jm, NullModel.from_arrays(vars(jm))


def _assert_stats(got, want, fields=("beta", "se", "pval")):
    for f in ("valid", "need_spa", "af", "mac", "num"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert not got.need_spa.any()
    v = np.array(want.valid)
    assert v.sum() > 100
    v[ALL_HET_ROW] = False
    for f in fields:
        np.testing.assert_allclose(getattr(got, f).numpy()[v],
                                   np.asarray(getattr(want, f))[v],
                                   rtol=RTOL, err_msg=f)


def test_dense_score_matches_jax(data, models):
    _, _, codes, _, _ = data
    jm, tm = models
    G = np.where(codes[:150] == 3, np.nan, codes[:150]).astype(np.float64)
    want = jscore.score_stats_quant(jm.scan_model(),
                                    JaxScanParams(**PARAMS), jnp.asarray(G))
    got = tscore.score_stats_quant(tm.scan_model(device="cpu"),
                                   ScanParams(**PARAMS), torch.from_numpy(G))
    _assert_stats(got, want)
    assert np.nanmin(got.pval.numpy()) < 1e-6


def _payloads(codes):
    """The block on the port's three routes (host arrays -> tensors)."""
    entries, row_ptr = t_encode(codes)
    return {"2bit": torch.from_numpy(pack_codes_2bit(codes)),
            "int8": torch.from_numpy(codes),
            "sparse": (torch.from_numpy(entries),
                       torch.from_numpy(row_ptr))}


@pytest.mark.parametrize("route", ["2bit", "int8", "sparse"])
def test_packed_route_matches_jax(data, models, route):
    """Each route against the JAX package's own route for it: ``xla2``,
    ``xla`` and ``sparse``; the port's routes are bit-equal to each
    other."""
    _, _, codes, _, _ = data
    codes = codes[:150]
    jm, tm = models
    if route == "sparse":
        e, rp = encode_sparse_rows(codes)
        jpay = (jnp.asarray(pad_entries(e)), jnp.asarray(rp))
    else:
        jpay = jnp.asarray(pack_codes_2bit(codes) if route == "2bit"
                           else codes)
    impl = {"2bit": "xla2", "int8": "xla", "sparse": "sparse"}[route]
    want = jsp.score_stats_quant_packed(
        jsp.pack_scan_model(jm.scan_model()), JaxScanParams(**PARAMS), jpay,
        impl=impl)
    tpm = tsp.pack_scan_model(tm.scan_model(device="cpu"))
    pay = _payloads(codes)
    got = tsp.score_stats_quant_packed(tpm, ScanParams(**PARAMS), pay[route])
    _assert_stats(got, want)
    base = tsp.score_stats_quant_packed(tpm, ScanParams(**PARAMS),
                                        pay["2bit"])
    for f in got._fields:                      # NaN rows compare equal
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      getattr(base, f).numpy(), err_msg=f)


@pytest.mark.parametrize("route", ["2bit", "sparse"])
def test_burden_quant_matches_jax(data, models, route):
    """The device burden collapse scored by the quantitative test
    (``binary=False``) against the JAX package's."""
    _, _, codes, _, _ = data
    jm, tm = models
    units = [np.arange(5, 20), np.arange(30, 41), np.arange(60, 100),
             np.arange(100, 130)]
    R, S = 2 * len(units), sum(len(u) for u in units)
    A, Bm, C = np.zeros((R, S)), np.zeros((R, S)), np.zeros(R)
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
    sub = codes[np.concatenate(units)]
    if route == "sparse":
        e, rp = encode_sparse_rows(sub)
        jpay = (jnp.asarray(pad_entries(e)), jnp.asarray(rp))
    else:
        jpay = jnp.asarray(pack_codes_2bit(sub))
    params = dict(maf=0.0, mac=0.0, missing=1.0, spa_pval=0.05)
    want = jsp.burden_score_packed(jm.scan_model(), JaxScanParams(**params),
                                   jpay, jnp.asarray(A), jnp.asarray(Bm),
                                   jnp.asarray(C), binary=False)
    t = torch.from_numpy
    got = tsp.burden_score_packed(tm.scan_model(device="cpu"),
                                  ScanParams(**params), _payloads(sub)[route],
                                  t(A), t(Bm), t(C), binary=False)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert not got.need_spa.any() and got.valid.sum() >= 6
    v = np.asarray(want.valid)
    for f in ("af", "mac", "num", "beta", "se", "pval"):
        np.testing.assert_allclose(getattr(got, f).numpy()[v],
                                   np.asarray(getattr(want, f))[v],
                                   rtol=RTOL, err_msg=f)


@pytest.fixture(scope="module")
def scans(data, models):
    """The JAX package's table for one model."""
    _, gds, _, _, _ = data
    jm, tm = models
    want = saigegds_tpu.assoc_spa(
        gds, jm, saigegds_tpu.ScanConfig(packed_sparse=False,
                                         block_size=BLOCK))
    return want, tm


def _assert_tables_match(got: dict, want: pd.DataFrame):
    assert list(got) == list(want.columns) == COLUMNS
    assert all(len(v) == len(want) for v in got.values())
    for c in ("id", "chr", "pos", "rs.id", "ref", "alt", "AF.alt", "mac",
              "num"):
        np.testing.assert_array_equal(np.asarray(got[c]),
                                      want[c].to_numpy(), err_msg=c)
    ok = got["id"] != ALL_HET_ROW + 1
    assert (~ok).sum() == 1
    for c in ("pval", "beta", "SE"):
        np.testing.assert_allclose(got[c][ok], want[c].to_numpy()[ok],
                                   rtol=RTOL, err_msg=c)


@pytest.mark.parametrize("packed_2bit", [True, False],
                         ids=["2bit_route", "int8_route"])
def test_scan_matches_jax(data, scans, packed_2bit):
    """Both phase-1 routes (B3, and B4 for ``packed_2bit=False``) give the
    JAX package's table; nothing goes to SPA."""
    _, gds, _, _, _ = data
    want, tm = scans
    inst = {}
    got = assoc_spa(gds, tm, ScanConfig(block_size=BLOCK,
                                        packed_2bit=packed_2bit),
                    instrument=inst, device="cpu")
    _assert_tables_match(got, want)
    assert len(want) > 200 and got["pval"].min() < 1e-6
    assert inst["spa_n"] == 0 and inst["spa_s"] < 1.0
    assert len(inst["decode_s"]) == -(-N_VARIANTS // BLOCK)


def test_scan_from_npz(data, scans):
    tmp, gds, _, _, _ = data
    want, tm = scans
    path = str(tmp / "quant_model.npz")
    tm.save(path)
    got = assoc_spa(gds, path, ScanConfig(block_size=BLOCK), device="cpu")
    _assert_tables_match(got, want)


def test_saved_gds_reads_back(data, scans, tmp_path):
    _, gds, _, _, _ = data
    _, tm = scans
    out = str(tmp_path / "res.gds")
    got = assoc_spa(gds, tm, ScanConfig(block_size=BLOCK), res_savefn=out,
                    device="cpu")
    root = open_gds(out).root
    assert root.attrs.get("FileFormat") == "SAIGE_OUTPUT"
    for c in COLUMNS:
        back = root[c].read()
        if got[c].dtype == object:
            assert [str(x) for x in back] == [str(x) for x in got[c]], c
        else:
            np.testing.assert_array_equal(back.astype(got[c].dtype),
                                          got[c], err_msg=c)
    from saigegds_tpu.utils.stats import load_pval
    back = load_pval(out)
    assert "p.norm" not in back.columns
    np.testing.assert_array_equal(back["pval"].to_numpy(), got["pval"])


@pytest.mark.parametrize("ext", [".csv", ".tsv"])
def test_saved_text_reads_back(data, scans, tmp_path, ext):
    _, gds, _, _, _ = data
    _, tm = scans
    got = assoc_spa(gds, tm, ScanConfig(block_size=BLOCK), device="cpu")
    out = str(tmp_path / f"res{ext}")
    save_assoc(got, out)
    back = pd.read_csv(out, sep="," if ext == ".csv" else "\t",
                       float_precision="round_trip")
    assert list(back.columns) == COLUMNS
    for c in ("pval", "beta", "SE", "AF.alt"):
        np.testing.assert_array_equal(back[c].to_numpy(), got[c])
