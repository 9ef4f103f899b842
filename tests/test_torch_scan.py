"""The PyTorch port's whole scan slice (``assoc_spa`` on the CPU) against
the JAX package's ``assoc_spa``.

Both read one GDS written by the JAX package's writer and one null model
built from its GLM helpers, carried across with ``NullModel.from_arrays``
or through a ``.npz`` the JAX package saved.  The JAX scan runs with
``packed_sparse=False``: its dense 2-bit transport is what the port
implements (the JAX package also chooses it on a link that keeps up).

Tolerance: the same variant rows and columns in the same order; AF.alt,
mac, num and the converged flags exact; p-values (SPA and p.norm) within
1e-10 relative (the reference contract is 1e-7), beta and SE likewise —
phase 1 agrees to ~1e-13 (test_torch_score_packed) and the SPA tail to
~1e-13 (test_torch_spa), both far inside it.  The all-het corner variant
has a constant imputed dosage: its covariate-adjusted genotype is
round-off, so its statistics are noise in both packages and are compared
only for presence and counts.
"""

import numpy as np
import pandas as pd
import pytest

from _torch_synth import one_torch_thread  # noqa: F401 (autouse)
from _torch_synth import jax_null_model, synth_codes, synth_pheno, \
    var_ratio_table
import saigegds_tpu
import saigegds_tpu_torch
from saigegds_tpu.io.gds_write import write_seqarray_gds
from saigegds_tpu_torch import NullModel, ScanConfig, assoc_spa, save_assoc
from saigegds_tpu_torch.io.gds import open_gds

RTOL_P = 1e-10
N_SAMPLES, N_VARIANTS, BLOCK = 1031, 300, 64     # ragged last block
ALL_HET_ID = 3           # variant.id of synth_codes' all-het row
COLUMNS = ["id", "chr", "pos", "rs.id", "ref", "alt", "AF.alt", "mac",
           "num", "beta", "SE", "pval", "p.norm", "converged"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_scan")
    rng = np.random.default_rng(41)
    X, y = synth_pheno(rng, N_SAMPLES)
    codes = synth_codes(rng, N_VARIANTS, N_SAMPLES, y=y)
    gds = str(tmp / "geno.gds")
    write_seqarray_gds(gds, codes, compress="ZIP_ra",
                       rs_id=[f"rs{i}" for i in range(N_VARIANTS)])
    return tmp, gds, X, y


@pytest.fixture(scope="module", params=["pooled", "cat"])
def scans(request, data):
    """(jax table, jax model) for one variance-ratio table."""
    tmp, gds, X, y = data
    jm = jax_null_model(X, y, var_ratio_table(request.param))
    want = saigegds_tpu.assoc_spa(
        gds, jm, saigegds_tpu.ScanConfig(packed_sparse=False,
                                         block_size=BLOCK))
    return want, jm


def _assert_tables_match(got: dict, want: pd.DataFrame):
    assert list(got) == list(want.columns) == COLUMNS
    n = len(want)
    assert all(len(v) == n for v in got.values())
    for c in ("id", "chr", "pos", "rs.id", "ref", "alt", "AF.alt", "mac",
              "num", "converged"):
        np.testing.assert_array_equal(np.asarray(got[c]),
                                      want[c].to_numpy(), err_msg=c)
    assert got["num"].dtype == np.int32
    ok = got["id"] != ALL_HET_ID
    assert (~ok).sum() == 1
    for c in ("pval", "p.norm", "beta", "SE"):
        np.testing.assert_allclose(got[c][ok], want[c].to_numpy()[ok],
                                   rtol=RTOL_P,
                                   err_msg=c)


def test_scan_matches_jax_from_arrays(data, scans):
    _, gds, _, _ = data
    want, jm = scans
    got = assoc_spa(gds, NullModel.from_arrays(vars(jm)),
                    ScanConfig(block_size=BLOCK), device="cpu")
    _assert_tables_match(got, want)
    assert len(want) > 200      # the mac >= 10 filter drops the rarest
    refined = got["pval"] != got["p.norm"]
    assert refined.sum() >= 3 and got["pval"].min() < 1e-8


def test_scan_matches_jax_from_npz(data, scans):
    tmp, gds, _, _ = data
    want, jm = scans
    path = str(tmp / "model.npz")
    jm.save(path)
    instrument = {}
    got = assoc_spa(gds, path, ScanConfig(block_size=BLOCK), device="cpu",
                    instrument=instrument)
    _assert_tables_match(got, want)
    assert len(instrument["decode_s"]) == -(-N_VARIANTS // BLOCK)
    assert instrument["spa_n"] >= (got["pval"] != got["p.norm"]).sum() > 0


def test_incremental_spa_flush(data, scans, monkeypatch):
    """Phase 2 refined block by block (the host-memory budget spent after
    every block) gives the table of one flush at the end."""
    import saigegds_tpu_torch.assoc.single as single
    _, gds, _, _ = data
    want, jm = scans
    monkeypatch.setattr(single, "SPA_FLUSH_BYTES", 1)
    got = assoc_spa(gds, NullModel.from_arrays(vars(jm)),
                    ScanConfig(block_size=BLOCK), device="cpu")
    _assert_tables_match(got, want)


def test_spa_without_compaction(data):
    """``spa_compact=False`` (no nnz grouping, full-width CGF) in both
    packages."""
    _, gds, X, y = data
    jm = jax_null_model(X, y, var_ratio_table("pooled"))
    want = saigegds_tpu.assoc_spa(
        gds, jm, saigegds_tpu.ScanConfig(packed_sparse=False,
                                         block_size=BLOCK,
                                         spa_compact=False))
    got = assoc_spa(gds, NullModel.from_arrays(vars(jm)),
                    ScanConfig(block_size=BLOCK, spa_compact=False),
                    device="cpu")
    _assert_tables_match(got, want)


def test_model_npz_roundtrip(data, tmp_path):
    _, _, X, y = data
    jm = jax_null_model(X, y, var_ratio_table("cat"))
    m = NullModel.from_arrays(vars(jm))
    m.save(str(tmp_path / "m.npz"))
    back = saigegds_tpu.NullModel.load(str(tmp_path / "m.npz"))
    for f in ("y", "mu", "XV", "XXVX_inv", "tau", "fitted_values"):
        np.testing.assert_array_equal(getattr(back, f), getattr(jm, f))
    np.testing.assert_array_equal(back.var_ratio["mac_bins"],
                                  jm.var_ratio["mac_bins"])


def test_saved_gds_reads_back(data, scans, tmp_path):
    _, gds, _, _ = data
    want, jm = scans
    out = str(tmp_path / "res.gds")
    got = assoc_spa(gds, NullModel.from_arrays(vars(jm)),
                    ScanConfig(block_size=BLOCK), res_savefn=out,
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
    # the JAX package's reader takes the port's output too
    from saigegds_tpu.utils.stats import load_pval
    np.testing.assert_array_equal(load_pval(out)["pval"].to_numpy(),
                                  got["pval"])


@pytest.mark.parametrize("ext", [".csv", ".tsv"])
def test_saved_text_reads_back(data, scans, tmp_path, ext):
    _, gds, _, _ = data
    _, jm = scans
    got = assoc_spa(gds, NullModel.from_arrays(vars(jm)),
                    ScanConfig(block_size=BLOCK), device="cpu")
    out = str(tmp_path / f"res{ext}")
    save_assoc(got, out)
    back = pd.read_csv(out, sep="," if ext == ".csv" else "\t",
                       float_precision="round_trip")
    assert list(back.columns) == COLUMNS
    for c in ("pval", "beta", "SE", "AF.alt"):
        np.testing.assert_array_equal(back[c].to_numpy(), got[c])
    np.testing.assert_array_equal(back["converged"].to_numpy(),
                                  got["converged"])


def test_int8_route_matches_default(data, scans):
    """``packed_2bit=False`` ships each int8 block as it is (kernel B4 on
    the card): the table is exactly the default 2-bit route's, and both
    match the JAX package's."""
    _, gds, _, _ = data
    want, jm = scans
    model = NullModel.from_arrays(vars(jm))
    got = assoc_spa(gds, model, ScanConfig(block_size=BLOCK,
                                           packed_2bit=False), device="cpu")
    default = assoc_spa(gds, model, ScanConfig(block_size=BLOCK),
                        device="cpu")
    assert list(got) == list(default)
    for c in got:
        np.testing.assert_array_equal(got[c], default[c], err_msg=c)
    _assert_tables_match(got, want)


def test_public_names():
    for name in ("NullModel", "assoc_spa", "save_assoc", "ScanConfig",
                 "NullModelConfig"):
        assert hasattr(saigegds_tpu_torch, name)
