"""The PyTorch port's dense dosage route of the scan (``assoc_spa`` over an
imputed DS node, ``dsnode="$dosage_alt"``, ``use_packed=False``; and
``assoc_spa_user``) on the CPU, against the JAX package's.

The DS file (the JAX package's ``write_dosage_gds``) holds hard calls
turned into imputed dosages (``tests/_torch_synth.py`` ``synth_dosages``:
noise, clipped, rounded to 0.001, NaN missing), with one block of
integer-valued rows, which ship f32 (lossless), while the fractional
blocks ship f64.  The JAX package scans dosages through its jitted f64
``score_stats_*`` on blocks padded to the block size; the port through its
f64 torch version on the unpadded block.

Tolerance: the same variant rows and columns in the same order; id, chr,
pos, rs.id, ref, alt, num and converged exact; AF.alt, mac, p-values
(SPA and p.norm), beta and SE within 1e-10 relative with the same NaN
pattern (the reference contract is 1e-7), and the same SPA set (the rows
with ``p.norm <= spa_pval``).  The f64
sums over samples run in another order in the two packages (XLA against
torch), so even AF.alt of a fractional row agrees to round-off, not bit
for bit.  The port's dense route against its own packed route on hard
calls: within 1e-10 (the packed route's phase-1 sums are exact integers).
On hard calls the all-het corner variant has a constant imputed dosage:
its covariate-adjusted genotype is round-off, so its statistics are noise
in every route and are compared only for presence and counts, as in
``test_torch_scan.py``.
"""

import sys

import numpy as np
import pytest

from _torch_synth import one_torch_thread  # noqa: F401 (autouse)
from _torch_synth import jax_null_model, jax_quant_null_model, \
    synth_codes, synth_dosages, synth_pheno, synth_quant_pheno, \
    var_ratio_table
import saigegds_tpu
from saigegds_tpu.io.gds_write import write_dosage_gds, write_seqarray_gds
import saigegds_tpu_torch as sg
from saigegds_tpu_torch.assoc import single
from saigegds_tpu_torch.assoc.single import _shrink_f32

RTOL = 1e-10
N_SAMPLES, N_VARIANTS, BLOCK = 1031, 300, 64      # ragged last block
INT_BLOCK = range(BLOCK, 2 * BLOCK)               # the integer-valued block
N_EXTRA = 13
EXACT = ("id", "chr", "pos", "rs.id", "ref", "alt", "num", "converged")
ALL_HET_ID = 3           # variant.id of synth_codes' all-het row


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_dosage_scan")
    rng = np.random.default_rng(17)
    X, y = synth_pheno(rng, N_SAMPLES)
    Xq, yq = synth_quant_pheno(rng, N_SAMPLES)
    codes = synth_codes(rng, N_VARIANTS, N_SAMPLES, y=y)
    ds = synth_dosages(rng, codes, integer_rows=INT_BLOCK)
    geno = str(tmp / "geno.gds")
    write_seqarray_gds(geno, codes, compress="ZIP_ra")
    dsf = str(tmp / "ds.gds")
    write_dosage_gds(dsf, ds, compress="ZIP_ra")
    # the DS file with N_EXTRA samples the model lacks, columns shuffled
    perm = rng.permutation(N_SAMPLES + N_EXTRA)
    ds_x = np.concatenate([ds, rng.uniform(0, 2, (N_VARIANTS, N_EXTRA))],
                          axis=1)[:, perm]
    sid = np.concatenate([np.arange(1, N_SAMPLES + 1),
                          10**6 + np.arange(N_EXTRA)])[perm].astype(np.int32)
    dsx = str(tmp / "ds_extra.gds")
    write_dosage_gds(dsx, ds_x, sample_id=sid, compress="ZIP_ra")
    models = {
        "binary": jax_null_model(X, y, var_ratio_table("pooled")),
        "binary_cat": jax_null_model(X, y, var_ratio_table("cat")),
        "quant": jax_quant_null_model(Xq, yq, var_ratio_table("pooled")),
    }
    return dict(geno=geno, ds=dsf, ds_extra=dsx, dosages=ds, codes=codes,
                models=models)


def _spa_set(tab) -> np.ndarray:
    """The rows phase 1 sent to SPA (``p.norm <= spa_pval``)."""
    return np.asarray(tab["p.norm"]) <= sg.ScanConfig().spa_pval


def _assert_match(got: dict, want, rtol=RTOL, hard_calls=False):
    """``want``: a JAX DataFrame or a port table; ``hard_calls`` leaves the
    all-het row's statistics out."""
    cols = list(want.columns) if hasattr(want, "columns") else list(want)
    assert list(got) == cols
    n = len(want[cols[0]])
    assert n and all(len(v) == n for v in got.values())
    keep = np.asarray(got["id"]) != ALL_HET_ID if hard_calls \
        else np.ones(n, bool)
    for c in cols:
        a, b = np.asarray(got[c]), np.asarray(want[c])
        if c not in EXACT:
            a, b = a[keep], b[keep]
        if c in EXACT:
            np.testing.assert_array_equal(a, b, err_msg=c)
        else:
            np.testing.assert_array_equal(np.isnan(a), np.isnan(b),
                                          err_msg=c)
            np.testing.assert_allclose(a, b, rtol=rtol, atol=0, err_msg=c)
    if "p.norm" in cols:
        np.testing.assert_array_equal(_spa_set(got), _spa_set(want))


def _jax(path, jm, **kw):
    return saigegds_tpu.assoc_spa(
        path, jm, saigegds_tpu.ScanConfig(block_size=BLOCK, **kw))


def _port(path, jm, instrument=None, **kw):
    return sg.assoc_spa(path, sg.NullModel.from_arrays(vars(jm)),
                        sg.ScanConfig(block_size=BLOCK, **kw),
                        instrument=instrument, device="cpu")


@pytest.mark.parametrize("kind", ["binary", "binary_cat", "quant"])
def test_ds_scan_matches_jax(data, kind):
    """An imputed DS node, found without ``dsnode`` (no genotype node)."""
    jm = data["models"][kind]
    inst = {}
    got = _port(data["ds"], jm, instrument=inst)
    _assert_match(got, _jax(data["ds"], jm))
    if kind != "quant":
        assert inst["spa_n"] > 0 and _spa_set(got).any()
    else:
        assert "p.norm" not in got and inst["spa_n"] == 0


@pytest.mark.parametrize("kind", ["binary", "quant"])
@pytest.mark.parametrize("how", ["dosage_alt", "use_packed_false"])
def test_genotype_node_dense_matches_jax(data, kind, how):
    """``dsnode="$dosage_alt"`` and ``use_packed=False`` over a genotype
    node take the dense route in both packages."""
    jm = data["models"][kind]
    kw = {"dsnode": "$dosage_alt"} if how == "dosage_alt" \
        else {"use_packed": False}
    _assert_match(_port(data["geno"], jm, **kw),
                  _jax(data["geno"], jm, **kw), hard_calls=True)


@pytest.mark.parametrize("kind", ["binary", "quant"])
def test_dense_equals_packed_on_hard_calls(data, kind):
    """The port's dense route and its packed route (kernel B3's plain
    version) give the same table on hard calls."""
    jm = data["models"][kind]
    dense = _port(data["geno"], jm, dsnode="$dosage_alt")
    packed = _port(data["geno"], jm)
    _assert_match(dense, packed, hard_calls=True)


@pytest.mark.parametrize("kind", ["binary", "quant"])
def test_model_over_subset_of_ds_samples(data, kind):
    """A DS file whose samples are a shuffled superset of the model's: the
    blocks are gathered to the model's samples, in both packages, and the
    table equals the scan of the file in model order."""
    jm = data["models"][kind]
    inst = {}
    got = _port(data["ds_extra"], jm, instrument=inst)
    assert len(inst["gather_s"]) == -(-N_VARIANTS // BLOCK)
    _assert_match(got, _jax(data["ds_extra"], jm))
    _assert_match(got, _port(data["ds"], jm))


@pytest.mark.parametrize("kind", ["binary", "quant"])
def test_subset_model_dense_equals_packed_gather(data, kind, tmp_path):
    """On hard calls with a model over a reordering and subset of the GDS
    samples, the JAX package goes dense and the port keeps its packed
    gather; the port's dense route (``use_packed=False``) agrees with
    both."""
    codes = data["codes"]
    rng = np.random.default_rng(3)
    perm = rng.permutation(N_SAMPLES + N_EXTRA)
    c = np.concatenate([codes, rng.integers(0, 3, (N_VARIANTS, N_EXTRA))
                        .astype(np.int8)], axis=1)[:, perm]
    sid = np.concatenate([np.arange(1, N_SAMPLES + 1),
                          10**6 + np.arange(N_EXTRA)])[perm].astype(np.int32)
    path = str(tmp_path / "geno_extra.gds")
    write_seqarray_gds(path, c, sample_id=sid)
    jm = data["models"][kind]
    packed = _port(path, jm)
    dense = _port(path, jm, use_packed=False)
    _assert_match(dense, packed, hard_calls=True)
    _assert_match(packed, _jax(path, jm), hard_calls=True)


def test_f32_shipping(data, monkeypatch):
    """Integer-valued blocks ship f32 and fractional ones f64; both widen
    to the same f64 values.  The bytes shipped are read where phase 1
    uploads each block (``_upload`` calling ``_to_device``)."""
    ds = data["dosages"]
    assert _shrink_f32(ds[INT_BLOCK]).dtype == np.float32
    assert _shrink_f32(ds[:BLOCK]).dtype == np.float64
    exact = np.float32(np.arange(0, 2.001, 0.25))[None, :].astype(np.float64)
    assert _shrink_f32(exact).dtype == np.float32
    # past f32's range, below its smallest value, a late fractional row
    for bad in (1e300, 1e-300, 0.1):
        G = np.ones((300, 5000))
        G[:, 7] = np.nan
        G[-1, -1] = bad
        assert _shrink_f32(G) is G
        G[-1, -1] = 0.5
        np.testing.assert_array_equal(_shrink_f32(G), G)
    shipped, real = [], single._to_device

    def to_device(a, device):
        if sys._getframe(1).f_code.co_name == "_upload":
            shipped.append(a.nbytes)
        return real(a, device)

    monkeypatch.setattr(single, "_to_device", to_device)
    _port(data["ds"], data["models"]["binary"])
    rows = [min(BLOCK, N_VARIANTS - s) for s in range(0, N_VARIANTS, BLOCK)]
    want = [r * N_SAMPLES * (4 if i == 1 else 8) for i, r in enumerate(rows)]
    assert shipped == want


@pytest.mark.parametrize("kind", ["binary", "quant"])
def test_assoc_spa_user_matches_jax(data, kind):
    """``assoc_spa_user`` over dosages from a callback, named by
    ``variant_id``, against the JAX package's and against the DS scan."""
    jm = data["models"][kind]
    ds = data["dosages"]
    vid = np.asarray([f"v{i}" for i in range(N_VARIANTS)], object)
    fn = lambda s, e: ds[s:e]
    cfg = dict(block_size=BLOCK)
    want = saigegds_tpu.assoc.single.assoc_spa_user(
        fn, N_VARIANTS, jm, saigegds_tpu.ScanConfig(**cfg), variant_id=vid)
    got = sg.assoc_spa_user(fn, N_VARIANTS, sg.NullModel.from_arrays(vars(jm)),
                            sg.ScanConfig(**cfg), variant_id=vid,
                            device="cpu")
    _assert_match(got, want)
    scan = _port(data["ds"], jm)
    for c in list(got)[1:]:
        np.testing.assert_array_equal(got[c], scan[c], err_msg=c)
    np.testing.assert_array_equal(got["id"], vid[scan["id"] - 1])


def test_assoc_spa_user_checks_shape(data):
    jm = data["models"]["binary"]
    ds = data["dosages"]
    with pytest.raises(ValueError, match="expected"):
        sg.assoc_spa_user(lambda s, e: ds[s:e, :-1], N_VARIANTS,
                          sg.NullModel.from_arrays(vars(jm)),
                          sg.ScanConfig(block_size=BLOCK), device="cpu")
    got = sg.assoc_spa_user(lambda s, e: ds[s:e], 40,
                            sg.NullModel.from_arrays(vars(jm)),
                            sg.ScanConfig(block_size=BLOCK), device="cpu")
    # 1-based positions when no variant_id is given (row 1 is all missing)
    assert got["id"][0] == 2 and got["id"][-1] == 40


def test_public_names():
    assert sg.assoc_spa_user is sg.assoc.single.assoc_spa_user
