"""The PyTorch port's aggregate tests over imputed dosages (a DS node, and
``dsnode="$dosage_alt"``) on the CPU, against the JAX package's.

The DS file holds a rare-heavy exome (about 2,000 samples x 480 variants)
as imputed dosages: most samples exactly 0, carriers and a few
non-carriers fractional (rounded to 0.001), 1% missing, an all-missing SNP,
ALT-major SNPs, variants enriched in cases, and a run of integer-valued
(typed) variants.  Both packages collapse the burden rows on the host and
score them, and ACAT-V's single variants, as f64 rows: a batch of rows
that are all 0/1/2/NaN goes the packed way (the kernels' plain versions),
any other the dense f64 score test.  With ``block_size`` 16 the single
variants of the typed run fill whole packed batches while the others go
dense, so the units' rows split between the two routes.  One unit holds
a variant that shows the reference's floor-truncation quirk of
``ds_mat_burden`` (the mean and the flip decision use the sum of floors
of the fractional dosages, src/saige_main.cpp:590): its dosages are all
in [1.5, 2), so the floors never flip it although its ALT frequency is
near 0.9, and a missing value is imputed with the floored mean.

Tolerance: as ``test_torch_aggregate.py``: the same columns in the same
order; numvar, n.single and n.burden equal; summac and the MAF/MAC
summaries within 1e-12 relative; every p-value column within 1e-10
relative with the same NaN pattern (the reference contract is 1e-7).
The collapse itself is the same numpy arithmetic in both packages and is
held bit for bit.
"""

import numpy as np
import pytest

from _torch_synth import one_torch_thread  # noqa: F401 (autouse)
from _torch_synth import jax_null_model, jax_quant_null_model, \
    synth_pheno, synth_quant_pheno, var_ratio_table
from saigegds_tpu.assoc import aggregate as jagg
from saigegds_tpu.config import AggregateConfig as JaxAggregateConfig
from saigegds_tpu.io.gds_write import write_dosage_gds, write_seqarray_gds
from saigegds_tpu.io.seqarray import SeqData as JaxSeqData
import saigegds_tpu_torch as sg
from saigegds_tpu_torch.assoc import aggregate as tagg
from saigegds_tpu_torch.io.seqarray import SeqData

RTOL_P = 1e-10
RTOL_SUMMAC = 1e-12
N_SAMPLES, N_VARIANTS = 2003, 480
BATCH = 16
ALL_MISSING = 37
ENRICHED = range(60, 90)
TYPED = range(200, 330)          # integer-valued (typed) variants
QUIRK = 420                      # the floor-truncation variant
N_EXTRA = 11


def synth_exome_dosages(rng, y) -> np.ndarray:
    """f64 [M, N] dosages, NaN missing (see the module docstring)."""
    M, N = N_VARIANTS, N_SAMPLES
    u = rng.random(M)
    maf = np.where(u < 0.5, rng.uniform(0.0005, 0.003, M),
                   np.where(u < 0.85, rng.uniform(0.003, 0.03, M),
                            rng.uniform(0.03, 0.1, M)))
    codes = rng.binomial(2, maf[:, None], size=(M, N)).astype(np.int8)
    case = np.flatnonzero(y > 0.5)
    for i in ENRICHED:
        codes[i] = 0
        codes[i, rng.choice(case, rng.integers(8, 30), replace=False)] = 1
    flip = rng.random(M) < 0.1
    codes[flip] = 2 - codes[flip]
    ds = codes.astype(np.float64)
    noise = np.abs(rng.normal(size=(M, N))) * 0.2
    ds = np.where(codes == 2, ds - noise, np.where(codes == 1, ds + noise
                                                   * rng.choice([-1, 1],
                                                                (M, N)),
                                                   ds))
    stray = rng.random((M, N)) < 0.003            # non-carriers with dosage
    ds = np.where(stray & (codes == 0), rng.uniform(0.001, 0.3, (M, N)), ds)
    ds = np.round(np.clip(ds, 0.0, 2.0), 3)
    ds[TYPED] = codes[TYPED]
    ds[QUIRK] = np.round(rng.uniform(1.5, 1.999, N), 3)
    ds[rng.random((M, N)) < 0.01] = np.nan
    ds[ALL_MISSING] = np.nan
    return ds


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_dosage_aggregate")
    rng = np.random.default_rng(91)
    X, y = synth_pheno(rng, N_SAMPLES)
    Xq, yq = synth_quant_pheno(rng, N_SAMPLES)
    ds = synth_exome_dosages(rng, y)
    pos = np.cumsum(rng.integers(1, 60, N_VARIANTS))
    path = str(tmp / "exome_ds.gds")
    write_dosage_gds(path, ds, position=pos, compress="ZIP_ra")
    perm = rng.permutation(N_SAMPLES + N_EXTRA)
    ds_x = np.concatenate([ds, rng.uniform(0, 2, (N_VARIANTS, N_EXTRA))],
                          axis=1)[:, perm]
    sid = np.concatenate([np.arange(1, N_SAMPLES + 1),
                          10**6 + np.arange(N_EXTRA)])[perm].astype(np.int32)
    path_x = str(tmp / "exome_ds_extra.gds")
    write_dosage_gds(path_x, ds_x, sample_id=sid, position=pos,
                     compress="ZIP_ra")
    models = {"binary": jax_null_model(X, y, var_ratio_table("pooled")),
              "quant": jax_quant_null_model(Xq, yq,
                                            var_ratio_table("pooled"))}
    return dict(ds=path, ds_extra=path_x, dosages=ds, models=models,
                tmp=tmp)


def _groups():
    """Gene sets by variant id: runs of 4-30 variants, the typed run's
    edges inside mixed units, the floor-quirk unit, the all-missing SNP's
    unit, a one-SNP unit, an empty unit, and a scattered set."""
    rng = np.random.default_rng(8)
    groups, v = {}, 1
    while v <= N_VARIANTS:
        k = int(rng.integers(4, 31))
        groups[f"g{v}"] = list(range(v, min(v + k, N_VARIANTS + 1)))
        v += k
    groups["quirk"] = [QUIRK - 2, QUIRK, QUIRK + 1, QUIRK + 3]
    groups["with_missing"] = list(range(ALL_MISSING - 1, ALL_MISSING + 4))
    groups["single"] = [ENRICHED[0] + 1]
    groups["empty"] = []
    groups["scattered"] = [3, 150, 290, 470]
    return groups


def _units(path):
    ju = jagg.units_from_groups(JaxSeqData(path), _groups())
    tu = sg.units_from_groups(SeqData(path), _groups())
    return ju, tu


def _assert_tables_match(got: dict, want):
    assert list(got) == list(want.columns)
    assert all(len(v) == len(want) for v in got.values())
    for c in got:
        a, b = np.asarray(got[c]), want[c].to_numpy()
        if c in ("set", "numvar", "n.single", "n.burden") \
                or c.startswith("cvg"):
            np.testing.assert_array_equal(a, b, err_msg=c)
            continue
        a, b = a.astype(float), b.astype(float)
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=c)
        m = ~np.isnan(a)
        rtol = RTOL_SUMMAC if c.startswith(("summac", "maf", "mac")) \
            else RTOL_P
        np.testing.assert_allclose(a[m], b[m], rtol=rtol, err_msg=c)


def _run(test, path, jm, inst=None, **cfg):
    ju, tu = _units(path)
    want = getattr(jagg, test)(path, jm, ju,
                               JaxAggregateConfig(block_size=BATCH, **cfg))
    got = getattr(sg, test)(path, sg.NullModel.from_arrays(vars(jm)), tu,
                            sg.AggregateConfig(block_size=BATCH, **cfg),
                            instrument=inst, device="cpu")
    return got, want


@pytest.mark.parametrize("test", ["assoc_burden", "assoc_acat_v",
                                  "assoc_acat_o"])
def test_ds_units_match_jax(data, test):
    inst = {}
    got, want = _run(test, data["ds"], data["models"]["binary"], inst)
    _assert_tables_match(got, want)
    assert inst["spa_n"] > 0 and inst["rows_dense"] > 0
    if test != "assoc_burden":
        # the typed run's single variants go the packed way
        assert inst["rows_packed"] >= BATCH
        assert inst["payloads"]["dense"] > 0


def test_ds_quant_burden_matches_jax(data):
    inst = {}
    got, want = _run("assoc_burden", data["ds"], data["models"]["quant"],
                     inst)
    _assert_tables_match(got, want)
    assert not inst.get("spa_n") and "p.norm.b1_1" not in got


@pytest.mark.parametrize("test", ["assoc_burden", "assoc_acat_o"])
def test_model_over_subset_of_ds_samples(data, test):
    """A DS file with samples the model lacks, shuffled: the rows are
    gathered to the model's samples, and the table equals the JAX
    package's and the port's on the file in model order."""
    jm = data["models"]["binary"]
    got, want = _run(test, data["ds_extra"], jm)
    _assert_tables_match(got, want)
    base, _ = _run(test, data["ds"], jm)
    assert list(got) == list(base)
    for c in got:
        if np.asarray(got[c]).dtype.kind == "f":
            np.testing.assert_allclose(got[c], base[c], rtol=1e-12,
                                       err_msg=c)
        else:
            np.testing.assert_array_equal(got[c], base[c], err_msg=c)


@pytest.mark.parametrize("test", ["assoc_burden", "assoc_acat_o"])
def test_dosage_alt_matches_jax(data, test, tmp_path):
    """``dsnode="$dosage_alt"`` over a genotype node: the dosage route in
    both packages, and the port's agrees with its own code route."""
    rng = np.random.default_rng(4)
    codes = rng.binomial(2, rng.uniform(0.001, 0.05, (200, 1))[:, :1],
                         size=(200, 1500)).astype(np.int8)
    codes[rng.random(codes.shape) < 0.01] = 3
    path = str(tmp_path / "geno.gds")
    write_seqarray_gds(path, codes, position=np.arange(1, 201) * 10)
    X, y = synth_pheno(np.random.default_rng(5), 1500)
    jm = jax_null_model(X, y, var_ratio_table("pooled"))
    groups = {f"u{i}": list(range(i + 1, i + 21)) for i in range(0, 200, 20)}
    cfg = dict(dsnode="$dosage_alt", block_size=BATCH)
    want = getattr(jagg, test)(
        path, jm, jagg.units_from_groups(JaxSeqData(path), groups),
        JaxAggregateConfig(**cfg))
    tm = sg.NullModel.from_arrays(vars(jm))
    tu = sg.units_from_groups(SeqData(path), groups)
    got = getattr(sg, test)(path, tm, tu, sg.AggregateConfig(**cfg),
                            device="cpu")
    _assert_tables_match(got, want)
    codes_route = getattr(sg, test)(path, tm, tu,
                                    sg.AggregateConfig(block_size=BATCH),
                                    device="cpu")
    for c in got:
        if np.asarray(got[c]).dtype.kind == "f":
            np.testing.assert_allclose(got[c], codes_route[c], rtol=RTOL_P,
                                       err_msg=c)


def test_burden_collapse_floor_quirk(data):
    """The port's float collapse equals the JAX package's bit for bit,
    on the quirk variant (with a missing value) among fractional ones, and
    the floors change the result there."""
    ds = data["dosages"][[QUIRK - 2, QUIRK, QUIRK + 1, QUIRK + 3]]
    assert np.isnan(ds[1]).any()
    rng = np.random.default_rng(12)
    for k in range(4):
        w = rng.uniform(0.01, 2.0, len(ds))
        if k % 2:
            w[0] = np.nan
        want = jagg._burden_collapse(ds, w)
        got = tagg._burden_collapse(ds, w)
        np.testing.assert_array_equal(got, want)
    # the same collapse without the floors flips the quirk variant and
    # imputes its raw mean: a different vector
    finite = np.isfinite(ds[1])
    raw = np.where(finite, ds[1], ds[1][finite].mean())
    w = np.zeros(len(ds))
    w[1] = 1.0
    quirk = tagg._burden_collapse(ds, w)
    assert np.array_equal(quirk[finite], ds[1][finite])      # not flipped
    assert not np.allclose(quirk, 2.0 - raw)


def test_as_codes():
    """A block goes the packed way only when every dosage is 0, 1, 2 or
    missing, wherever the exception sits."""
    G = np.tile(np.array([0.0, 1.0, 2.0, np.nan]), (300, 1250))
    np.testing.assert_array_equal(tagg._as_codes(G),
                                  np.where(np.isnan(G), 3, G))
    for bad in (0.5, -1.0, 3.0, np.inf):
        H = G.copy()
        H[-1, -2] = bad
        assert tagg._as_codes(H) is None


def test_maf_mac_matches_jax(data):
    ds = data["dosages"][:64]
    for a, b in zip(tagg._maf_mac(ds), jagg._maf_mac(ds)):
        np.testing.assert_array_equal(a, b)


def test_spans_do_not_change_rows(data, monkeypatch):
    """``_UnitSource.rows`` reads scattered sets in bounded spans; a tiny
    span limit gives the same rows."""
    src = tagg._UnitSource(SeqData(data["ds"]), {})
    idx = np.asarray([400, 3, 150, 151, 290, 2])
    want = src.rows(idx)
    np.testing.assert_array_equal(want, data["dosages"][idx])
    monkeypatch.setattr(tagg, "MAX_SPAN", 2)
    np.testing.assert_array_equal(src.rows(idx), want)
