"""The PyTorch port's aggregate tests (``assoc_burden``, ``assoc_acat_v``,
``assoc_acat_o`` on the CPU) against the JAX package's.

Both read one synthetic GDS written by the JAX package's writer — about
2,000 samples x 600 variants, ultra-rare-heavy so that ACAT-V has both a
burden part (MAC < 10) and single variants, on two chromosomes, with an
all-missing SNP, ALT-major SNPs and a block of variants enriched in cases
(so that SPA refines rows) — and one null model built from the JAX
package's GLM helpers.  Units: overlapping sliding windows, and gene sets
from ``units_from_groups`` with a one-SNP unit, a unit holding the
all-missing SNP, an empty unit and unknown ids.  Default
``AggregateConfig``: two weight schemes, ``summac`` 3, ``acatv_mac`` 10.

Tolerance: the same columns in the same order; ``numvar``, ``n.single``
and ``n.burden`` equal; ``summac`` within 1e-12 relative (host algebra on
the same tallies); every p-value column within 1e-10 relative with the
same NaN pattern (the reference contract is 1e-7).  The burden rows are
built on the device as an f64 product here and as an exact integer-slice
product in the JAX package; both are within a few ulps of the exact
affine value, so phase 1 agrees to ~1e-13 and SPA to ~1e-12.
"""

import numpy as np
import pytest

from _torch_synth import one_torch_thread  # noqa: F401 (autouse)
from _torch_synth import jax_null_model, synth_pheno, var_ratio_table
from saigegds_tpu.assoc import aggregate as jagg
from saigegds_tpu.config import AggregateConfig as JaxAggregateConfig
from saigegds_tpu.io.gds_write import write_seqarray_gds
from saigegds_tpu.io.seqarray import SeqData as JaxSeqData
import saigegds_tpu_torch as sg
from saigegds_tpu_torch.assoc import aggregate as tagg
from saigegds_tpu_torch.assoc import single as tsingle
from saigegds_tpu_torch.io.seqarray import SeqData

RTOL_P = 1e-10
RTOL_SUMMAC = 1e-12
N_SAMPLES, N_VARIANTS = 2003, 600
ALL_MISSING = 57                 # variant index of the all-missing SNP
ENRICHED = range(100, 140)       # variants with carriers enriched in cases


def synth_rare_codes(rng, y) -> np.ndarray:
    """int8 [M, N] codes: half ultra-rare (1-9 minor alleles), 35% rare
    (MAF 0.003-0.03), 15% low-frequency (0.03-0.1); a tenth ALT-major;
    1% missing."""
    M, N = N_VARIANTS, N_SAMPLES
    u = rng.random(M)
    maf = np.where(u < 0.35, rng.uniform(0.003, 0.03, M),
                   rng.uniform(0.03, 0.1, M))
    codes = rng.binomial(2, maf[:, None], size=(M, N)).astype(np.int8)
    ultra = rng.random(M) < 0.5
    for i in np.flatnonzero(ultra):
        codes[i] = 0
        codes[i, rng.choice(N, rng.integers(1, 10), replace=False)] = 1
    case = np.flatnonzero(y > 0.5)
    for i in ENRICHED:
        codes[i] = 0
        k = rng.integers(8, 30)
        codes[i, rng.choice(case, k, replace=False)] = 1
    flip = rng.random(M) < 0.1
    codes[flip] = 2 - codes[flip]
    codes[rng.random((M, N)) < 0.01] = 3
    codes[ALL_MISSING] = 3
    return codes


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_aggregate")
    rng = np.random.default_rng(73)
    X, y = synth_pheno(rng, N_SAMPLES)
    codes = synth_rare_codes(rng, y)
    chrom = np.where(np.arange(N_VARIANTS) < 380, "1", "2").astype(object)
    pos = np.concatenate([np.cumsum(rng.integers(1, 60, 380)),
                          np.cumsum(rng.integers(1, 60, N_VARIANTS - 380))])
    gds = str(tmp / "rare.gds")
    write_seqarray_gds(gds, codes, chromosome=chrom, position=pos,
                       compress="ZIP_ra")
    jm = jax_null_model(X, y, var_ratio_table("pooled"))
    return gds, jm, sg.NullModel.from_arrays(vars(jm))


def _groups():
    """Gene sets by variant id (1-based): runs of 4-30 variants, a one-SNP
    unit, the all-missing SNP's unit, an empty unit, unknown ids."""
    rng = np.random.default_rng(5)
    groups, v = {}, 1
    while v <= N_VARIANTS:
        k = int(rng.integers(4, 31))
        groups[f"g{v}"] = list(range(v, min(v + k, N_VARIANTS + 1)))
        v += k
    groups["single"] = [ENRICHED[0] + 1]
    groups["with_missing"] = list(range(ALL_MISSING - 1, ALL_MISSING + 4))
    groups["empty"] = []
    groups["unknown"] = [10**6, 3, 10**6 + 1]
    return groups


@pytest.fixture(scope="module", params=["windows", "groups"])
def units(request, data):
    """(JAX units, port units) of one kind, checked identical."""
    gds = data[0]
    if request.param == "windows":
        ju = jagg.sliding_windows(JaxSeqData(gds), win_size=600,
                                  win_shift=300)
        tu = sg.sliding_windows(SeqData(gds), win_size=600, win_shift=300)
        assert len(tu) > 40
    else:
        ju = jagg.units_from_groups(JaxSeqData(gds), _groups())
        tu = sg.units_from_groups(SeqData(gds), _groups())
    assert list(tu.desp) == list(ju.desp.columns)
    for c in tu.desp:
        np.testing.assert_array_equal(tu.desp[c], ju.desp[c].to_numpy())
    assert len(tu.index) == len(ju.index)
    for a, b in zip(tu.index, ju.index):
        np.testing.assert_array_equal(a, b)
    return ju, tu


TESTS = {"burden": ("assoc_burden", ("summac",)),
         "acat_v": ("assoc_acat_v", ("n.single", "n.burden")),
         "acat_o": ("assoc_acat_o", ())}


def _assert_tables_match(got: dict, want):
    assert list(got) == list(want.columns)
    assert all(len(v) == len(want) for v in got.values())
    for c in got:
        a, b = np.asarray(got[c]), want[c].to_numpy()
        if c in ("set", "chr", "start", "end", "numvar", "n.single",
                 "n.burden") or c.startswith("cvg"):
            np.testing.assert_array_equal(a, b, err_msg=c)
            continue
        a, b = a.astype(float), b.astype(float)
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=c)
        m = ~np.isnan(a)
        rtol = RTOL_SUMMAC if c.startswith(("summac", "maf", "mac")) \
            else RTOL_P
        np.testing.assert_allclose(a[m], b[m], rtol=rtol, err_msg=c)


def _assert_same(got: dict, want: dict, rtol: float):
    """Two port tables: the same columns, non-float columns equal, float
    columns within ``rtol`` (0: equal) with the same NaN pattern."""
    assert list(got) == list(want)
    for c in want:
        if want[c].dtype.kind != "f":
            np.testing.assert_array_equal(got[c], want[c], err_msg=c)
        else:
            np.testing.assert_allclose(got[c], want[c], rtol=rtol, atol=0,
                                       err_msg=c)


@pytest.mark.parametrize("test", list(TESTS))
def test_matches_jax(data, units, test):
    gds, jm, tm = data
    ju, tu = units
    name, _ = TESTS[test]
    want = getattr(jagg, name)(gds, jm, ju, JaxAggregateConfig())
    inst = {}
    got = getattr(sg, name)(gds, tm, tu, sg.AggregateConfig(),
                            instrument=inst, device="cpu")
    _assert_tables_match(got, want)
    p = next(v for k, v in got.items() if k.startswith("pval"))
    assert np.isfinite(p).sum() > len(tu) // 2
    assert inst["payloads"] and inst["fetch_s"] > 0


def test_spa_refines_and_parts_run(data, units):
    """The data reach every part of the path: SPA changes burden p-values,
    and ACAT-V has units with both single SNPs and a burden part."""
    gds, _, tm = data
    _, tu = units
    inst = {}
    b = sg.assoc_burden(gds, tm, tu, sg.AggregateConfig(), instrument=inst,
                        device="cpu")
    refined = (b["pval.b1_1"] != b["p.norm.b1_1"])[
        np.isfinite(b["pval.b1_1"])].sum()
    assert refined >= 2 and inst["spa_n"] >= refined
    v = sg.assoc_acat_v(gds, tm, tu, sg.AggregateConfig(), device="cpu")
    assert ((v["n.single"] > 0) & (v["n.burden"] > 0)).sum() >= 3


@pytest.mark.parametrize("variant", ["split_payloads", "random_access",
                                     "small_batches"])
def test_route_and_batching_invariance(data, variant, monkeypatch):
    """Split sparse + 2-bit single-variant payloads and the frame random
    access of big files give the default ACAT-O table exactly; small
    device batches give it within 1e-12."""
    gds, _, tm = data
    tu = sg.units_from_groups(SeqData(gds), _groups())
    want = sg.assoc_acat_o(gds, tm, tu, sg.AggregateConfig(), device="cpu")
    config = sg.AggregateConfig()
    inst = {}
    if variant == "split_payloads":
        monkeypatch.setattr(tsingle, "SPLIT_SAVE_BYTES", 0)
        monkeypatch.setattr(tsingle, "SPLIT_SAVE_FRAC", 0.0)
        monkeypatch.setattr(tsingle, "MIN_SPLIT", 1)
    elif variant == "random_access":
        monkeypatch.setattr(tagg._UnitSource, "CACHE_LIMIT", 0)
    else:
        config = sg.AggregateConfig(block_size=37)
        monkeypatch.setattr(tagg, "R_CAP", 7)
    got = sg.assoc_acat_o(gds, tm, tu, config, instrument=inst,
                          device="cpu")
    if variant == "split_payloads":
        assert inst["payloads"]["single_2bit"] >= 1
        assert inst["payloads"]["single_sparse"] >= 1
    # other batch shapes reorder the f64 sums of the burden rows and of
    # SPA's compacted lanes; p-values far in the tail amplify those ulps
    _assert_same(got, want, rtol=1e-12 if variant == "small_batches" else 0)


def test_incremental_spa_flush(data, monkeypatch):
    """Phase 2 flushed after every flagged batch equals one flush."""
    gds, _, tm = data
    tu = sg.units_from_groups(SeqData(gds), _groups())
    want = sg.assoc_acat_o(gds, tm, tu, sg.AggregateConfig(), device="cpu")
    monkeypatch.setattr(tagg, "SPA_FLUSH_BYTES", 1)
    got = sg.assoc_acat_o(gds, tm, tu, sg.AggregateConfig(), device="cpu")
    _assert_same(got, want, rtol=1e-12)


def test_shard_units_merge_equals_single(data):
    gds, _, tm = data
    tu = sg.units_from_groups(SeqData(gds), _groups())
    whole = sg.assoc_acat_o(gds, tm, tu, sg.AggregateConfig(), device="cpu")
    parts = [sg.assoc_acat_o(gds, tm, sg.shard_units(tu, i, 3),
                             sg.AggregateConfig(), device="cpu")
             for i in range(3)]
    _assert_same({c: np.concatenate([p[c] for p in parts]) for c in whole},
                 whole, rtol=1e-12)


def test_burden_collapse_matches_jax():
    """The port's collapse on int8 codes equals the JAX package's on the
    f64 NaN matrix bit for bit: weights with NaN entries, an all-missing
    SNP with a finite weight (NaN everywhere) or a NaN one (skipped),
    flipped SNPs."""
    rng = np.random.default_rng(11)
    S, N = 29, 997
    codes = rng.choice(np.int8([0, 0, 0, 0, 1, 2, 3]), size=(S, N))
    codes[4] = 3
    codes[7] = 2
    t = tagg._CodeTallies(codes)
    ds = np.where(codes == 3, np.nan, codes).astype(np.float64)
    for k in range(4):
        w = rng.uniform(0.01, 2.0, S)
        w[rng.random(S) < 0.2] = np.nan
        w[4] = np.nan if k % 2 else 0.3
        want = jagg._burden_collapse(ds, w)
        got = tagg._burden_collapse(codes, w, t)
        np.testing.assert_array_equal(got, want)


def test_acat_matches_jax():
    from saigegds_tpu.utils import stats as jstats
    rng = np.random.default_rng(2)
    for n in (1, 2, 7):
        p = rng.uniform(0, 1, n)
        p[0] = 1e-17
        w = rng.uniform(0.1, 3, n)
        assert sg.acat_p(p, w) == jstats.acat_p(p, w)
        assert sg.acat_p_maf(p, w / 10) == jstats.acat_p_maf(p, w / 10)
    assert np.isnan(sg.acat_p([0.2, 1.5]))


def test_saved_set_reads_back(data, tmp_path):
    """``res_savefn`` writes a SAIGE_OUTPUT_SET GDS that the JAX package's
    reader loads."""
    from saigegds_tpu.utils.stats import load_pval
    gds, _, tm = data
    tu = sg.units_from_groups(SeqData(gds), _groups())
    out = str(tmp_path / "set.gds")
    got = sg.assoc_acat_o(gds, tm, tu, sg.AggregateConfig(), res_savefn=out,
                          device="cpu")
    back = load_pval(out)
    np.testing.assert_array_equal(back["pval"].to_numpy(), got["pval"])
    assert list(back["set"]) == list(got["set"])
