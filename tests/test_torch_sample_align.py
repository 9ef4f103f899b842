"""Sample alignment in the PyTorch port: a null model whose samples are a
reordering or a subset of the GDS samples, against the JAX package.

The reference filters the GDS to the model's samples and gathers the model
arrays into GDS order (``seqSetFilter(sample.id=)`` +
``ii <- match(sid, modobj$sample.id)``, R/assoc_single.r:136-142).  These
are the four cases of ``tests/test_sample_align.py`` on synthetic data
(``tests/_torch_synth.py``) instead of the reference's fixtures: a scan
over a GDS whose samples are permuted, a scan over a GDS with samples the
model lacks (at shuffled positions), the aggregate tests over a permuted
GDS with extra samples, and a model sample absent from the GDS, which
raises in both packages.

Tolerance: the port against the JAX package on the same GDS, as in
``test_torch_scan.py`` and ``test_torch_aggregate.py``: ids, AF.alt, mac,
num, numvar exact; p-values, beta and SE within 1e-10 relative (the JAX
package takes its dense f64 route when the samples differ, the port its
exact integer route; the reference contract is 1e-7), summac within
1e-12.  The port on the permuted GDS against the port on the GDS in model
order within 1e-12, the bound ``tests/test_sample_align.py`` holds the
JAX package to: the phase-1 sums are exact integers, and only the f64
sums of the model side and of SPA change their order.
"""

import numpy as np
import pytest

from _torch_synth import one_torch_thread  # noqa: F401 (autouse)
from _torch_synth import jax_null_model, synth_codes, synth_pheno, \
    var_ratio_table
import saigegds_tpu
from saigegds_tpu.assoc import aggregate as jagg
from saigegds_tpu.config import AggregateConfig as JaxAggregateConfig
from saigegds_tpu.io.gds_write import write_seqarray_gds
from saigegds_tpu.io.seqarray import SeqData as JaxSeqData
import saigegds_tpu_torch as sg
from saigegds_tpu_torch.io.seqarray import SeqData

RTOL_JAX = 1e-10
RTOL_ORDER = 1e-12
RTOL_SUMMAC = 1e-12
N_SAMPLES, N_VARIANTS, BLOCK = 1031, 240, 64
N_EXTRA = 17
ALL_HET_ID = 3           # variant.id of synth_codes' all-het row
STATS = ("pval", "p.norm", "beta", "SE")


def _write(path, codes, perm, extra=0, seed=0) -> str:
    """The GDS with sample columns in the order ``perm`` (model positions)
    and ``extra`` samples the model lacks inserted at shuffled positions;
    model sample i has id i + 1."""
    c = codes[:, perm]
    sid = (np.asarray(perm) + 1).astype(np.int32)
    if extra:
        rng = np.random.default_rng(seed)
        fake = rng.integers(0, 3, size=(c.shape[0], extra)).astype(np.int8)
        c = np.concatenate([c, fake], axis=1)
        sid = np.concatenate([sid, np.arange(10**6, 10**6 + extra,
                                             dtype=np.int32)])
        order = rng.permutation(c.shape[1])
        c, sid = c[:, order], sid[order]
    pos = np.arange(1, codes.shape[0] + 1, dtype=np.int32) * 100
    write_seqarray_gds(str(path), c, sample_id=sid, position=pos,
                       compress="ZIP_ra")
    return str(path)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_sample_align")
    rng = np.random.default_rng(29)
    X, y = synth_pheno(rng, N_SAMPLES)
    codes = synth_codes(rng, N_VARIANTS, N_SAMPLES, y=y)
    jm = jax_null_model(X, y, var_ratio_table("pooled"))
    gds = {
        "base": _write(tmp / "base.gds", codes, np.arange(N_SAMPLES)),
        "perm": _write(tmp / "perm.gds", codes,
                       np.random.default_rng(7).permutation(N_SAMPLES)),
        "sup": _write(tmp / "sup.gds", codes,
                      np.random.default_rng(11).permutation(N_SAMPLES),
                      extra=N_EXTRA, seed=11),
        "perm_extra": _write(tmp / "perm_extra.gds", codes,
                             np.random.default_rng(3).permutation(N_SAMPLES),
                             extra=5, seed=3),
        "sub": _write(tmp / "sub.gds", codes[:, :900], np.arange(900)),
    }
    return gds, jm, sg.NullModel.from_arrays(vars(jm))


def _scan_pair(data, which):
    gds, jm, model = data
    want = saigegds_tpu.assoc_spa(gds[which], jm,
                                  saigegds_tpu.ScanConfig(block_size=BLOCK))
    got = sg.assoc_spa(gds[which], model, sg.ScanConfig(block_size=BLOCK),
                       device="cpu")
    return got, want


def _assert_scan_matches(got: dict, want):
    assert list(got) == list(want.columns)
    for c in ("id", "AF.alt", "mac", "num", "converged"):
        np.testing.assert_array_equal(np.asarray(got[c]), want[c].to_numpy(),
                                      err_msg=c)
    ok = got["id"] != ALL_HET_ID
    for c in STATS:
        np.testing.assert_allclose(got[c][ok], want[c].to_numpy()[ok],
                                   rtol=RTOL_JAX, atol=0, err_msg=c)


def test_scan_permuted_samples(data):
    got, want = _scan_pair(data, "perm")
    _assert_scan_matches(got, want)
    base = sg.assoc_spa(data[0]["base"], data[2],
                        sg.ScanConfig(block_size=BLOCK), device="cpu")
    np.testing.assert_array_equal(got["id"], base["id"])
    ok = got["id"] != ALL_HET_ID
    for c in ("AF.alt", "mac") + STATS:
        np.testing.assert_allclose(got[c][ok], base[c][ok], rtol=RTOL_ORDER,
                                   atol=0, err_msg=c)


@pytest.mark.parametrize("packed_2bit", [True, False])
def test_scan_superset_samples(data, packed_2bit):
    """A GDS with samples the model lacks drops them, like seqSetFilter;
    the gathered block takes either phase-1 route (B3 or B4 on the card)."""
    gds, jm, model = data
    want = saigegds_tpu.assoc_spa(gds["sup"], jm,
                                  saigegds_tpu.ScanConfig(block_size=BLOCK))
    inst = {}
    got = sg.assoc_spa(gds["sup"], model,
                       sg.ScanConfig(block_size=BLOCK,
                                     packed_2bit=packed_2bit),
                       instrument=inst, device="cpu")
    _assert_scan_matches(got, want)
    assert len(inst["gather_s"]) == -(-N_VARIANTS // BLOCK)
    assert inst["spa_n"] > 0


@pytest.mark.parametrize("test", ["assoc_burden", "assoc_acat_v",
                                  "assoc_acat_o"])
def test_aggregate_permuted_samples(data, test):
    """The aggregate tests over a permuted GDS with extra samples."""
    gds, jm, model = data
    path = gds["perm_extra"]
    ju = jagg.sliding_windows(JaxSeqData(path), win_size=2000,
                              win_shift=1000)
    tu = sg.sliding_windows(SeqData(path), win_size=2000, win_shift=1000)
    cfg = dict(wbeta=((1.0, 25.0),), summac=1.0)
    want = getattr(saigegds_tpu, test)(path, jm, ju,
                                       JaxAggregateConfig(**cfg))
    got = getattr(sg, test)(path, model, tu, sg.AggregateConfig(**cfg),
                            device="cpu")
    assert list(got) == list(want.columns)
    np.testing.assert_array_equal(got["numvar"], want["numvar"].to_numpy())
    pcols = [c for c in got if c.startswith("pval")]
    assert pcols
    for c in pcols:
        a, b = np.asarray(got[c], float), want[c].to_numpy(float)
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=c)
        assert (~np.isnan(a)).any()
        np.testing.assert_allclose(a, b, rtol=RTOL_JAX, atol=0, err_msg=c)
    if "summac" in got:
        np.testing.assert_allclose(got["summac"], want["summac"].to_numpy(),
                                   rtol=RTOL_SUMMAC, atol=0)


@pytest.mark.parametrize("test", ["assoc_spa", "assoc_burden"])
def test_missing_model_samples_raise(data, test):
    gds, jm, model = data
    with pytest.raises(ValueError, match="missing from the GDS"):
        saigegds_tpu.assoc_spa(gds["sub"], jm, saigegds_tpu.ScanConfig())
    with pytest.raises(ValueError, match="missing from the GDS"):
        if test == "assoc_spa":
            sg.assoc_spa(gds["sub"], model, sg.ScanConfig(), device="cpu")
        else:
            units = sg.sliding_windows(SeqData(gds["sub"]), win_size=2000,
                                       win_shift=1000)
            sg.assoc_burden(gds["sub"], model, units, sg.AggregateConfig(),
                            device="cpu")
