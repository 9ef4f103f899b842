"""The PyTorch port's burden test of a quantitative trait (``assoc_burden``
on the CPU) against the JAX package's, and ACAT-V / ACAT-O refusing a
quantitative model, as the reference does.

Data: the rare-heavy GDS of ``test_torch_aggregate.py`` (2,003 samples x
600 variants, two chromosomes, an all-missing SNP, ALT-major SNPs), with
the enriched block's carriers drawn from the top tenth of a right-skewed
quantitative phenotype, and a model from the JAX package's GLM helpers
(tau_E = 0.83).  Units: the same sliding windows and gene sets.  Default
``AggregateConfig``.

Tolerance: the same columns in the same order (no ``p.norm`` or ``cvg``);
``numvar`` equal; ``summac`` and the MAF/MAC summaries within 1e-12
relative; beta, SE and p-values within 1e-10 relative with the same NaN
pattern (the reference contract is 1e-7).  No row goes to SPA.
"""

import numpy as np
import pytest

from _torch_synth import one_torch_thread  # noqa: F401 (autouse)
from _torch_synth import jax_quant_null_model, synth_quant_pheno, \
    var_ratio_table
from test_torch_aggregate import N_SAMPLES, N_VARIANTS, _assert_same, \
    _assert_tables_match, _groups, synth_rare_codes
from saigegds_tpu.assoc import aggregate as jagg
from saigegds_tpu.config import AggregateConfig as JaxAggregateConfig
from saigegds_tpu.io.gds_write import write_seqarray_gds
from saigegds_tpu.io.seqarray import SeqData as JaxSeqData
import saigegds_tpu_torch as sg
from saigegds_tpu_torch.assoc import aggregate as tagg
from saigegds_tpu_torch.io.seqarray import SeqData


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_quant_aggregate")
    rng = np.random.default_rng(79)
    X, y = synth_quant_pheno(rng, N_SAMPLES)
    top = (y > np.quantile(y, 0.9)).astype(np.float64)
    codes = synth_rare_codes(rng, top)
    chrom = np.where(np.arange(N_VARIANTS) < 380, "1", "2").astype(object)
    pos = np.concatenate([np.cumsum(rng.integers(1, 60, 380)),
                          np.cumsum(rng.integers(1, 60, N_VARIANTS - 380))])
    gds = str(tmp / "rare.gds")
    write_seqarray_gds(gds, codes, chromosome=chrom, position=pos,
                       compress="ZIP_ra")
    jm = jax_quant_null_model(X, y, var_ratio_table("pooled"))
    return gds, jm, sg.NullModel.from_arrays(vars(jm))


@pytest.fixture(scope="module", params=["windows", "groups"])
def units(request, data):
    gds = data[0]
    if request.param == "windows":
        return (jagg.sliding_windows(JaxSeqData(gds), win_size=600,
                                     win_shift=300),
                sg.sliding_windows(SeqData(gds), win_size=600, win_shift=300))
    return (jagg.units_from_groups(JaxSeqData(gds), _groups()),
            sg.units_from_groups(SeqData(gds), _groups()))


@pytest.mark.parametrize("r_cap", [tagg.R_CAP, 3],
                         ids=["default_batches", "mixed_routes"])
def test_burden_matches_jax(data, units, r_cap, monkeypatch):
    """At the default batch every payload ships 2-bit; at three burden
    rows a batch some ship gap-coded (decoded by B5 on a card) too."""
    gds, jm, tm = data
    ju, tu = units
    want = jagg.assoc_burden(gds, jm, ju, JaxAggregateConfig())
    monkeypatch.setattr(tagg, "R_CAP", r_cap)
    inst = {}
    got = sg.assoc_burden(gds, tm, tu, sg.AggregateConfig(), instrument=inst,
                          device="cpu")
    _assert_tables_match(got, want)
    assert not any(c.startswith(("p.norm", "cvg")) for c in got)
    p = got["pval.b1_1"]
    assert np.isfinite(p).sum() > len(tu) // 2 and np.nanmin(p) < 1e-4
    assert inst.get("spa_n", 0) == 0
    assert inst["payloads"]["burden_2bit"] >= 2
    assert (inst["payloads"].get("burden_sparse", 0) > 0) == (r_cap == 3)


@pytest.mark.parametrize("variant", ["random_access", "small_batches"])
def test_burden_batching_invariance(data, variant, monkeypatch):
    """The frame random access of big files gives the default table
    exactly; small device batches within 1e-12."""
    gds, _, tm = data
    tu = sg.units_from_groups(SeqData(gds), _groups())
    want = sg.assoc_burden(gds, tm, tu, sg.AggregateConfig(), device="cpu")
    if variant == "random_access":
        monkeypatch.setattr(tagg._UnitSource, "CACHE_LIMIT", 0)
    else:
        monkeypatch.setattr(tagg, "R_CAP", 7)
    got = sg.assoc_burden(gds, tm, tu, sg.AggregateConfig(), device="cpu")
    _assert_same(got, want, rtol=0 if variant == "random_access" else 1e-12)


@pytest.mark.parametrize("name", ["assoc_acat_v", "assoc_acat_o"])
def test_acat_raises_on_quantitative(data, name):
    gds, _, tm = data
    tu = sg.units_from_groups(SeqData(gds), {"a": [1, 2, 3]})
    with pytest.raises(NotImplementedError, match="binary-only"):
        getattr(sg, name)(gds, tm, tu, sg.AggregateConfig(), device="cpu")


def test_saved_set_reads_back(data, tmp_path):
    from saigegds_tpu.utils.stats import load_pval
    gds, _, tm = data
    tu = sg.units_from_groups(SeqData(gds), _groups())
    out = str(tmp_path / "set.gds")
    got = sg.assoc_burden(gds, tm, tu, sg.AggregateConfig(), res_savefn=out,
                          device="cpu")
    back = load_pval(out)
    np.testing.assert_array_equal(back["pval.b1_1"].to_numpy(),
                                  got["pval.b1_1"])
    assert list(back["set"]) == list(got["set"])
