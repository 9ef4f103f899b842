"""The port's scan of imputed dosages (``assoc_spa_multi`` over a GDS whose
only dosage source is ``annotation/format/DS``) against the benchmark's
plain reference, on the CPU at a tiny size.

The GDS is the benchmark's own: 8-bit-quantised dosages (multiples of
1/255 stored dFloat32, ``portbench/data/dosages.py``) written by the
frozen DS writer (``portbench/data/gds_ds.py``) over more samples than
the models hold, the models' at shuffled positions, and four binary
models at 5-50% cases from the benchmark's scan entry
(``portbench/entries/scan_ds_models.py`` at its tiny test size).  Each
table is compared with ``portbench/reference/scan_dosage.py`` by
``portbench/reference/scan_check.gaps``, through the streamed decode
(``SeqData.DS_CACHE_LIMIT`` = 0, as a biobank chunk takes it) and the
cached one, which give the same bits.

Tolerance: the same rows and the same ``converged``; AF.alt, mac and num
exact (sums of float32 multiples of 1/255 are exact in float64 in any
order); beta (on the scale of |beta| + SE), SE and both p-values within
1e-10 relative (the port and the reference sum over samples in another
order: round-off of 1e-16 to 1e-12; the benchmark cell's limit is
1e-8).  The width counters: every row of such a file ships float32, and
a block of dosages that float32 cannot hold ships float64."""

import os
import sys

import numpy as np
import pytest
import torch

from _torch_synth import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import saigegds_tpu_torch as sg  # noqa: E402
from saigegds_tpu_torch.io.gds_write import write_dosage_gds  # noqa: E402
from saigegds_tpu_torch.io.seqarray import SeqData  # noqa: E402
from saigegds_tpu_torch.utils import profiling  # noqa: E402
from portbench.entries.scan_ds_models import ScanDsModels  # noqa: E402
from portbench.reference.scan_check import gaps  # noqa: E402
from portbench.reference.scan_dosage import reference_tables  # noqa: E402
from portbench.tests.tiny import SEED, tiny  # noqa: E402

CELL = "ukb409k_imp_bin.ds4"
RTOL = 1e-10
COLUMNS = ("AF.alt", "mac", "num", "beta", "SE", "pval", "p.norm",
           "converged")


@pytest.fixture(scope="module")
def scan(tmp_path_factory):
    cfg, mix, *_ = tiny(CELL)
    state = ScanDsModels(cfg, mix, SEED, "cpu", False, lambda msg: None,
                         str(tmp_path_factory.mktemp("imputed_scan")))
    models, arrays = state._models(0)
    return state, models, arrays


def _tables(state, models, monkeypatch, streamed: bool):
    if streamed:
        monkeypatch.setattr(SeqData, "DS_CACHE_LIMIT", 0)
    return sg.assoc_spa_multi(state.path, models, state.config,
                              device="cpu")


@pytest.mark.parametrize("streamed", [True, False],
                         ids=["streamed", "cached"])
def test_imputed_scan_matches_reference(scan, monkeypatch, streamed):
    state, models, arrays = scan
    tabs = _tables(state, models, monkeypatch, streamed)
    got = [dict({c: np.asarray(t[c]) for c in COLUMNS},
                idx=np.asarray(t["id"]).astype(np.int64) - 1) for t in tabs]
    ref = reference_tables(state.dosages, arrays, state._params(),
                           torch.float64, "cpu")
    g = gaps(got, ref)
    assert g["rows_mismatch"] == 0 and g["converged_mismatch"] == 0, g
    assert g["stats_gap"] == 0, g
    for k in ("beta_gap", "se_gap", "pval_gap"):
        assert g[k] <= RTOL, (k, g)
    # every model tests the same variants, and SPA refines some of them
    assert all(len(t["pval"]) == len(tabs[0]["pval"]) > 0 for t in tabs)
    assert any((np.asarray(t["pval"]) != np.asarray(t["p.norm"])).any()
               for t in tabs)


def test_streamed_equals_cached(scan, monkeypatch):
    state, models, _ = scan
    cached = _tables(state, models, monkeypatch, False)
    streamed = _tables(state, models, monkeypatch, True)
    for a, b in zip(cached, streamed):
        assert list(a) == list(b)
        for c in a:
            np.testing.assert_array_equal(a[c], b[c])


def _recorded(scan_file):
    """``scan_file()`` once as it runs and once under the profiler: the
    recorder holds the second run alone (a public call that finds the
    profiler on after one that found it off drops what was held).
    Returns the port's counters and the names of its host and device
    spans, after checking that recording left the tables as they were."""
    from torch.profiler import ProfilerActivity, profile
    plain = scan_file()
    with profile(activities=[ProfilerActivity.CPU]):
        traced = scan_file()
    for a, b in zip(plain, traced):
        for c in a:
            np.testing.assert_array_equal(a[c], b[c])
    return profiling.counts(), [s.name for s in profiling.spans()], \
        [d.name for d in profiling.device_spans()]


def test_dense_width_counters(scan, tmp_path):
    state, models, _ = scan
    V, n = state.dosages.shape
    B = state.config.block_size
    blocks = -(-V // B)
    counts, host, dev = _recorded(lambda: sg.assoc_spa_multi(
        state.path, models, state.config, device="cpu"))
    assert counts.get("scan.dense_rows_f64", 0) == 0
    assert counts["scan.dense_rows_f32"] == V
    assert counts["scan.dense_bytes"] == V * n * 4
    assert counts["scan.blocks"] == blocks
    assert host.count("scan.shrink") == blocks
    assert dev.count("scan.dense_score") == blocks

    # the second block's dosages moved by a third of a level: float32
    # cannot hold them, so that block alone ships float64
    ds = state.dosages.astype(np.float64)
    ds[B:2 * B] = np.clip(ds[B:2 * B] + 1.0 / (3 * 255), 0.0, 2.0)
    path = str(tmp_path / "f64.gds")
    write_dosage_gds(path, ds, sample_id=state.sample_id, compress="ZIP_ra")
    counts, _, _ = _recorded(lambda: sg.assoc_spa_multi(
        path, models, state.config, device="cpu"))
    assert counts["scan.dense_rows_f64"] == B
    assert counts["scan.dense_rows_f32"] == V - B
    assert counts["scan.dense_bytes"] == (V - B) * n * 4 + B * n * 8
