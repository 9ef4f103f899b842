"""The imputed-dosage cell's own pieces on the CPU: the frozen DS
writer's file read back through the program, the dense phase 1's
roofline reckoning worked by hand, and the two readers of what the
program records on the dense route, which read nothing where the
program records no such span."""

from __future__ import annotations

import types

import numpy as np
import pytest

from portbench import program_spans, roofline_dense
from portbench.data.dosages import imputed_dosages, variant_infos
from portbench.data.gds_ds import write_dosage_gds
from portbench.data.genotypes import scan_variant_afs
from portbench.spec import Spec, reader

CELL = "ukb409k_imp_bin.ds4"
READERS = ("scan.dense_score_roofline_pct", "scan.shrink_ms_per_block")


@pytest.mark.parametrize("streamed", [True, False],
                         ids=["streamed", "cached"])
def test_writer_reads_back_bit_for_bit(tmp_path, streamed):
    from saigegds_tpu_torch.io.seqarray import SeqData
    mix = Spec().mix("ds4")
    V, n = 70, 301
    af = scan_variant_afs(V, mix["maf_classes"], mix["alt_major"], 5)
    ds, _, _ = imputed_dosages(af, variant_infos(V, [0.3, 1.0], 5), n,
                               np.arange(n), 255, 5, "cpu")
    ds[3, 7] = np.nan
    path = str(tmp_path / "ds.gds")
    write_dosage_gds(path, ds, np.arange(1, n + 1))
    seq = SeqData(path)
    assert seq.dosage_node_name() == "annotation/format/DS"
    assert not seq.has_genotype()
    got = np.concatenate([b for _, b in seq.iter_dosage_blocks(
        32, streamed=streamed)])
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got.view(np.uint64),
                                  ds.astype(np.float64).view(np.uint64))


def test_dosages_are_quantised():
    V, n = 40, 500
    af = np.linspace(0.001, 0.999, V)
    ds, kept, truth = imputed_dosages(af, variant_infos(V, [0.3, 1.0], 9),
                                      n, np.arange(0, n, 2), 255, 9, "cpu",
                                      truth_rows=[0, 39])
    k = ds.astype(np.float64) * 255
    assert np.abs(k - np.round(k)).max() < 1e-4
    assert ds.min() >= 0 and ds.max() <= 2 and not np.isnan(ds).any()
    np.testing.assert_array_equal(kept, ds[:, 0::2])
    assert truth.shape == (2, n // 2) and set(np.unique(truth)) <= {0, 1, 2}


def test_dense_roofline_by_hand():
    """Four models (K = 7) over 256 float32 rows of 408,961 samples:
    bytes 418,776,064 + 4 * 408,961 * 16 * 8 = 628,164,096 at 3.35 TB/s
    are 0.18751 ms; operations 4 * 256 * 408,961 * 34 = 14,238,386,176 at
    67 TFLOP/s are 0.21251 ms, the bound.  At 44 rows the bytes bind:
    (71,977,136 + 209,388,032) / 3.35e12 = 0.08399 ms."""
    n, P, K = 408961, 4, 7
    b, ops = roofline_dense.dense_bytes_ops(256, n, P, K, 256 * n * 4)
    assert (b, ops) == (628164096, 14238386176)
    assert round(roofline_dense.dense_bound_s(256, n, P, K, 256 * n * 4)
                 * 1e3, 5) == 0.21251
    assert round(roofline_dense.dense_bound_s(44, n, P, K, 44 * n * 4)
                 * 1e3, 5) == 0.08399


def _ctx(calls: int = 2):
    spec = Spec()
    cell = spec.cell(CELL)
    return dict(trace={"busy_s": 1.0, "window_s": 2.0}, counters={},
                calls=[{}] * calls, config=spec.config(cell["config"]),
                mix=spec.mix(cell["traffic"]))


def _recording(monkeypatch, host=(), device=(), counts=None):
    prof = types.SimpleNamespace(spans=lambda: list(host),
                                 device_spans=lambda: list(device),
                                 counts=lambda: dict(counts or {}))
    monkeypatch.setattr(program_spans, "recorded",
                        lambda ctx: program_spans.Recorded(prof))


@pytest.mark.parametrize("name", READERS)
def test_readers_read_nothing_without_the_spans(monkeypatch, name):
    assert reader(name)(dict(_ctx(), trace=None)) is None
    # a 2-bit scan's recording: blocks, but no dense span or counter
    _recording(monkeypatch, counts={"scan.blocks": 8, "scan.spa_rows": 9})
    assert reader(name)(_ctx()) is None


def test_readers_on_a_recording(monkeypatch):
    from saigegds_tpu_torch.utils.profiling import DeviceSpan, Span
    ctx = _ctx(calls=2)
    n, rows = ctx["config"]["n_samples"], 2 * ctx["mix"]["variants"]
    blocks = rows // ctx["mix"]["block_size"]
    _recording(
        monkeypatch,
        host=[Span(i, "scan.shrink", 1, 0, 0, 0, 250_000_000)
              for i in range(blocks)],
        device=[DeviceSpan("scan.dense_score", 1, 0, 0, 0.0425)] * blocks,
        counts={"scan.blocks": blocks, "scan.dense_rows_f32": rows,
                "scan.dense_bytes": rows * n * 4})
    assert reader("scan.shrink_ms_per_block")(ctx) == pytest.approx(250.0)
    # each 256-row block's bound, 0.21251 ms, over its 42.5 ms
    assert reader("scan.dense_score_roofline_pct")(ctx) == pytest.approx(
        100 * 0.2125132 / 42.5, rel=1e-6)
