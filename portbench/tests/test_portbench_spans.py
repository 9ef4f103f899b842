"""A traced run of each cell at a tiny size on the CPU reports every
per-layer metric of the cell, the program's spans and counters among
them.

The harness's traced path assumes a card: the trace waits for it with
``torch.cuda.synchronize`` and the fit's operator wrapper times products
with ``torch.cuda.Event``.  Here both are replaced by host stand-ins.
The kernels' roofline (``fit.grm_kernels_roofline_pct``) reads kernels
B1 and B2 from the device's side of the trace, which a CPU run does not
have: it reads nothing here, and must not raise."""

from __future__ import annotations

import time

import pytest
import torch

from portbench import run
from portbench.spec import Spec
from portbench.tests.tiny import SEED, tiny

SPEC = Spec()
CELLS = sorted(SPEC.cells)
DEVICE_KERNELS = {"fit.grm_kernels_roofline_pct"}


class HostEvent:
    """``torch.cuda.Event`` on the host clock."""

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self, stream=None):
        self.t = time.perf_counter()

    def elapsed_time(self, end) -> float:
        return (end.t - self.t) * 1e3


@pytest.fixture
def host_card(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the benchmark itself runs there")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "Event", HostEvent)


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_every_metric(cell, host_card):
    cfg, mix, e2e, per_layer, limits = tiny(cell)
    res = run.run_cell(cfg, mix, e2e, per_layer, limits, SEED, 0.0, True,
                       "cpu", t_start=time.perf_counter())
    assert res["correct"], res["checks"]
    names = {m["name"] for m in per_layer}
    assert set(res["metrics"]) == names - DEVICE_KERNELS
    added = {"scan.block_wait_ms_per_block", "scan.prepare_ms_per_call",
             "scan.spa_refine_ms_per_row", "scan.spa_batch_fill_pct",
             "fit.corrections_ms_per_product", "fit.product_glue_ms"}
    assert names & added
    for name in names & added:
        v = res["metrics"][name]["value"]
        assert v > 0, (name, v)
    fill = res["metrics"].get("scan.spa_batch_fill_pct")
    assert fill is None or fill["value"] <= 100.0
