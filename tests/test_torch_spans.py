"""The port's spans and counters (``saigegds_tpu_torch/utils/profiling.py``)
on the CPU: a tiny multi-model scan over a GDS that holds more samples
than the models (so the gather runs), a tiny GRM operator and a tiny
PheWAS fit.

* Without a profiler nothing is recorded, and ``instrument=`` still gets
  ``decode_s``, ``gather_s``, ``spa_s`` and ``spa_n``.
* Under ``torch.profiler.profile`` each scan call records one
  ``scan.call``; every other span carries that call's id and lies within
  its parent; the producer threads' spans carry their own thread ids; the
  counters agree with ``instrument=``; a recorded span starts within 1 ms
  of the profiler's event of the same name.
* A product's four kinds of device spans sum to its ``grm.product``
  within 1%; a fit's spans share the fit's id, its products among them.
* The recorder holds one profiler session; ``profile_trace`` records the
  producer threads.
"""

import json
import threading
import timeit

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from _torch_synth import one_torch_thread  # noqa: F401 (autouse)
from _torch_synth import jax_null_model, synth_codes, synth_pheno, \
    var_ratio_table
from saigegds_tpu.io.gds_write import write_seqarray_gds
from saigegds_tpu_torch import NullModel, ScanConfig, assoc_spa_multi, \
    fit_glmm_binary_device_multi, profile_trace
from saigegds_tpu_torch.ops.packed_grm import build_packed2_grm
from saigegds_tpu_torch.utils import profiling

N_SAMPLES, N_VARIANTS, BLOCK, N_EXTRA = 1031, 300, 64, 9
N_BLOCKS = -(-N_VARIANTS // BLOCK)
PRODUCER = {"scan.decode", "scan.pack", "scan.gather", "scan.upload",
            "scan.spa.payload"}


@pytest.fixture(scope="module")
def scan_data(tmp_path_factory):
    """A GDS whose samples are the models' and N_EXTRA more, shuffled,
    and two binary models."""
    tmp = tmp_path_factory.mktemp("torch_spans")
    rng = np.random.default_rng(47)
    X, y = synth_pheno(rng, N_SAMPLES)
    codes = synth_codes(rng, N_VARIANTS, N_SAMPLES, y=y)
    extra = rng.binomial(2, 0.3, (N_VARIANTS, N_EXTRA)).astype(np.int8)
    sid = np.arange(1, N_SAMPLES + N_EXTRA + 1, dtype=np.int32)
    perm = rng.permutation(N_SAMPLES + N_EXTRA)
    gds = str(tmp / "superset.gds")
    write_seqarray_gds(gds, np.concatenate([codes, extra], axis=1)[:, perm],
                       sample_id=sid[perm])
    models = [NullModel.from_arrays(vars(jax_null_model(
        X, y, var_ratio_table(v)))) for v in ("pooled", "cat")]
    return gds, models


def _scan(scan_data, instrument=None):
    gds, models = scan_data
    return assoc_spa_multi(gds, models, ScanConfig(block_size=BLOCK),
                           instrument=instrument, device="cpu")


def _traced(fn, *args, **kw):
    """``fn`` under a CPU profiler session; (its result, the profiler)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn(*args, **kw)
    return out, prof


def test_no_profiler_records_nothing(scan_data):
    held = (profiling.spans(), profiling.counts())
    inst = {}
    _scan(scan_data, inst)
    assert (profiling.spans(), profiling.counts()) == held
    assert len(inst["decode_s"]) == N_BLOCKS
    assert len(inst["gather_s"]) == N_BLOCKS
    assert inst["spa_n"] > 0 and inst["spa_s"] > 0.0
    assert set(inst) == {"decode_s", "gather_s", "spa_s", "spa_n"}


def test_traced_scan_spans(scan_data):
    _scan(scan_data)                      # untraced: the session resets
    inst = {}

    def two_calls():
        return [_scan(scan_data, inst), _scan(scan_data)]

    _, _prof = _traced(two_calls)
    spans = profiling.spans()
    roots = [s for s in spans if s.name == "scan.call"]
    assert len(roots) == 2
    assert all(s.parent == 0 for s in roots)
    by_id = {s.id: s for s in spans}
    assert len(by_id) == len(spans)
    main = threading.get_ident()
    for s in spans:
        assert s.call in {r.call for r in roots}
        assert s.start_ns <= s.end_ns
        if s.name == "scan.call":
            continue
        up = by_id[s.parent]
        assert up.call == s.call
        assert up.start_ns <= s.start_ns and s.end_ns <= up.end_ns, (s, up)
        assert (s.tid != main) == (s.name in PRODUCER), s
    names = {s.name for s in spans}
    assert {"scan.prepare", "scan.wait_block", "scan.dispatch",
            "scan.drain", "scan.tables", "scan.spa", "scan.spa.sort",
            "scan.spa.wait_payload", "scan.spa.refine"} | PRODUCER <= names
    for r in roots:
        own = [s for s in spans if s.call == r.call]
        assert sum(s.name == "scan.decode" for s in own) == N_BLOCKS
        # one thread a stage, all alive at once: three threads
        tids = [{s.tid for s in own if s.name == n}
                for n in ("scan.decode", "scan.pack", "scan.upload")]
        assert all(len(t) == 1 for t in tids)
        assert len(set.union(*tids)) == 3
    c = profiling.counts()
    assert c["scan.blocks"] == 2 * N_BLOCKS
    assert c["scan.spa_rows"] == 2 * inst["spa_n"]
    assert 0 < c["scan.spa_batches"] <= c["scan.spa_rows"]
    assert sum(s.name == "scan.spa.refine" for s in spans) == \
        c["scan.spa_batches"]
    # a host-paced scan keeps no device span: its events would time the
    # card waiting for the host's launches
    assert profiling.device_spans() == []
    # the instrument keys are the spans' own seconds
    first = roots[0].call if roots[0].start_ns < roots[1].start_ns \
        else roots[1].call
    dec = sorted((s.end_ns - s.start_ns) / 1e9 for s in spans
                 if s.call == first and s.name == "scan.decode")
    np.testing.assert_allclose(sorted(inst["decode_s"]), dec, rtol=1e-12)


def test_span_clock_is_the_profilers(scan_data):
    _scan(scan_data)
    _, prof = _traced(_scan, scan_data)
    events = [e.start_ns() for e in prof.profiler.kineto_results.events()
              if e.name() == "scan.wait_block"]
    spans = [s for s in profiling.spans() if s.name == "scan.wait_block"]
    assert events and len(spans) == len(events)
    for s in spans:
        assert min(abs(s.start_ns - t) for t in events) < 1_000_000


@pytest.fixture(scope="module")
def grm():
    rng = np.random.default_rng(48)
    codes = rng.binomial(2, rng.uniform(0.05, 0.5, (800, 1)),
                         size=(800, 3000)).astype(np.int8)
    codes[rng.random(codes.shape) < 0.02] = 3
    return build_packed2_grm(codes, device="cpu"), rng


def test_product_parts_sum_to_the_product(grm):
    op, rng = grm
    b = torch.as_tensor(rng.normal(size=(op.n_samples, 8)))
    want = op.matvec(b)
    got, _ = _traced(op.matvec, b)
    assert torch.equal(got, want)
    products = [s for s in profiling.spans() if s.name == "grm.product"]
    assert len(products) == 1
    p = products[0]
    dev = [d for d in profiling.device_spans() if d.call == p.call]
    assert {d.name for d in dev} == {"grm.slice", "grm.kernels",
                                     "grm.corrections", "grm.combine"}
    total = (p.end_ns - p.start_ns) / 1e9
    assert sum(d.seconds for d in dev) == pytest.approx(total, rel=0.01)


def test_session_reset(grm):
    op, rng = grm
    b = torch.as_tensor(rng.normal(size=(op.n_samples, 2)))
    op.matvec(b)
    _traced(lambda: [op.matvec(b) for _ in range(3)])
    assert sum(s.name == "grm.product" for s in profiling.spans()) == 3
    op.matvec(b)                          # found the profiler off
    _traced(op.matvec, b)
    spans = profiling.spans()
    assert [s.name for s in spans] == ["grm.product"]
    assert {d.call for d in profiling.device_spans()} == {spans[0].call}


def test_fit_spans(grm):
    op, rng = grm
    N, P = op.n_samples, 2
    X = torch.as_tensor(np.column_stack([np.ones(N),
                                         rng.normal(size=(N, 2))]))
    Y = torch.as_tensor((rng.random((P, N)) < 0.3).astype(np.float64))
    eta = torch.full((P, N), float(np.log(0.3 / 0.7)), dtype=torch.float64)
    tau = torch.tensor([[1.0, 0.1]] * P, dtype=torch.float64)
    U = torch.as_tensor(rng.choice([-1.0, 1.0], size=(N, 12)))
    op.matvec(U[:, :1])
    matvecs = op.matvecs
    _traced(fit_glmm_binary_device_multi, op, Y, X, tau, eta, U, 0.02,
            1e-4, maxiter=2, maxiter_pcg=50, nrun=2)
    spans = profiling.spans()
    roots = [s for s in spans if s.name == "fit.call"]
    assert len(roots) == 1
    assert {s.call for s in spans} == {roots[0].call}
    names = {s.name for s in spans}
    assert {"fit.lane_groups", "fit.group", "fit.irls", "fit.ai_step",
            "fit.traces", "fit.pcg", "grm.product"} <= names
    assert sum(s.name == "grm.product" for s in spans) == \
        op.matvecs - matvecs


def test_profile_trace_records_producer_threads(scan_data, tmp_path):
    with profile_trace(str(tmp_path / "trace"), device="cpu"):
        _scan(scan_data)
    with open(tmp_path / "trace" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    decode = {e.get("tid") for e in events if e.get("name") == "scan.decode"}
    calls = {e.get("tid") for e in events if e.get("name") == "scan.call"}
    assert decode and calls and not decode & calls


def test_off_span_site_is_cheap():
    """With the profiler off a span site records nothing, and costs far
    less than the work it marks (here 20 us, a bound no real site nears:
    a GRM product is milliseconds)."""
    def site():
        with profiling.span("x"):
            pass
    n = 20000
    held = len(profiling.spans())
    assert timeit.timeit(site, number=n) / n < 20e-6
    assert len(profiling.spans()) == held
    inst = {"k": []}
    with profiling.span("x", inst, "k"):
        pass
    profiling.count("c", 3, inst, "n")
    assert len(inst["k"]) == 1 and inst["n"] == 3
