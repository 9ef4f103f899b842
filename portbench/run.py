"""One run of one cell of the benchmark of ``saigegds_tpu_torch``.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Needs as many CUDA cards as the cell asks for: without them it exits
with code 3 and prints no result.  Set-up (inputs drawn from the seed,
the program's state built, every shape the calls use warmed up) is timed
as ``setup_s``; then the mix's calls run back to back, each with its
outputs on the host, until ``--seconds`` have passed (the call under way
then finishes and counts); the rate is all the calls' work over the time
from the first call's start to the last call's end.  With ``--trace 1``
the window runs under the profiler and the line carries the cell's
per-layer metrics instead of its end-to-end ones.  After the window the
program's state is dropped and the plain reference judges the window's
answers: every number compared is printed beside its limit, last on
standard error and last in the result line, and ``correct`` is true when
each is within its limit.  The last line of standard output is the
result as one JSON object."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# caches of compilers the program may use, kept at fixed paths inside the
# checkout so that only a checkout's first run builds
for _var, _dir in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ.setdefault(_var, os.path.join(ROOT, ".portbench_cache", _dir))
os.environ.setdefault("USE_FLAX", "0")

FORBIDDEN = ("jax", "jaxlib", "flax", "saigegds_tpu")


def log(msg: str):
    print(f"[portbench {time.perf_counter() - T_START:8.2f}s] {msg}",
          file=sys.stderr, flush=True)


def entry_class(name: str):
    """The driver that a mix names: the class ``Entry`` of
    ``portbench/entries/<name>.py``."""
    return importlib.import_module(f"portbench.entries.{name}").Entry


def forbidden_modules() -> list:
    """Modules loaded whose top-level name is JAX's or the JAX
    package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def within(numbers: dict, limits: dict) -> dict:
    """Each number with its limit; a number without a limit fails."""
    return {k: dict(value=v, limit=limits.get(k)) for k, v in
            numbers.items()}


def run_cell(cfg: dict, mix: dict, e2e: list, per_layer: list,
             limits: dict, seed: int, seconds: float, trace: bool, device,
             t_start: float = T_START, entry_wrap=None) -> dict:
    """One run of the cell of configuration ``cfg`` and mix ``mix`` on
    ``device``: the result's fields but ``device``'s name and count.
    ``entry_wrap(state)`` (tests, the control) may put something else in
    the program's place after set-up."""
    import torch
    from portbench import spec as spec_mod
    from portbench.trace import Tracer, now_ns

    cuda = torch.device(device).type == "cuda"
    with tempfile.TemporaryDirectory(prefix="portbench-") as work:
        state = entry_class(mix["entry"])(cfg, mix, seed, device, trace, log,
                                          work)
        try:
            if entry_wrap is not None:
                entry_wrap(state)
            if cuda:
                torch.cuda.synchronize()
            setup_s = time.perf_counter() - t_start
            log(f"set-up done: {setup_s:.3f} s")
            tracer = Tracer() if trace else None
            records = []
            w0, w0_ns = time.perf_counter(), now_ns()
            while True:
                a = time.perf_counter()
                rec = state.call(len(records))
                rec["seconds"] = time.perf_counter() - a
                records.append(rec)
                log(f"call {len(records) - 1}: {rec['seconds']:.3f} s, "
                    f"work {state.work(rec)}")
                if time.perf_counter() - w0 >= seconds:
                    break
            window = time.perf_counter() - w0
            w1_ns = now_ns()
            summary = tracer.stop(w0_ns, w1_ns) if tracer else None
            peak = torch.cuda.max_memory_allocated(device) if cuda else 0
            work_done = sum(state.work(r) for r in records)
            values = {"setup_s": setup_s,
                      mix["rate_metric"]: work_done / window *
                      mix["rate_per"]}
            ctx = dict(entry=mix["entry"], counters=state.counters(records),
                       trace=summary, calls=records, window_s=window,
                       config=cfg, mix=mix)
            metrics = {}
            if trace:
                for m in per_layer:
                    v = spec_mod.reader(m["name"])(ctx)
                    if v is not None:
                        metrics[m["name"]] = dict(value=v, unit=m["unit"])
            else:
                for m in e2e:
                    metrics[m["name"]] = dict(value=values[m["name"]],
                                              unit=m["unit"])
            prog = state.release(records)
            del ctx
            gc.collect()
            if cuda:
                torch.cuda.empty_cache()
            log(f"window {window:.3f} s, {len(records)} calls, work "
                f"{work_done}; checking")
            checks = within(state.readings(prog)[0], limits)
        finally:
            state.close()
    out = dict(correct=all(c["limit"] is not None and
                           c["value"] <= c["limit"]
                           for c in checks.values()),
               attempted=work_done,
               failed=sum(state.failed(r) for r in records),
               metrics=metrics, peak=peak, trace=summary,
               calls=[r["seconds"] for r in records], checks=checks)
    return out


def card_name(torch) -> str:
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        smi = "nvidia-smi: not read"
    return f"{torch.cuda.get_device_name(0)} ({smi.splitlines()[0]})" \
        if smi else torch.cuda.get_device_name(0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    from portbench.spec import Spec
    spec = Spec()
    cell = spec.cell(a.workload)
    cfg, mix = spec.config(cell["config"]), spec.mix(cell["traffic"])
    limits = spec.limits(a.workload)

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        found = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        print(f"portbench: {a.workload} needs {cell['chips']} CUDA "
              f"card(s); found {found}", file=sys.stderr)
        return 3
    import saigegds_tpu_torch  # noqa: F401  (fails where the port is not)
    log(f"card: {card_name(torch)}; torch {torch.__version__}; "
        f"{a.workload} seed {a.seed} seconds {a.seconds} trace {a.trace}")
    res = run_cell(cfg, mix, spec.end_to_end(a.workload),
                   spec.per_layer(a.workload), limits, a.seed, a.seconds,
                   bool(a.trace), torch.device("cuda", 0))
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the process loaded {bad}", file=sys.stderr)
        return 4
    device = dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                  count=cell["chips"], memory_peak_bytes=res["peak"])
    line = dict(correct=res["correct"], attempted=res["attempted"],
                failed=res["failed"], metrics=res["metrics"], device=device)
    t = res["trace"]
    if t is not None:
        device.update(busy_s=t["busy_s"], window_s=t["window_s"])
        line["breakdown"] = dict(device_ops=t["device_ops"],
                                 idle_gaps=t["idle_gaps"])
        log(f"trace: {t['device_events']} device events, {t['gaps']} "
            f"idle gaps")
    log("calls (s): " + ", ".join(f"{s:.3f}" for s in res["calls"]))
    line["checks"] = res["checks"]
    for k, c in res["checks"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
