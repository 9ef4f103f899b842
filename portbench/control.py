"""The readings that a cell's limits are set from, at the cell's own
size on a card: for each seed, set-up, a short window of the cell's
calls (``--seconds``; one call at 0), then the program's numbers and the
float32 control's (the reference in float32 in the program's place),
both against one float64 reference.

    python3 portbench/control.py --workload <cell> --seconds 0 \\
        --seeds 3000000101 3000000102 3000000103

Prints one JSON line per seed: ``program`` and ``control``, each a map
of the numbers compared; a control that raises is reported as such (it
sets no upper reading).  The benchmark's own runs never run this."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def readings(cell: str, cfg: dict, mix: dict, spec, seed: int,
             seconds: float, device) -> dict:
    import torch
    from portbench import run
    got = {}

    def wrap(state):
        real = state.readings

        def readings(prog, dtypes=()):
            try:
                got["program"], (got["control"],) = real(
                    prog, (torch.float32,))
            except Exception as e:     # a control that fails has no number
                got["program"] = real(prog)[0]
                got["control"] = f"raised {type(e).__name__}: {e}"
            return got["program"], []
        state.readings = readings

    res = run.run_cell(cfg, mix, spec.end_to_end(cell),
                       spec.per_layer(cell), spec.limits(cell), seed,
                       seconds, False, device, t_start=time.perf_counter(),
                       entry_wrap=wrap)
    return dict(seed=seed, calls=res["calls"], attempted=res["attempted"],
                **got)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    a = ap.parse_args(argv)
    import torch
    from portbench.spec import Spec
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 3
    spec = Spec()
    c = spec.cell(a.workload)
    cfg, mix = spec.config(c["config"]), spec.mix(c["traffic"])
    for seed in a.seeds:
        print(json.dumps(readings(a.workload, cfg, mix, spec, seed,
                                  a.seconds, torch.device("cuda", 0)),
                         default=float), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
