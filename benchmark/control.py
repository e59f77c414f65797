"""The control of a cell's check: the plain reference in the precision
below the configuration's (the workload's ``control``: fp8 below bf16,
int4 below int8) put in the program's place, and judged as the program
is: its readings go through the cell's check (``harness.Run.check``) and
have to come out not correct. Its readings set the upper end of each
limit.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3

Prints one JSON line per seed: ``correct`` as the check decides it, the
compared numbers beside their limits and the other readings. A cell's
runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(cell: dict, seed: int, device) -> dict:
    """The numbers that the cell's check compares, with the reference in
    the control's precision in the program's place: the cell's entry
    (``drivers/<entry>.py``) gives them by its ``control_readings(cell,
    cohort, seed, device, prec)``."""
    from benchmark import harness
    from benchmark.reference import nets
    from benchmark.traffic.knees import Cohort

    prec = nets.Precision(cell["control"])
    cohort = Cohort(cell["model"], cell["config_file"]["modals"],
                    cell["traffic"], seed, device)
    drv = harness.driver(cell["entry"])
    with harness.reference_precision():
        return drv.control_readings(cell, cohort, seed, device, prec)


def judged(cell: dict, found: dict, seed: int = 0, device=None):
    """A run of the cell whose answers are the control's: each number that
    the cell compares checked against its limit; ``.correct`` decides."""
    from benchmark import harness
    r = harness.Run(cell, seed, 0.0, False, device, 0.0)
    for name, limit in cell["limits"].items():
        r.check(name, found[name], limit)
    r.readings = {k: v for k, v in found.items() if k not in r.checks}
    return r


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import harness
    cell = harness.cell(args.workload)
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu",
                          0)
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = judged(cell, readings(cell, seed, device), seed, device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": cell["control"],
                          "correct": r.correct,
                          "checks": {k: {"value": v, "limit": lim}
                                     for k, (v, lim) in r.checks.items()},
                          "readings": r.readings,
                          "seconds": time.perf_counter() - t0}), flush=True)
        harness.free(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
