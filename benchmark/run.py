"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. The cell is ``BENCHMARK.json``'s workload of
that name; its files are found by name under ``benchmark/`` (see
``harness.py``). Set-up runs from process start to the window, the window
lasts ``--seconds``, then the window's answers are checked against the
plain reference. The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each compared number with
its limit); the last lines of standard error repeat the checks. Exits with
2 and prints no result without enough CUDA devices, with 3 when a module
of JAX or of the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    # the program's kernel caches stay inside the checkout, at fixed paths
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import harness

    spec = harness.bench_spec(ROOT)
    entry = next((w for w in spec["workloads"]
                  if w["name"] == args.workload), None)
    if entry is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    chips = int(entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" available", file=sys.stderr)
        return 2
    cell = harness.cell(args.workload)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    run = harness.Run(cell, abs(args.seed), args.seconds, bool(args.trace),
                      device, T_START, chips)
    harness.driver(cell["entry"]).run(run)
    found = harness.forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    out = harness.result(run, spec)
    sys.stdout.flush()
    for name, value in run.readings.items():
        print(f"reading {name} {value!r} (not compared)", file=sys.stderr)
    for name, (value, limit) in run.checks.items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
