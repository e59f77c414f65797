"""Cells of the benchmark at sizes a CPU test can hold: the cells' own
files, with the model's widths, inputs and cohort cut down.

A configuration's model at test size is ``sizes/<config>.json`` beside
this file; every configuration that has one is held against the program
and against ``FlopCounterMode`` (``test_bench_reference.py``).
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

from benchmark import harness

SIZES = Path(__file__).resolve().parent / "sizes"


def size(config: str) -> dict:
    """The model of configuration ``config`` at test size."""
    return harness.load_json(SIZES / f"{config}.json")


def configs() -> list:
    """The configurations that have a test size."""
    return sorted(p.stem for p in SIZES.glob("*.json"))


def modals(config: str) -> list:
    """The modalities that configuration ``config`` reads, in order."""
    return harness.load_json(harness.HERE / "configs"
                             / f"{config}.json")["modals"]


FLAGSHIP = size("xr1mr2c1_cnntrf")
MR1 = size("mr1_cnntrf")


def cell(name: str, **traffic) -> dict:
    """The cell ``name`` with its model cut to test size, its batch to 4
    where larger (to 2 a rank where it has several ranks), its cohort to
    three batches and ``traffic`` overridden."""
    c = copy.deepcopy(harness.cell(name))
    c["model"] = size(c["config"])
    tr = c["traffic"]
    ranks = int(tr.get("ranks", 1))
    # not 1 a rank: at test size the X-ray branch ends in 1x1 maps, and
    # GlobalBatchNorm2d reads a rank's channel of one value as of infinite
    # variance (torch gives such a channel an inverse deviation of 0)
    tr["batch"] = min(int(tr["batch"]), 4 if ranks == 1 else 2 * ranks)
    tr["knees"] = 3 * tr["batch"]
    if "num_workers" in tr:
        tr["num_workers"] = 2
    tr.update(traffic)
    return c


# a run of a cell of several ranks, in a process of its own, ends within
RANKS_TIMEOUT_S = 300
# that process: one run of the cell given on standard input, its outcome
# as the last line of standard output
_APART = """
import json, sys
from benchmark.tests import tiny
c, seed, seconds, traced = json.loads(sys.stdin.read())
r = tiny.run_here(c, seed, seconds, traced)
print(json.dumps({k: getattr(r, k) for k in tiny.OUTCOME}))
"""
OUTCOME = ("checks", "readings", "attempted", "failed", "values",
           "counters")


def run(c: dict, seed: int = 3, seconds: float = 0.01,
        traced: bool = False) -> harness.Run:
    """One run of cell ``c`` on the CPU, past the look for a card. A cell
    of several ranks (traffic ``ranks``) runs in a process of its own,
    which starts the other ranks as the benchmark's process does, held to
    ``RANKS_TIMEOUT_S``; its run carries the outcome (``OUTCOME``) and no
    trace."""
    ranks = int(c["traffic"].get("ranks", 1))
    if ranks == 1:
        return run_here(c, seed, seconds, traced)
    # the ranks share the cores: torch's threads spinning on every core in
    # every rank slow a step many times over
    threads = str(max(1, (os.cpu_count() or 1) // ranks))
    proc = subprocess.run(
        [sys.executable, "-c", _APART], input=json.dumps(
            [c, seed, seconds, traced]), capture_output=True, text=True,
        cwd=harness.ROOT, timeout=RANKS_TIMEOUT_S,
        env=dict(os.environ, OMP_NUM_THREADS=threads))
    if proc.returncode != 0:
        raise RuntimeError(f"{c['name']} exited {proc.returncode}:\n"
                           f"{proc.stderr[-6000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    r = harness.Run(c, seed, seconds, traced, torch.device("cpu"), 0.0)
    for k in OUTCOME:
        setattr(r, k, out[k])
    r.checks = {k: tuple(v) for k, v in r.checks.items()}
    return r


def run_here(c: dict, seed: int = 3, seconds: float = 0.01,
             traced: bool = False) -> harness.Run:
    """One run of cell ``c`` on the CPU in this process."""
    r = harness.Run(c, seed, seconds, traced, torch.device("cpu"),
                    time.perf_counter())
    harness.driver(c["entry"]).run(r)
    return r
