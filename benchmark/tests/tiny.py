"""Cells of the benchmark at sizes a CPU test can hold: the cells' own
files, with the model's widths, inputs and cohort cut down.

A configuration's model at test size is ``sizes/<config>.json`` beside
this file; every configuration that has one is held against the program
and against ``FlopCounterMode`` (``test_bench_reference.py``).
"""

from __future__ import annotations

import copy
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
    where larger, its cohort to three batches and ``traffic``
    overridden."""
    c = copy.deepcopy(harness.cell(name))
    c["model"] = size(c["config"])
    tr = c["traffic"]
    tr["batch"] = min(int(tr["batch"]), 4)
    tr["knees"] = 3 * tr["batch"]
    if "num_workers" in tr:
        tr["num_workers"] = 2
    tr.update(traffic)
    return c


def run(c: dict, seed: int = 3, seconds: float = 0.01,
        traced: bool = False) -> harness.Run:
    """One run of cell ``c`` on the CPU, past the look for a card."""
    r = harness.Run(c, seed, seconds, traced, torch.device("cpu"),
                    time.perf_counter())
    harness.driver(c["entry"]).run(r)
    return r
