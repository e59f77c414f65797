"""Cells of the benchmark at sizes a CPU test can hold: the cells' own
files, with the model's widths, inputs and cohort cut down."""

from __future__ import annotations

import copy
import time

import torch

from benchmark import harness

FLAGSHIP = {
    "name": "XR1MR2C1CnnTrf",
    "input_size": [[64, 64], [32, 32, 8], [32, 32, 4], [16]],
    "downscale": [[0.5, 0.5], [0.5, 0.5, 0.5], [0.5, 0.5, 1.0], [1.0]],
    "input_channels": 1, "output_channels": 2, "output_type": "dict",
    "fe": {"xr": {"arch": "resnet18", "pretrained": False, "with_gap": True,
                  "dropout": 0.1},
           "mr": {"arch": "resnet18", "pretrained": False, "with_gap": True,
                  "dropout": 0.1},
           "clin": {"dim_in": 9, "dim_out": 512, "dropout": 0.1}},
    "agg": {"num_slices": [1, 4, 4, 1], "depth": 1, "heads": 2,
            "emb_dropout": 0.1, "mlp_dim": 64, "mlp_dropout": 0.1},
    "pretrained": False, "restore_weights": False, "debug": False,
}
MR1 = {
    "name": "MR1CnnTrf",
    "input_size": [[32, 32, 8]], "downscale": [[0.5, 0.5, 0.5]],
    "input_channels": 1, "output_channels": 2, "output_type": "dict",
    "fe": {"arch": "resnet50", "pretrained": False, "with_gap": True,
           "dropout": 0.0, "dims_view": "rc"},
    "agg": {"num_slices": None, "depth": 1, "heads": 2, "emb_dropout": 0.1,
            "mlp_dim": 64, "mlp_dropout": 0.1},
    "pretrained": False, "restore_weights": False, "debug": False,
}
MODELS = {"xr1mr2c1_cnntrf": FLAGSHIP, "mr1_cnntrf": MR1}


def cell(name: str, **traffic) -> dict:
    """The cell ``name`` with its model cut to test size, its batch to 4
    where larger, its cohort to three batches and ``traffic``
    overridden."""
    c = copy.deepcopy(harness.cell(name))
    c["model"] = copy.deepcopy(MODELS[c["config"]])
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
