"""Entry ``predictor``: ``serving.Predictor`` in a closed loop.

Set-up makes the cell's knees and weights from the seed and builds the
predictor through ``make_predictor`` in the traffic's dtype; with
``quant`` it first calibrates the int8 activation statistics in memory on
the first batch (``quantized_model_config`` → ``calibrate_quant_acts``).
It warms the batch's shape up. The window sends one request after another,
each the next ``batch`` knees of the cohort in turn, as raw host arrays,
and times each from the hand-over to the probabilities on the host.

The check: the reference scores every knee of the cohort in float32, and
every answer of the window is compared with it by the logit difference
that decides the class, log p1 − log p0 against l1 − l0 (:func:`gap`).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import harness
from benchmark.reference import nets, preprocess
from benchmark.traffic.knees import Cohort

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def batches(cohort: Cohort, batch: int) -> list:
    n = len(cohort) // batch
    return [cohort.batch(range(i * batch, (i + 1) * batch))
            for i in range(n)]


def build(cell: dict, sd: dict, calib_xs, device):
    from oaprogressionmmf_torch.serving import (calibrate_quant_acts,
                                                make_predictor,
                                                quantized_model_config)
    tr, model = cell["traffic"], cell["model"]
    modals = cell["config_file"]["modals"]
    dtype = DTYPES[tr["dtype"]]
    quant = tr.get("quant")
    if not quant:
        return make_predictor(model, sd, modals, model.get("downscale"),
                              device=device, dtype=dtype)
    calib = make_predictor(
        quantized_model_config(model, "calib",
                               include_agg=quant == "int8-all"),
        sd, modals, model.get("downscale"), device=device, dtype=dtype)
    acts = calibrate_quant_acts(calib, [calib_xs])
    del calib
    harness.free(device)
    return make_predictor(quantized_model_config(model, quant), sd, modals,
                          model.get("downscale"), device=device,
                          dtype=dtype, quant_acts=acts)


def reference_logits(cell: dict, cohort: Cohort, seed: int, device,
                     prec=nets.FLOAT32) -> np.ndarray:
    """l1 − l0 of every knee of the cohort, float32, in blocks of the
    traffic's batch."""
    model, modals = cell["model"], cell["config_file"]["modals"]
    sd = nets.make_weights(model, seed, device)
    b = int(cell["traffic"]["batch"])
    out = []
    with torch.no_grad():
        for xs in batches(cohort, b):
            inputs = preprocess.eval_inputs(
                modals, model.get("downscale"),
                [torch.from_numpy(x).to(device) for x in xs])
            logits = nets.forward(model, sd, inputs, prec=prec)
            out.append((logits[:, 1] - logits[:, 0]).cpu().numpy())
    return np.concatenate(out)


def gap(answers: list, want: np.ndarray, batch: int) -> float:
    """The widest gap of an answer's log p1 − log p0 from the reference's
    l1 − l0 for its knee. ``answers``: (batch index, probabilities)."""
    worst = 0.0
    for i, probs in answers:
        with np.errstate(divide="ignore"):
            got = (np.log(probs[:, 1].astype(np.float64))
                   - np.log(probs[:, 0].astype(np.float64)))
        diff = np.abs(got - want[i * batch:(i + 1) * batch])
        worst = max(worst, float(np.max(np.where(np.isfinite(diff), diff,
                                                 np.inf))))
    return worst


def run(r: harness.Run) -> None:
    cell, dev, seed = r.cell, r.device, r.seed
    tr = cell["traffic"]
    b = int(tr["batch"])
    cohort = Cohort(cell["model"], cell["config_file"]["modals"], tr, seed,
                    dev)
    reqs = batches(cohort, b)
    predictor = build(cell, nets.make_weights(cell["model"], seed, dev),
                      reqs[0], dev)
    harness.free(dev)
    for i in range(int(tr.get("warmup", 3))):
        predictor(reqs[i % len(reqs)]).cpu()

    answers, latency = [], []
    with r.window.run() as w:
        i = 0
        while True:
            t0 = time.perf_counter()
            probs = predictor(reqs[i % len(reqs)]).cpu().numpy()
            latency.append(time.perf_counter() - t0)
            answers.append((i % len(reqs), probs))
            i += 1
            if w.done():
                break
    r.close_window()
    r.attempted = len(answers)
    r.failed = sum(not np.isfinite(p).all() for _, p in answers)
    r.values["eval_knees_per_s"] = len(answers) * b / w.elapsed
    r.values["request_p95_ms"] = float(np.percentile(latency, 95)) * 1e3
    r.counters.update(requests=len(answers), knees=len(answers) * b,
                      latency_p50_ms=float(np.percentile(latency, 50)) * 1e3)
    del predictor
    harness.free(dev)

    t0 = time.perf_counter()
    with harness.reference_precision():
        want = reference_logits(cell, cohort, seed, dev)
    r.counters["check_s"] = time.perf_counter() - t0
    r.check("logit_gap", gap(answers, want, b), cell["limits"]["logit_gap"])
