"""Entry ``train_epoch``: ``ProgressionTrainer.train_epoch`` of one fold on
an in-memory synthetic cohort.

Set-up builds one trainer with the benchmark's weights and runs epoch 0
through ``train_epoch``: it warms every shape up, and its first three
steps are recorded (their losses, step one's logits, the optimizer's
first moment after step one, the parameters after step three). In those
three steps the program's dropouts take masks drawn from the seed
(``nets.Masks``) in place of their own draws, the only thing that differs
from the window's steps. The window runs whole epochs from epoch 1 on,
with no validation and no checkpoint, and counts every knee that a step
trained.

The check: the reference trains the same three steps from the same
weights in float32 (the sampler's order, the augmentation's draws and the
dropout masks worked out again from the seeds) and is compared with the
recording (:func:`gaps`).
"""

from __future__ import annotations

import math
import tempfile
import time
from contextlib import contextmanager

import numpy as np
import torch

from benchmark import harness
from benchmark.reference import nets, preprocess, train as ref_train
from benchmark.traffic.knees import Cohort

RECORDED_STEPS = 3
BETA1 = 0.9
# a leaf whose reference gradient is under this share of the median
# leaf's is moved by Adam's rounding alone, and is not compared
TINY_GRAD = 1e-3


def trainer_config(cell: dict, seed: int, root: str) -> dict:
    conf, tr = cell["config_file"], cell["traffic"]
    modals = conf["modals"]
    return {
        "model": cell["model"],
        "data": {"modals_all": modals,
                 "sets": {"n0": {"name": "oai", "modals": modals,
                                 "frac_classw": 1.0}},
                 "target": "prog_kl_48", "exclude_surg": False,
                 "exclude_inj": False, "ignore_cache": False,
                 "debug": False},
        "training": dict(conf["training"], batch_size=int(tr["batch"]),
                         epochs={"num": 1 << 20}),
        "validation": conf["validation"], "testing": conf["testing"],
        "runtime": {"compute_dtype": tr["compute_dtype"]},
        "num_workers": int(tr["num_workers"]),
        "loader_backend": tr["loader_backend"],
        "seed_trainval_test": seed, "seed_train_val": seed,
        "site_test": "D", "path_experiment_root": root,
    }


def _host(t: torch.Tensor) -> torch.Tensor:
    """A float32 copy on the host, apart from the program's tensor."""
    return t.detach().to("cpu", torch.float32, copy=True)


@contextmanager
def given_masks(masks):
    """The program's dropouts (every ``F.dropout`` in training, which
    ``nn.Dropout`` calls too) take ``masks`` instead of their own draws."""
    functional = torch.nn.functional
    original = functional.dropout

    def dropout(input, p=0.5, training=True, inplace=False):
        if not training or not p:
            return original(input, p, training, inplace)
        return masks(input, p)

    functional.dropout = dropout
    try:
        yield
    finally:
        functional.dropout = original


def first_moment(rt) -> dict:
    """Adam's first moment of each parameter, on the host (zero for a
    parameter that the steps left without state)."""
    return {name: _host(rt.optimizer.state[p].get("exp_avg",
                                                  torch.zeros_like(p)))
            for name, p in zip(rt.param_names, rt.params)}


def parameters(rt) -> dict:
    """The parameters, on the host."""
    return {name: _host(p) for name, p in zip(rt.param_names, rt.params)}


def _record(rt, steps: list, seed: int):
    """Wrap ``rt.train_step`` so that its first calls take the seed's
    dropout masks and are recorded; returns the original."""
    original = rt.train_step

    def recorded(*args, **kwargs):
        n = len(steps)
        if n >= RECORDED_STEPS:
            return original(*args, **kwargs)
        with given_masks(nets.Masks(seed, n)):
            loss, logits = original(*args, **kwargs)
        rec = {"loss": float(loss)}
        if n == 0:
            rec["logits"] = _host(logits)
            rec["exp_avg"] = first_moment(rt)
        if n == RECORDED_STEPS - 1:
            rec["params"] = parameters(rt)
        steps.append(rec)
        return loss, logits

    rt.train_step = recorded
    return original


def program_readings(steps: list, sd0: dict, weight_decay: float) -> dict:
    """The recording as the reference gives its numbers: losses, the loss
    gradient of step one (Adam's first moment is (1 − β1)(g + wd·p0) after
    one step) and the parameters after the last recorded step."""
    dev = next(iter(sd0.values())).device
    grads = {k: m.to(dev) / (1 - BETA1) - weight_decay * sd0[k]
             for k, m in steps[0]["exp_avg"].items()}
    return {"losses": [s["loss"] for s in steps],
            "logits": steps[0]["logits"].to(dev), "grads": grads,
            "params": {k: v.to(dev) for k, v in steps[-1]["params"].items()}}


def batch_rows(cell: dict, order: np.ndarray, step: int) -> np.ndarray:
    """The knees of step ``step``: rows [b·step, b·(step + 1)) of the
    epoch's ``order``."""
    b = int(cell["traffic"]["batch"])
    return order[step * b:(step + 1) * b]


def reference_batches(cell: dict, cohort: Cohort, seed: int, device,
                      rows=batch_rows):
    """The recorded steps' batches, worked out again: the sampler's order
    of epoch 0, each step's knees (``rows(cell, order, step)``) and its
    augmentation draws."""
    model, modals = cell["model"], cell["config_file"]["modals"]
    b = int(cell["traffic"]["batch"])
    order = preprocess.epoch_order(cohort.targets(), seed, 0)
    for step in range(RECORDED_STEPS):
        idx = rows(cell, order, step)
        xs = [torch.from_numpy(x).to(device) for x in cohort.batch(idx)]
        draws = preprocess.step_draws(seed, 0, step, modals, b, device)
        inputs = preprocess.train_inputs(modals, model.get("downscale"),
                                         xs, draws)
        yield inputs, torch.from_numpy(cohort.targets()[idx]).to(device)


def reference_readings(cell: dict, cohort: Cohort, seed: int, device,
                       prec=nets.FLOAT32, rows=batch_rows) -> dict:
    """The recorded steps of the reference, in ``prec``."""
    model = cell["model"]
    sd = nets.make_weights(model, seed, device)
    steps_per_epoch = len(cohort) // int(cell["traffic"]["batch"])
    out = ref_train.train_steps(
        model, cell["config_file"]["training"], sd,
        reference_batches(cell, cohort, seed, device, rows),
        steps_per_epoch,
        seed, prec)
    out["params"] = {k: sd[k] for k in ref_train.trainable(sd)}
    return out


def control_readings(cell: dict, cohort: Cohort, seed: int, device,
                     prec, rows=batch_rows) -> dict:
    """The check's numbers (:func:`gaps`) with the reference in ``prec``
    in the program's place (``control.py``)."""
    sd0 = nets.make_weights(cell["model"], seed, device)
    ctl = reference_readings(cell, cohort, seed, device, prec, rows)
    ref = reference_readings(cell, cohort, seed, device, rows=rows)
    return gaps(ctl, ref, sd0)


def gaps(prog: dict, ref: dict, sd0: dict) -> dict:
    """The numbers that can be compared: the widest gap of step one's
    logit difference l1 − l0 over the batch (``logit1_gap``) and its root
    mean square over the batch (``logit1_rms``); relative
    gaps of the program's reading from the reference's: of step one's loss
    (``loss1_gap``) and of the later steps' (``loss_later_gap``, the
    largest); of each leaf's gradient norm in step one and of its change
    over the recorded steps, as the median leaf reads it (``grad_gap``,
    ``delta_gap``) and as the worst does (``grad_worst_gap``,
    ``delta_worst_gap``). A leaf's gap is measured against the larger of
    its reference norm and the median leaf's. Leaves whose reference
    gradient is under TINY_GRAD of the median leaf's are left out. The
    workload's ``limits`` say which are compared."""
    loss = [abs(p - r) / abs(r)
            for p, r in zip(prog["losses"], ref["losses"])]
    l_prog, l_ref = (x[:, 1] - x[:, 0] for x in (prog["logits"],
                                                 ref["logits"]))
    names = list(ref["grads"])
    g_ref = {k: float(ref["grads"][k].norm()) for k in names}
    g_med = float(np.median(list(g_ref.values())))
    keep = [k for k in names if g_ref[k] >= TINY_GRAD * g_med]
    grad = [abs(float(prog["grads"][k].norm()) - g_ref[k])
            / max(g_ref[k], g_med) for k in keep]
    d_ref = {k: float((ref["params"][k] - sd0[k]).norm()) for k in keep}
    d_med = float(np.median(list(d_ref.values())))
    delta = [abs(float((prog["params"][k] - sd0[k]).norm()) - d_ref[k])
             / max(d_ref[k], d_med) for k in keep]
    d_logit = l_prog - l_ref
    return {"logit1_gap": float(d_logit.abs().max()),
            "logit1_rms": float(d_logit.square().mean().sqrt()),
            "loss1_gap": loss[0], "loss_later_gap": max(loss[1:]),
            "grad_gap": float(np.median(grad)), "grad_worst_gap": max(grad),
            "delta_gap": float(np.median(delta)),
            "delta_worst_gap": max(delta), "leaves": len(keep),
            "leaves_left_out": len(names) - len(keep)}


def _train(r: harness.Run, cohort: Cohort) -> list:
    """Set-up, epoch 0 recorded, and the window. Returns the recording."""
    from oaprogressionmmf_torch.train.trainer import ProgressionTrainer

    cell, dev, seed = r.cell, r.device, r.seed
    b = int(cell["traffic"]["batch"])
    with tempfile.TemporaryDirectory(prefix="bench-train-") as root:
        trainer = ProgressionTrainer(
            trainer_config(cell, seed, root), 0, device=dev,
            datasets={"train": cohort, "val": cohort, "test": cohort})
        rt = trainer.runtime
        rt.model.load_state_dict(nets.make_weights(cell["model"], seed, dev),
                                 strict=True)
        harness.free(dev)
        steps: list = []
        original = _record(rt, steps, seed)
        trainer.train_epoch(0)
        rt.train_step = original
        if len(steps) < RECORDED_STEPS:
            raise RuntimeError("epoch 0 ran fewer steps than are recorded")

        t = trainer.timing
        steps0, wait0 = t["train_steps"], t["loader_wait"]
        epoch, bad = 1, 0
        with r.window.run() as w:
            while not w.done():
                loss = trainer.train_epoch(epoch)["loss_prog"]
                bad += not math.isfinite(loss)
                epoch += 1
        r.close_window()
        n_steps = t["train_steps"] - steps0
        knees = n_steps * b
        r.attempted = n_steps
        r.failed = bad
        r.values["train_knees_per_s"] = knees / w.elapsed
        r.counters.update(steps=n_steps, epochs=epoch - 1, knees=knees,
                          loader_wait_s=t["loader_wait"] - wait0)
        del trainer, rt, original
    harness.free(dev)
    return steps


def _check(r: harness.Run, steps: list, cohort: Cohort,
           rows=batch_rows) -> None:
    """The recording ``steps`` against the reference over the same
    steps' knees (``rows``, as :func:`reference_batches` takes them)."""
    cell, dev, seed = r.cell, r.device, r.seed
    t0 = time.perf_counter()
    sd0 = nets.make_weights(cell["model"], seed, dev)
    wd = float(cell["config_file"]["training"]["optim"].get("weight_decay")
               or 0.0)
    prog = program_readings(steps, sd0, wd)
    del steps
    with harness.reference_precision():
        ref = reference_readings(cell, cohort, seed, dev, rows=rows)
    found = gaps(prog, ref, sd0)
    r.counters["check_s"] = time.perf_counter() - t0
    for name, value in found.items():
        if name in cell["limits"]:
            r.check(name, value, cell["limits"][name])
        else:
            r.readings[name] = value


def run(r: harness.Run) -> None:
    cohort = Cohort(r.cell["model"], r.cell["config_file"]["modals"],
                    r.cell["traffic"], r.seed, r.device)
    steps = _train(r, cohort)
    _check(r, steps, cohort)
