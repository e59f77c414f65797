"""One rank of the port's data- and tensor-parallel check on the CPU.

``python tests/torch_port_parallel_worker.py PLAN RANK`` joins a gloo
process group of four ranks (``parallel.dcn.initialize_distributed``)
and runs, on sub-groups, the steps that ``test_torch_port_parallel.py``
compares; each rank saves what it ran to ``{out}/rank{RANK}.pt``. It
imports the port only (the JAX package stays out of these processes).

Stages (every rank calls every ``new_group``, members or not):
  1. ranks {0, 1}: two-process DP, class-weighted CE (``ce``); ranks
     {2, 3}: two-process DP, focal loss at 2 knees a rank (``bn``); each
     also one step in float64 (``*_dp64``);
  2. rank 0: ``ce`` in one process on the whole batch (and its float64
     step); rank 2: ``bn`` likewise; ranks {1, 3}: the grid's data in
     two-process DP (``grid_dp``, 4 steps, and one float64 step,
     ``grid_dp64``);
  3. all four: the 2×2 dp×tp grid on that data (``grid``, 4 steps, and
     one float64 step, ``grid64``, its moments made whole);
  4. all four: ``ProgressionTrainer.fit`` data-parallel over the world
     (one epoch of in-memory knees; ``fit``), then the
     ``ProgressionEvaluator`` of its checkpoint (``eval``), and a dropout
     mask from the seed the fit's steps take on this rank
     (``dropout_masks``).
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch
import torch.distributed as dist

from oaprogressionmmf_torch.models.feat import Attention
from oaprogressionmmf_torch.parallel.dcn import initialize_distributed
from oaprogressionmmf_torch.parallel.mesh import DataParallel
from oaprogressionmmf_torch.parallel.tp import (create_grid, full_state_dict,
                                                unshard)
from oaprogressionmmf_torch.train.evaluator import ProgressionEvaluator
from oaprogressionmmf_torch.train.trainer import (ProgressionTrainer,
                                                  TrainRuntime)


def raw_inputs(sizes, batch: int, seed: int) -> tuple:
    """Raw per-modality inputs (uint8 X-ray and DESS, float T2 maps,
    float clinical values), as the host ships them."""
    rng = np.random.RandomState(seed)
    xr, dess, t2, _ = sizes
    return (rng.randint(0, 256, (batch, 1, *xr), dtype=np.uint8),
            rng.randint(0, 256, (batch, 1, *dess), dtype=np.uint8),
            rng.randint(0, 1000, (batch, 1, *t2)).astype(np.float32) * 1e-4,
            rng.rand(batch, 1, 9).astype(np.float32))


def run_case(plan: dict, case: str, dp=None, tp=None,
             float64: bool = False) -> dict:
    """Train ``plan["cases"][case]``'s steps from seed-0 weights; with
    ``dp`` on this rank's rows of every global batch. ``float64``: one
    step of the model in float64, for its gradients (Adam's first moment,
    0.1 of the gradient): in float32 this model's gradients are no stable
    function of its inputs at these batches (a ReLU or max-pool switch;
    test_torch_port_train_step.py), so the two paths' sums in another
    order part them by up to 7% of a tensor's largest entry."""
    spec = plan["cases"][case]
    config = {"model": plan["model"], "training": spec["training"]}
    torch.manual_seed(0)
    rt = TrainRuntime(config, plan["modals"], plan["model"]["downscale"],
                      steps_per_epoch=1, dtype=torch.float32, device="cpu",
                      dp=dp, tp=tp)
    if float64:
        rt.model.double()
    total = spec["batch"]
    local = total if dp is None else total // dp.world
    rows = slice(0, total) if dp is None else dp.rows(local)
    ys = np.asarray(plan["targets"][:total], np.int64)
    losses, draws0 = [], None
    for step in range(1 if float64 else spec["steps"]):
        xs = raw_inputs(plan["model"]["input_size"], total, 100 + step)
        gen = torch.Generator().manual_seed(1000 + step)
        draws = rt.sample_draws(gen, local)
        if step == 0:
            draws0 = draws
        loss, _ = rt.train_step(tuple(x[rows] for x in xs), ys[rows],
                                draws=draws)
        losses.append(loss.item())
    if float64:
        names = {p: n for n, p in rt.model.named_parameters()}
        moments = {names[p]: s["exp_avg"].clone()
                   for p, s in rt.optimizer.state.items()}
        return {"moment0": moments if tp is None else unshard(moments, tp)}
    sd = (rt.model.state_dict() if tp is None
          else full_state_dict(rt.model, tp))
    heads = sorted({m.heads for m in rt.model.modules()
                    if isinstance(m, Attention)})
    return {"losses": losses, "draws": draws0, "heads": heads,
            "state": {k: v.detach().clone() for k, v in sd.items()},
            "checksum": float(sum(p.double().sum().item()
                                  for p in rt.model.parameters()))}


class Knees:
    """In-memory knees of the plan's model sizes; sample ``idx`` from
    ``default_rng([seed, idx])``, classes alternating."""

    def __init__(self, sizes, seed: int, count: int):
        self.sizes, self.seed, self.count = sizes, seed, count

    def __len__(self):
        return self.count

    def targets(self):
        return np.arange(self.count) % 2

    def get(self, idx, epoch=0):
        rng = np.random.default_rng([self.seed, idx])
        xr, dess, t2, _ = self.sizes
        clin = rng.standard_normal((1, 9), dtype=np.float32)
        return {"image__xr_pa": rng.integers(0, 256, (1, *xr), np.uint8),
                "image__sag_3d_dess": rng.integers(0, 256, (1, *dess),
                                                   np.uint8),
                "image__sag_t2_map": rng.random((1, *t2), np.float32),
                "image__clin": clin, "clin_vec": clin[0],
                "target": np.asarray([idx % 2], np.int32),
                "exam_knee_id": f"knee{self.seed}_{idx:03d}"}


def run_fit(plan: dict) -> dict:
    """One fold's epoch through ``ProgressionTrainer.fit`` over the whole
    world (each rank its contiguous shard of every epoch), then its
    checkpoint's test predictions through ``ProgressionEvaluator``."""
    spec = plan["fit"]
    sizes = plan["model"]["input_size"]
    datasets = {"train": Knees(sizes, 1, spec["train"]),
                "val": Knees(sizes, 2, spec["val"])}
    datasets["test"] = datasets["val"]
    config = dict(spec["config"], model=plan["model"],
                  path_experiment_root=plan["out"] + "/fit")
    torch.manual_seed(0)
    trainer = ProgressionTrainer(config, 0, device="cpu", datasets=datasets)
    summary = trainer.fit()
    evaluator = ProgressionEvaluator(config, device="cpu",
                                     datasets=datasets)
    raw = evaluator.eval()["raw_foldw"][0]
    masks = []
    for step in range(trainer.timing["train_steps"]):
        with torch.random.fork_rng():
            torch.manual_seed(trainer.dropout_seed(0, step))
            masks.append(torch.nn.functional.dropout(torch.ones(256), 0.5))
    return {"summary": summary, "shard": trainer.data_shard,
            "steps": trainer.timing["train_steps"],
            "val_batches": trainer.timing["val_batches"],
            "writer": trainer.is_writer, "eval": raw,
            "dropout_masks": masks}


def main(path_plan: str, rank: int) -> None:
    plan = json.loads(open(path_plan).read())
    torch.set_num_threads(int(plan.get("threads", 1)))
    world = 4
    shard = initialize_distributed(
        {"distributed": {"enable": True, "coordinator_address": plan["addr"],
                         "num_processes": world, "process_id": rank}},
        device="cpu")
    assert shard == (rank, world), shard
    assert dist.get_backend() == "gloo"
    out = {}
    pair = {0: 0, 1: 0, 2: 1, 3: 1}[rank]
    groups = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    case = "ce" if pair == 0 else "bn"
    out[f"{case}_dp"] = run_case(plan, case, dp=DataParallel(groups[pair]))
    out[f"{case}_dp64"] = run_case(plan, case, dp=DataParallel(groups[pair]),
                                   float64=True)

    odd = dist.new_group([1, 3])
    if rank in (0, 2):
        out[f"{case}_ref"] = run_case(plan, case)
        out[f"{case}_ref64"] = run_case(plan, case, float64=True)
    else:
        out["grid_dp"] = run_case(plan, "grid", dp=DataParallel(odd))
        out["grid_dp64"] = run_case(plan, "grid", dp=DataParallel(odd),
                                    float64=True)

    dp_group, tp_group = create_grid(2, 2)
    out["grid"] = run_case(plan, "grid", dp=DataParallel(dp_group),
                           tp=tp_group)
    out["grid64"] = run_case(plan, "grid", dp=DataParallel(dp_group),
                             tp=tp_group, float64=True)
    out["fit"] = run_fit(plan)
    # replicas hold equal states (their checksums are compared): one
    # copy of each is kept
    keep = {0: ("ce_dp", "ce_ref", "ce_dp64", "ce_ref64", "grid", "grid64"),
            1: ("grid_dp", "grid_dp64"),
            2: ("bn_dp", "bn_ref", "bn_dp64", "bn_ref64"), 3: ()}[rank]
    for name, res in out.items():
        if name not in keep and name != "fit":
            res.pop("state", None)
            res.pop("moment0", None)
    torch.save(out, f"{plan['out']}/rank{rank}.pt")
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
