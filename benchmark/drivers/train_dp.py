"""Entry ``train_dp``: ``ProgressionTrainer.train_epoch`` of one fold,
data-parallel over ``ranks`` processes, one a card, as ``torchrun
--nproc-per-node <ranks> -m oaprogressionmmf_torch.run.train_prog_fus ...
runtime.distributed.enable=true training.batch_size=<batch ÷ ranks>``
runs it: the traffic's ``batch`` is the global batch, split between the
cards as the original code's single-process ``nn.DataParallel`` splits
the runner's batch.

Rank 0 is the benchmark's own process on the run's device; ranks 1 to
``ranks`` − 1 are this file run as a script (``--rank k``), on ``cuda:k``
(on the CPU all ranks take the CPU, over gloo). Each rank gets torchrun's
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT`` on a free local port), makes the seed's cohort, joins the
process group through ``parallel.dcn.initialize_distributed`` and builds a
``ProgressionTrainer`` whose ``batch_size`` is the traffic's global
``batch`` ÷ ``ranks``; the first rank's weights are the benchmark's, made
from the seed, and are broadcast. (``initialize_distributed`` takes no
timeout, so the group is made first with the arguments that it would give
and a timeout, ``PG_TIMEOUT_S``, and then joined through it.)

Set-up runs epoch 0 on every rank. Its first three global steps are
recorded as ``train_epoch`` records them, each rank's dropouts taking its
rows of the seed's masks of the global batch (:class:`RankMasks`): the
global loss, step one's logits of all the ranks' rows, the first rank's
optimizer first moment after step one and its parameters after step three,
and ``replica_gap``, the largest difference of any rank's parameters
after step three from the first rank's (0 where the ranks stay replicas).
The window runs whole epochs from epoch 1 on: after each, the first rank
decides whether the window has passed and every rank follows, so that all
run the same epochs. Only the first rank opens, traces and closes the
window. ``train_knees_per_s`` is the global steps × the global batch over
the first rank's window; the memory peak is the fullest card's.

No run hangs: the first rank watches the others (:class:`Watch`). A rank
that exits before the run lets it, or with an error, or no epoch ending
for ``STALL_LIMIT_S`` (``SETUP_LIMIT_S`` until epoch 0 has ended), ends
the run: every rank is killed and the process exits with ``EXIT_LOST``
and no result. A rank whose first rank has gone exits too.

The check is ``train_epoch``'s (``train_epoch._check``) over the same
three global batches, each rank's rows of its contiguous shard of the
epoch's order in rank order (:func:`global_rows`): the reference trains
them in one float32 process from the same weights.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
from contextlib import contextmanager, nullcontext
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch

if __name__ == "__main__":      # a rank of its own: the checkout's packages
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark import harness  # noqa: E402
from benchmark.drivers import train_epoch  # noqa: E402
from benchmark.reference import nets  # noqa: E402
from benchmark.traffic.knees import Cohort  # noqa: E402

RECORDED_STEPS = train_epoch.RECORDED_STEPS
# a collective that waits longer than this fails on every rank
PG_TIMEOUT_S = 300
# the longest a rank's set-up to the end of epoch 0 may take (the first
# run in a checkout builds the kernels), and an epoch after it
SETUP_LIMIT_S = 900
STALL_LIMIT_S = 120
# how often the watch looks, and how long it leaves the first rank's
# main thread to fail by itself before the process exits
POLL_S = 0.5
GRACE_S = 10
EXIT_LOST = 4


def rank_config(cell: dict, seed: int, root: str, world: int) -> dict:
    """``train_epoch``'s trainer config for one rank of ``world``: the
    global batch split between the ranks, the process group on."""
    conf = train_epoch.trainer_config(cell, seed, root)
    batch = int(cell["traffic"]["batch"])
    if batch % world:
        raise ValueError(f"batch {batch} does not split over {world} ranks")
    conf["training"]["batch_size"] = batch // world
    conf["runtime"]["distributed"] = {"enable": True}
    return conf


class RankMasks(nets.Masks):
    """One rank's rows of the global batch's dropout masks
    (:class:`nets.Masks`): a dropout whose input here has n rows takes rows
    [rank·n, (rank + 1)·n) of the mask of the global batch's world·n rows,
    as every input of a dropout leads with the batch (knees, or knees ×
    slices in knee order)."""

    def __init__(self, seed: int, step: int, rank: int, world: int):
        super().__init__(seed, step)
        self.rank, self.world = rank, world

    def keep(self, x, p: float):
        n = x.shape[0]
        whole = x.new_empty(()).expand(self.world * n, *x.shape[1:])
        return super().keep(whole, p)[self.rank * n:(self.rank + 1) * n]


def global_rows(order, world: int, batch: int, step: int) -> np.ndarray:
    """The knees of global step ``step`` of a global ``batch``: each
    rank's rows [b·step, b·(step + 1)) of its contiguous shard of
    ``order`` (b = batch ÷ world), in rank order."""
    b, shard = batch // world, len(order) // world
    return np.concatenate([order[k * shard + step * b:
                                 k * shard + (step + 1) * b]
                           for k in range(world)])


def rows(cell: dict, order, step: int) -> np.ndarray:
    """The cell's global step ``step`` (:func:`global_rows`)."""
    tr = cell["traffic"]
    return global_rows(order, int(tr["ranks"]), int(tr["batch"]), step)


def control_readings(cell: dict, cohort: Cohort, seed: int, device,
                     prec) -> dict:
    """The check's numbers (``train_epoch.gaps``) with the reference in
    ``prec`` in the program's place (``control.py``), over the global
    steps' knees."""
    return train_epoch.control_readings(cell, cohort, seed, device, prec,
                                        rows)


# ---------------------------------------------------------------- a rank

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def torchrun_env(rank: int, world: int, address: str) -> dict:
    host, port = address.rsplit(":", 1)
    return {"RANK": str(rank), "WORLD_SIZE": str(world),
            "LOCAL_RANK": str(rank), "MASTER_ADDR": host,
            "MASTER_PORT": port}


@contextmanager
def environment(values: dict):
    """``os.environ`` with ``values`` set, restored after."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def join(runtime_cfg: dict, device) -> None:
    """Make the process group as ``initialize_distributed`` would (NCCL
    bound to the card, gloo on the CPU), with a timeout, from torchrun's
    environment, and join it through ``initialize_distributed``."""
    import torch.distributed as dist

    from oaprogressionmmf_torch.parallel.dcn import initialize_distributed
    env = os.environ
    kwargs = {"device_id": device} if device.type == "cuda" else {}
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo",
        init_method=f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
        world_size=int(env["WORLD_SIZE"]), rank=int(env["RANK"]),
        timeout=timedelta(seconds=PG_TIMEOUT_S), **kwargs)
    initialize_distributed(runtime_cfg, device)


@torch.no_grad()
def replica_gap(params) -> float:
    """The largest difference of any rank's ``params`` from the first
    rank's."""
    import torch.distributed as dist
    worst = torch.zeros((), device=params[0].device)
    for p in params:
        first = p.detach().clone()
        dist.broadcast(first, src=0)
        worst = torch.maximum(worst, (p.detach() - first).abs().max()
                              .float())
    dist.all_reduce(worst, op=dist.ReduceOp.MAX)
    return float(worst)


def _record(rt, steps: list, seed: int):
    """Wrap ``rt.train_step`` on every rank so that its first calls take
    the rank's rows of the seed's masks and are recorded (on the first
    rank: the readings that the check compares); returns the original."""
    import torch.distributed as dist
    original = rt.train_step
    dp = rt.dp

    def recorded(*args, **kwargs):
        n = len(steps)
        if n >= RECORDED_STEPS:
            return original(*args, **kwargs)
        with train_epoch.given_masks(RankMasks(seed, n, dp.rank, dp.world)):
            loss, logits = original(*args, **kwargs)
        rec = {"loss": float(loss)}
        if n == 0:
            parts = [torch.empty_like(logits) for _ in range(dp.world)]
            dist.all_gather(parts, logits.contiguous())
            if dp.rank == 0:
                rec["logits"] = train_epoch._host(torch.cat(parts))
                rec["exp_avg"] = train_epoch.first_moment(rt)
        if n == RECORDED_STEPS - 1:
            rec["replica_gap"] = replica_gap(rt.params)
            if dp.rank == 0:
                rec["params"] = train_epoch.parameters(rt)
        steps.append(rec)
        return loss, logits

    rt.train_step = recorded
    return original


def train_rank(cell: dict, seed: int, device, cohort: Cohort,
               r: harness.Run | None = None, watch=None) -> list:
    """One rank's part: join, set-up, epoch 0 recorded, the window's
    epochs and the memory peak. The first rank passes its run ``r`` (its
    window, values and counters) and its ``watch``. Returns the
    recording."""
    import torch.distributed as dist

    from oaprogressionmmf_torch.train.trainer import ProgressionTrainer
    world = int(os.environ["WORLD_SIZE"])
    with tempfile.TemporaryDirectory(prefix="bench-train-") as root:
        conf = rank_config(cell, seed, root, world)
        join(conf["runtime"], device)
        trainer = ProgressionTrainer(
            conf, 0, device=device,
            datasets={"train": cohort, "val": cohort, "test": cohort})
        rt, dp = trainer.runtime, trainer.dp
        if dp is None or dp.world != world:
            raise RuntimeError(f"the trainer is not data-parallel over "
                               f"{world} ranks")
        if dp.rank == 0:
            rt.model.load_state_dict(
                nets.make_weights(cell["model"], seed, device), strict=True)
        dp.replicate(rt.model)
        harness.free(device)
        steps: list = []
        original = _record(rt, steps, seed)
        trainer.train_epoch(0)
        rt.train_step = original
        if len(steps) < RECORDED_STEPS:
            raise RuntimeError("epoch 0 ran fewer steps than are recorded")

        flag = torch.zeros(1, dtype=torch.int64, device=device)

        def first_rank_says(stop: bool) -> bool:
            """The first rank's ``stop`` on every rank; a barrier too."""
            flag.fill_(int(stop and dp.rank == 0))
            dist.all_reduce(flag, op=dist.ReduceOp.MAX)
            return bool(flag.item())

        if watch is not None:
            watch.beat()
        first_rank_says(False)
        t = trainer.timing
        steps0, wait0 = t["train_steps"], t["loader_wait"]
        epoch, bad = 1, 0
        with (r.window.run() if r is not None else nullcontext()) as w:
            while True:
                loss = trainer.train_epoch(epoch)["loss_prog"]
                bad += not math.isfinite(loss)
                epoch += 1
                if watch is not None:
                    watch.beat()
                if first_rank_says(w is not None and w.done()):
                    break
        peak = torch.tensor([torch.cuda.max_memory_allocated(device)
                             if device.type == "cuda" else 0],
                            dtype=torch.int64, device=device)
        if r is not None:
            r.close_window()
            if watch is not None:   # the trace's reading was no stall
                watch.beat()
            n_steps = t["train_steps"] - steps0
            knees = n_steps * int(cell["traffic"]["batch"])
            r.attempted = n_steps
            r.failed = bad
            r.values["train_knees_per_s"] = knees / w.elapsed
            r.counters.update(steps=n_steps, epochs=epoch - 1, knees=knees,
                              loader_wait_s=t["loader_wait"] - wait0)
        if watch is not None:
            watch.may_exit = True
        dist.all_reduce(peak, op=dist.ReduceOp.MAX)
        if r is not None and device.type == "cuda":
            r.device_info["memory_peak_bytes"] = int(peak)
        del trainer, rt, dp, original
    dist.destroy_process_group()
    harness.free(device)
    return steps


# ---------------------------------------------------------------- the ranks

class Watch:
    """The first rank's watch over the other ranks' processes ``procs``
    (rank k is ``procs[k - 1]``, appended as they start): one that exits
    with an error, or before ``may_exit``, or no :meth:`beat` for
    ``STALL_LIMIT_S`` (``SETUP_LIMIT_S`` before the first), ends the run.
    The ranks are killed, and unless :meth:`close` comes within
    ``GRACE_S`` (the main thread failed by itself) the process exits with
    ``EXIT_LOST``."""

    def __init__(self, procs: list):
        self.procs = procs
        self.may_exit = False
        self._limit = SETUP_LIMIT_S
        self._beat = time.monotonic()
        self._closed = threading.Event()
        self._thread = threading.Thread(target=self._watch, daemon=True)
        self._thread.start()

    def beat(self) -> None:
        """An epoch ended on every rank."""
        self._beat = time.monotonic()
        self._limit = STALL_LIMIT_S

    def _fault(self) -> str | None:
        for k, p in enumerate(self.procs, 1):
            code = p.poll()
            if code is not None and (code != 0 or not self.may_exit):
                return f"rank {k} exited with {code}"
        if time.monotonic() - self._beat > self._limit:
            return f"no epoch ended on every rank in {self._limit} s"
        return None

    def _watch(self) -> None:
        while not self._closed.wait(POLL_S):
            lost = self._fault()
            if lost is None:
                continue
            print(f"train_dp: {lost}; ending the run", file=sys.stderr,
                  flush=True)
            self.kill()
            if not self._closed.wait(GRACE_S):
                os._exit(EXIT_LOST)
            return

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()

    def wait(self) -> None:
        """Every other rank's exit, within ``STALL_LIMIT_S``."""
        deadline = time.monotonic() + STALL_LIMIT_S
        for k, p in enumerate(self.procs, 1):
            try:
                code = p.wait(max(deadline - time.monotonic(), 0.0))
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"rank {k} did not exit") from None
            if code != 0:
                raise RuntimeError(f"rank {k} exited with {code}")

    def close(self) -> None:
        self._closed.set()
        self._thread.join()
        self.kill()
        for p in self.procs:
            p.wait()


def spawn(cell: dict, seed: int, rank: int, world: int, address: str,
          device) -> subprocess.Popen:
    """Rank ``rank`` as a process of its own: this file with torchrun's
    environment, the cell on its standard input, its output on the
    first rank's standard error."""
    env = dict(os.environ, **torchrun_env(rank, world, address))
    p = subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--rank", str(rank),
         "--seed", str(seed), "--device", device.type],
        stdin=subprocess.PIPE, stdout=2, env=env,
        text=True)
    p.stdin.write(json.dumps(cell))
    p.stdin.close()
    return p


def run(r: harness.Run) -> None:
    cell, dev, seed = r.cell, r.device, r.seed
    world = int(cell["traffic"]["ranks"])
    if dev.type == "cuda" and r.chips != world:
        raise ValueError(f"{world} ranks on {r.chips} cards")
    address = f"127.0.0.1:{free_port()}"
    watch = Watch([])
    try:
        for k in range(1, world):
            watch.procs.append(spawn(cell, seed, k, world, address, dev))
        with environment(torchrun_env(0, world, address)):
            cohort = Cohort(cell["model"], cell["config_file"]["modals"],
                            cell["traffic"], seed, dev)
            steps = train_rank(cell, seed, dev, cohort, r, watch)
        watch.wait()
    finally:
        watch.close()
    r.readings["replica_gap"] = steps[-1]["replica_gap"]
    train_epoch._check(r, steps, cohort, rows)


def _exit_with(parent: int) -> None:
    """End this rank when the first rank's process has gone."""
    while os.getppid() == parent:
        time.sleep(POLL_S)
    os._exit(EXIT_LOST)


def main(argv=None) -> int:
    """A rank after the first: ``--rank``, ``--seed``, ``--device`` (cpu
    or cuda), the cell as JSON on standard input."""
    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--device", choices=("cpu", "cuda"), required=True)
    args = p.parse_args(argv)
    threading.Thread(target=_exit_with, args=(os.getppid(),),
                     daemon=True).start()
    cell = json.loads(sys.stdin.read())
    device = (torch.device("cuda", args.rank) if args.device == "cuda"
              else torch.device("cpu"))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    cohort = Cohort(cell["model"], cell["config_file"]["modals"],
                    cell["traffic"], args.seed, device)
    train_rank(cell, args.seed, device, cohort)
    return 0


if __name__ == "__main__":
    sys.exit(main())
