"""CLI: fusion-model training — ``python -m oaprogressionmmf_torch.run.train_prog_fus``.

Port of ``oaprogressionmmf_tpu/run/train_prog_fus.py`` (the reference's
koafusion/run/train_prog_fus.py:335-362): overrides in the Hydra grammar
(``model=xr1_cnn data.target=prog_kl_48 ...``), one
``ProgressionTrainer.fit`` per requested fold with its best checkpoint,
the log also under ``path_logs``. Data-parallel over N devices (one
process each; the batch size is per process)::

    torchrun --nproc-per-node N -m oaprogressionmmf_torch.run.train_prog_fus \
        runtime.distributed.enable=true ...
"""

from __future__ import annotations

import logging
import sys

from . import app_config, as_tree, start_processes

logger = logging.getLogger("train_prog_fus")


def run(config, device=None, datasets=None) -> dict:
    """Train the folds of ``training.folds`` on ``device``, the GPU unless
    ``device="cpu"``; ``datasets`` as ``ProgressionTrainer`` takes it
    (None: the fold's split of the OAI tree). Returns each fold's
    summary."""
    from ..train.trainer import ProgressionTrainer

    config = as_tree(config)
    device, (rank, world) = start_processes(config, device)
    logger.info(f"Training on data shard {rank} of {world}")
    folds = config["training"]["folds"]
    if int(folds["idx"]) == -1:
        fold_idcs = list(range(int(folds["num"])))
    else:
        fold_idcs = [int(folds["idx"])]
    ignore = folds.get("ignore")
    if ignore:
        fold_idcs = [i for i in fold_idcs if i not in ignore]

    summaries = {}
    for fold_idx in fold_idcs:
        logger.info(f"Training fold {fold_idx}")
        trainer = ProgressionTrainer(config, fold_idx, device=device,
                                     datasets=datasets)
        summaries[fold_idx] = trainer.fit()
        logger.info(f"Fold {fold_idx} summary: {summaries[fold_idx]}")
    return summaries


def main(argv=None, device=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    with app_config(argv, "train_prog_fus_{training}.log") as config:
        return run(config, device=device)


if __name__ == "__main__":
    main()
