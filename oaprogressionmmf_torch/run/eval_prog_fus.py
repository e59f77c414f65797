"""CLI: fusion-model evaluation and explanation —
``python -m oaprogressionmmf_torch.run.eval_prog_fus``.

Port of ``oaprogressionmmf_tpu/run/eval_prog_fus.py`` (the reference's
koafusion/run/eval_prog_fus.py:515-531): ``testing.regime`` ``eval``
(fold-wise predictions, the ensemble and the metrics pickles) or
``explain`` (modality-ablation utilization), ``testing.profile`` time,
compute or trace, ``testing.quant`` none or int8.
"""

from __future__ import annotations

import logging
import sys

from . import app_config, as_tree, start_processes

logger = logging.getLogger("eval_prog_fus")


def run(config, device=None, datasets=None) -> dict:
    """Evaluate (or explain) the requested folds of ``config`` on
    ``device``, the GPU unless ``device="cpu"``; ``datasets`` as
    ``ProgressionTrainer`` takes it (None: the OAI tree). Returns the
    evaluator's results."""
    from ..train.evaluator import ProgressionEvaluator

    config = as_tree(config)
    device, (rank, world) = start_processes(config, device)
    logger.info(f"Evaluating data shard {rank} of {world}")
    evaluator = ProgressionEvaluator(config, device=device, datasets=datasets)
    regime = config["testing"]["regime"]
    if regime == "eval":
        return evaluator.eval()
    if regime == "explain":
        return evaluator.explain()
    raise ValueError(f"Unknown regime: {regime}")


def main(argv=None, device=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    with app_config(argv, "eval_prog_fus_{testing}.log") as config:
        return run(config, device=device)


if __name__ == "__main__":
    main()
