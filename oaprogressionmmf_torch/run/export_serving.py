"""CLI: serving bundles from trained checkpoints —
``python -m oaprogressionmmf_torch.run.export_serving``.

Port of ``oaprogressionmmf_tpu/run/export_serving.py``: per requested
fold, restore its last checkpoint, calibrate the activation scales on
``serving.calib_batches`` validation batches, and write a bundle in the
JAX package's layout under ``{path_experiment_root}/serving/fold_{idx}``
(or ``serving.out``). Serve it with either package::

    from oaprogressionmmf_torch.serving import load_serving_bundle
    predictor = load_serving_bundle(path)
    probs = predictor(xs)

The ``serving`` group of ``prog_fus.yaml``: ``quant`` ∈ {none, int8,
int8-all}, ``calib_batches``, ``out``.
"""

from __future__ import annotations

import logging
import sys
from pathlib import Path

from ..device import resolve_device
from . import app_config, as_tree, check_runtime

logger = logging.getLogger("export_serving")


def run(config, device=None, datasets=None) -> list:
    """Export a bundle for every requested fold (``testing.folds``) on
    ``device``, the GPU unless ``device="cpu"``; returns the bundle
    paths."""
    from ..serving import export_serving_bundle
    from ..train.evaluator import ProgressionEvaluator
    from ..train.trainer import _modality_xs

    config = as_tree(config)
    check_runtime(config)
    device = resolve_device(device)
    serving_cfg = config.get("serving") or {}
    quant = str(serving_cfg.get("quant") or "int8-all")
    n_calib = int(serving_cfg.get("calib_batches") or 2)
    out_root = serving_cfg.get("out") or str(
        Path(config["path_experiment_root"]) / "serving")

    ev = ProgressionEvaluator(config, device=device, datasets=datasets)
    # calibration batches come from the fold's validation split (the test
    # set stays untouched; amax depends on the data, not the labels)
    batches = []
    for batch in ev.trainer.loaders["val"].epoch(0):
        batches.append(_modality_xs(batch, ev.modals))
        if len(batches) >= n_calib:
            break

    paths = []
    for fold_idx in ev.fold_idcs:
        state_dict = ev._restore_fold(fold_idx)
        out = Path(out_root) / f"fold_{fold_idx}"
        meta = export_serving_bundle(
            out, ev.model_cfg, ev.modals, ev.downscale, state_dict,
            calib_batches=batches, quant=quant, dtype=ev.dtype,
            source=f"{config['path_experiment_root']} fold_{fold_idx}",
            device=ev.device)
        logger.info(f"fold {fold_idx}: bundle at {out} "
                    f"(quant={meta['quant']}, "
                    f"calib_batches={meta['calib_batches']})")
        paths.append(out)
    return paths


def main(argv=None, device=None) -> list:
    argv = sys.argv[1:] if argv is None else argv
    with app_config(argv, "export_serving_{testing}.log") as config:
        return run(config, device=device)


if __name__ == "__main__":
    main()
