"""Evaluation-time runtime of the port.

Port of the eval parts of ``oaprogressionmmf_tpu/train/trainer.py``:
:func:`make_preprocess_fn` (eval branch) and :func:`eval_step`
(preprocessing → forward → softmax). The training step is a later slice.
"""

from __future__ import annotations

import torch

from ..ops.preproc import MODALITY_STATS
from ..ops.resize import interpolate


def make_preprocess_fn(modals, downscale, train: bool):
    """Per-batch device preprocessing for all modalities.

    Eval path: the per-sample min and max are taken over all non-batch
    axes of the raw values, the downscale runs on the raw values, and the
    unit-range and normalization affine maps are applied to the small
    tensor — equal to unit-range → normalize → downscale, since the
    downscale is linear. ``clin`` is only cast to float32."""
    if train:
        raise NotImplementedError(
            "training preprocessing (augmentation) is not ported yet "
            "(ROADMAP item 5)")

    def preprocess(xs: tuple) -> tuple:
        out = []
        for i, (m, x) in enumerate(zip(modals, xs)):
            if m == "clin":
                out.append(x.float())
                continue
            xf = x.float()
            red_axes = tuple(range(1, xf.dim()))
            lo = xf.amin(dim=red_axes, keepdim=True)
            hi = xf.amax(dim=red_axes, keepdim=True)
            if downscale:
                xf = interpolate(xf, tuple(downscale[i]))
            mean, std = MODALITY_STATS[m]
            out.append(((xf - lo) / (hi - lo) - mean) / std)
        return tuple(out)

    return preprocess


@torch.inference_mode()
def eval_step(model, preprocess, xs):
    """Preprocess → forward → (float32 logits, probabilities).

    ``model`` is in eval mode; ``xs`` are the raw per-modality tensors on
    its device. The loss on the logits comes with the ported losses
    (ROADMAP item 5)."""
    out = model(*preprocess(xs))
    logits = (out["main"] if isinstance(out, dict) else out).float()
    return logits, torch.softmax(logits, dim=-1)
