"""Classification losses: focal, cross-entropy, BCE with logits.

Port of ``oaprogressionmmf_tpu/ops/losses.py``: CE over logits with
optional class weights (torch's weighted mean, sum(w·nll) / sum(w)); focal
loss −(1 − p_t)^γ · log p_t with the class weight multiplying log p_t, as
the reference does; mean or sum reduction.

Each loss function carries ``denominator(input, target)``: the
denominator of its mean (the batch size, or sum(w) for the weighted CE),
or None for a sum, so that data parallelism takes the mean over the
global batch (``parallel/mesh.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _log_softmax_pick(logits, targets):
    return torch.log_softmax(logits, dim=-1).gather(
        -1, targets.long()[:, None])[:, 0]


def _weights(class_weight, like):
    if class_weight is None:
        return None
    return torch.as_tensor(class_weight, dtype=torch.float32,
                           device=like.device)


def _count_or_none(reduction: str):
    """The denominator of a plain mean over the batch; None for a sum."""
    def denominator(input, target):
        if reduction != "mean":
            return None
        return torch.tensor(float(target.shape[0]), device=input.device)

    return denominator


def make_cross_entropy(num_classes: int, class_weight=None,
                       reduction: str = "mean", **_unused):
    """(B, C) logits, (B,) int targets → CE."""
    def loss_fn(input, target):
        nll = -_log_softmax_pick(input, target)
        cw = _weights(class_weight, input)
        if cw is not None:
            w = cw[target.long()]
            if reduction == "mean":
                return (w * nll).sum() / w.sum()
            return (w * nll).sum()
        return nll.mean() if reduction == "mean" else nll.sum()

    def denominator(input, target):
        if reduction != "mean":
            return None
        cw = _weights(class_weight, input)
        if cw is not None:
            return cw[target.long()].sum()
        return _count_or_none(reduction)(input, target)

    loss_fn.denominator = denominator
    return loss_fn


def make_focal(num_classes: int = 2, gamma: float = 2.0, class_weight=None,
               reduction: str = "mean", **_unused):
    """(B, C) logits, (B,) int targets → −(1 − p_t)^γ · log p_t."""
    if reduction not in ("mean", "sum"):
        raise ValueError("Unknown `reduction` value")

    def loss_fn(input, target):
        logpt = _log_softmax_pick(input, target)
        cw = _weights(class_weight, input)
        if cw is not None:
            logpt = logpt * cw[target.long()]
        loss = -((1.0 - torch.exp(logpt)) ** gamma) * logpt
        return loss.mean() if reduction == "mean" else loss.sum()

    loss_fn.denominator = _count_or_none(reduction)
    return loss_fn


def make_bce_with_logits(**_unused):
    """Logits and targets of one shape → mean sigmoid BCE."""
    def loss_fn(input, target):
        return F.binary_cross_entropy_with_logits(input, target.float())

    loss_fn.denominator = lambda input, target: torch.tensor(
        float(input.numel()), device=input.device)
    return loss_fn


def _loss_factory(kind):
    def build(num_classes: int = 2, **params):
        for key in ("batch_avg", "batch_weight", "class_avg"):
            params.pop(key, None)
        return kind(num_classes=num_classes, **params)

    return build


dict_losses = {
    "bce_wlogits_loss": _loss_factory(
        lambda num_classes=2, **p: make_bce_with_logits(**p)),
    "CrossEntropyLoss": _loss_factory(make_cross_entropy),
    "FocalLoss": _loss_factory(make_focal),
}
