"""Serving: raw per-modality batches → class probabilities.

Port of the predict path of ``oaprogressionmmf_tpu/serving.py``: the same
device work as its ``load_serving_bundle(...).predict`` — eval
preprocessing, the forward, a softmax. Loading msgpack bundles and the int8
modes come with the quantization slice (ROADMAP item 9).
"""

from __future__ import annotations

import torch

from .device import resolve_device
from .models import dict_models
from .train.trainer import eval_step, make_preprocess_fn


class Predictor:
    """Callable from the raw ``xs`` tuple (numpy arrays or tensors, one per
    modality) to (B, classes) float32 probabilities on ``device``."""

    def __init__(self, model, preprocess, device: torch.device):
        self.model = model
        self.preprocess = preprocess
        self.device = device

    def to_device(self, xs) -> tuple:
        return tuple(torch.as_tensor(x).to(self.device, non_blocking=True)
                     for x in xs)

    def __call__(self, xs) -> torch.Tensor:
        return eval_step(self.model, self.preprocess, self.to_device(xs))[1]

    def logits(self, xs) -> torch.Tensor:
        """The float32 logits behind :meth:`__call__`'s probabilities."""
        return eval_step(self.model, self.preprocess, self.to_device(xs))[0]


def make_predictor(model_cfg: dict, state_dict: dict, modals, downscale,
                   device=None, dtype=torch.bfloat16) -> Predictor:
    """Build the model named by ``model_cfg``, load ``state_dict`` (the
    reference's names, float32) with ``strict=True``, and return a
    :class:`Predictor` whose model runs in ``dtype`` on ``device`` (the GPU
    unless ``device="cpu"``). Preprocessing runs in float32."""
    device = resolve_device(device)
    with torch.device("meta"):
        model = dict_models[model_cfg["name"]](model_cfg)
    model.load_state_dict(state_dict, strict=True, assign=True)
    memory_format = (torch.channels_last if device.type == "cuda"
                     else torch.preserve_format)
    model = model.to(device=device, dtype=dtype,
                     memory_format=memory_format).eval()
    preprocess = make_preprocess_fn(list(modals), downscale, train=False)
    return Predictor(model, preprocess, device)
