"""Training and evaluation runtime of the port.

Port of ``oaprogressionmmf_tpu/train/trainer.py``:
:func:`make_preprocess_fn` (train and eval branches), :func:`eval_step`
(preprocessing → forward → softmax) and :class:`TrainRuntime`, the
counterpart of its ``_Runtime.train_step``: augmentation → downscale →
forward in train mode → loss → backward → optimizer update, with the
BatchNorm running statistics updated by the forward.
"""

from __future__ import annotations

import contextlib

import torch

from ..device import resolve_device
from ..models import dict_models
from ..ops.losses import dict_losses
from ..ops.preproc import (MODALITY_STATS, make_augment_fn,
                           sample_augment_draws)
from ..ops.resize import interpolate
from ..ops.schedules import make_lr_schedule
from .state import dict_optimizers, set_lr


def make_preprocess_fn(modals, downscale, train: bool, fast: bool = False):
    """Per-batch device preprocessing for all modalities.

    ``fast`` (the JAX package's bf16 TPU downscale for int8 serving) is
    accepted and ignored: the port has one downscale.

    Eval path, ``preprocess(xs)``: the per-sample min and max are taken
    over all non-batch axes of the raw values, the downscale runs on the
    raw values, and the unit-range and normalization affine maps are
    applied to the small tensor — equal to unit-range → normalize →
    downscale, since the downscale is linear. ``clin`` is only cast to
    float32.

    Train path, ``preprocess(xs, draws)`` with one
    :class:`~..ops.preproc.AugmentDraws` per modality (None for ``clin``):
    the augmentation at full resolution, then the downscale — the
    reference's order, the JAX package's ``augment_full_res=true``."""
    if not train:
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

    augment = [make_augment_fn(m) for m in modals]

    def preprocess_train(xs: tuple, draws) -> tuple:
        out = []
        for i, (m, x) in enumerate(zip(modals, xs)):
            if m == "clin":
                out.append(x.float())
                continue
            x = augment[i](x, draws[i])
            if downscale:
                x = interpolate(x, tuple(downscale[i]))
            out.append(x)
        return tuple(out)

    return preprocess_train


@torch.inference_mode()
def eval_step(model, preprocess, xs):
    """Preprocess → forward → (float32 logits, probabilities).

    ``model`` is in eval mode; ``xs`` are the raw per-modality tensors on
    its device."""
    out = model(*preprocess(xs))
    logits = (out["main"] if isinstance(out, dict) else out).float()
    return logits, torch.softmax(logits, dim=-1)


class TrainRuntime:
    """Model, loss, optimizer and LR schedule of one training config, and
    its :meth:`train_step`.

    ``config`` holds the ``model`` and ``training`` subtrees of the JAX
    package's config (``loss``, ``optim``, ``sched``, ``augment_full_res``).
    ``state_dict`` (the reference's names, float32) is loaded with
    ``strict=True``; without one the modules keep torch's initialization.
    Parameters stay float32; ``dtype=torch.bfloat16`` runs the forward and
    backward under autocast in bf16. The runtime lives on ``device``, the
    GPU unless ``device="cpu"``.

    ``training.steps_per_dispatch`` (a TPU dispatch trick) and
    ``model.fe.remat`` are accepted and ignored. Not ported yet: the
    metric-driven ReduceLROnPlateau, which the training loop drives
    (ROADMAP item 6), and ``training.augment_full_res=false``, the JAX
    package's post-downscale bf16 augmentation.

    Random numbers: augmentation draws come from the generator passed to
    :meth:`train_step`; dropout draws from the device's default generator,
    which the caller seeds (``torch.manual_seed``)."""

    def __init__(self, config: dict, modals, downscale, steps_per_epoch: int,
                 state_dict: dict | None = None, dtype=torch.bfloat16,
                 device=None):
        self.device = resolve_device(device)
        model_cfg, train_cfg = config["model"], config["training"]
        if not train_cfg.get("augment_full_res", True):
            raise NotImplementedError(
                "training.augment_full_res=false (augmentation after the "
                "downscale, in bf16) is not ported")
        with torch.device(self.device):
            model = dict_models[model_cfg["name"]](model_cfg)
        if state_dict is not None:
            # copied in: training never writes into the caller's tensors
            model.load_state_dict(state_dict, strict=True)
        memory_format = (torch.channels_last if self.device.type == "cuda"
                         else torch.preserve_format)
        self.model = model.to(memory_format=memory_format).train()
        self.params = [p for p in self.model.parameters() if p.requires_grad]
        self.dtype = dtype
        self.modals = list(modals)

        loss_cfg = train_cfg["loss"]
        self.loss_fn = dict_losses[loss_cfg["name"]](
            num_classes=int(model_cfg["output_channels"]),
            **dict(loss_cfg.get("params") or {}))
        optim_cfg, sched_cfg = train_cfg["optim"], train_cfg["sched"]
        kwargs = {}
        if optim_cfg.get("weight_decay"):
            kwargs["weight_decay"] = float(optim_cfg["weight_decay"])
        self.optimizer = dict_optimizers[optim_cfg["name"]](self.params,
                                                            **kwargs)
        self.lr_schedule = make_lr_schedule(
            sched_cfg["name"], dict(sched_cfg.get("params") or {}),
            lr_init=float(optim_cfg["lr_init"]),
            steps_per_epoch=steps_per_epoch)
        self.preprocess = make_preprocess_fn(self.modals, downscale,
                                             train=True)
        self.step = 0

    def to_device(self, xs) -> tuple:
        return tuple(torch.as_tensor(x).to(self.device, non_blocking=True)
                     for x in xs)

    def sample_draws(self, generator: torch.Generator, batch: int) -> list:
        """One set of augmentation draws per modality, in modality order."""
        return [None if m == "clin" else sample_augment_draws(generator,
                                                              batch)
                for m in self.modals]

    def train_step(self, xs, ys, generator: torch.Generator | None = None,
                   draws=None):
        """One optimizer step on the raw batch ``xs`` (one array per
        modality, host or device) with integer targets ``ys``.

        The augmentation draws come from ``generator``, or are given as
        ``draws`` (one :class:`~..ops.preproc.AugmentDraws` per modality).
        Returns the loss and the float32 logits, both detached."""
        xs = self.to_device(xs)
        ys = torch.as_tensor(ys).to(self.device, non_blocking=True)
        if draws is None:
            draws = self.sample_draws(generator, xs[0].shape[0])
        with torch.no_grad():
            xs = self.preprocess(xs, draws)
        autocast = (torch.autocast(self.device.type, dtype=self.dtype)
                    if self.dtype != torch.float32
                    else contextlib.nullcontext())
        with autocast:
            out = self.model(*xs)
        logits = (out["main"] if isinstance(out, dict) else out).float()
        loss = self.loss_fn(logits, ys)
        loss.backward()
        # parameters the loss does not reach (the per-MRI FeaTs' heads)
        # still take the update, as JAX's zero grads and weight decay do
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        set_lr(self.optimizer, self.lr_schedule(self.step))
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1
        return loss.detach(), logits.detach()
