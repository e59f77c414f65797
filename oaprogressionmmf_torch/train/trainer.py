"""Training and evaluation runtime of the port.

Port of ``oaprogressionmmf_tpu/train/trainer.py``:
:func:`make_preprocess_fn` (train and eval branches), :func:`eval_step`
(preprocessing → forward → softmax), :class:`TrainRuntime`, the
counterpart of its ``_Runtime.train_step`` (augmentation → downscale →
forward in train mode → loss → backward → optimizer update, with the
BatchNorm running statistics updated by the forward),
:class:`MetricsLogger` and :class:`ProgressionTrainer`, which trains one
fold: loader threads → train steps → validation epoch → metrics → best
checkpoint, with ReduceLROnPlateau, the NaN guard and exact resume from
checkpoints in the JAX package's layout. Under a process group (one
process per device, ``parallel/``) both run data-parallel: each process
trains on its shard of the global batch with the gradients averaged and
BatchNorm over the global batch, and rank 0 writes the logs and
checkpoints.
"""

from __future__ import annotations

import contextlib
import json
import logging
import time
from pathlib import Path

import numpy as np
import torch

from .. import tracing
from ..data.pipeline import (SequentialSampler, WeightedSampler,
                             make_batch_loader)
from ..device import resolve_device
from ..models import MODEL_ARITY, dict_models
from ..ops.losses import dict_losses
from ..ops.preproc import (MODALITY_STATS, AugmentDraws, make_augment_fn,
                           sample_augment_draws)
from ..ops.resize import interpolate
from ..ops.schedules import ReduceLROnPlateau, make_lr_schedule
from ..parallel.mesh import create_group
from ..parallel.tp import shard_feat_tp
from ..utils.checkpoint import (ckpt_bytes, load_ckpt, load_runtime_payload,
                                make_checkpoint_handler, runtime_payload)
from ..utils.metrics import calc_metrics_v2
from ..utils.pretrained import apply_pretrained_fes
from ..utils.seeding import PRNGChain
from .state import dict_optimizers, moment_keys, set_lr

logger = logging.getLogger("train")

# runtime.compute_dtype → the autocast dtype
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def make_preprocess_fn(modals, downscale, train: bool, fast: bool = False,
                       augment_full_res: bool = True):
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
    with ``augment_full_res`` (the default, the reference's order) the
    augmentation at full resolution in float32, then the downscale;
    without it (the JAX package's ``augment_full_res=false``) the
    downscale first, in float32 (``F.interpolate``) rounded to bf16, then
    the augmentation in bf16 on 4-8× fewer voxels with the same draws. The
    two are not equal: gamma is not linear, so it does not commute with
    the downscale."""
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

    dtype = torch.float32 if augment_full_res else torch.bfloat16
    augment = [make_augment_fn(m, dtype=dtype) for m in modals]

    def preprocess_train(xs: tuple, draws) -> tuple:
        out = []
        for i, (m, x) in enumerate(zip(modals, xs)):
            if m == "clin":
                out.append(x.float())
                continue
            if augment_full_res:
                x = augment[i](x, draws[i])
                if downscale:
                    x = interpolate(x, tuple(downscale[i]))
            else:
                x = x.float()
                if downscale:
                    x = interpolate(x, tuple(downscale[i]))
                x = augment[i](x.to(dtype), draws[i])
            out.append(x)
        return tuple(out)

    return preprocess_train


@torch.inference_mode()
def eval_step(model, preprocess, xs):
    """Preprocess → forward → (float32 logits, probabilities).

    ``model`` is in eval mode; ``xs`` are the raw per-modality tensors on
    its device. Spans: ``serve.preprocess``, ``serve.forward`` and
    ``serve.head`` (the float cast and the softmax). It syncs with nothing
    on the host, so :class:`~..serving.Predictor` captures it as one CUDA
    graph."""
    with tracing.span("serve.preprocess"):
        xs = preprocess(xs)
    with tracing.span("serve.forward"):
        out = model(*xs)
    with tracing.span("serve.head"):
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
    ``model.fe.remat`` are accepted and ignored. The metric-driven
    ReduceLROnPlateau has no step schedule: the step takes ``self.lr``,
    which :class:`ProgressionTrainer` sets after each validation epoch.
    ``training.augment_full_res`` selects the order of augmentation and
    downscale (:func:`make_preprocess_fn`).

    Data parallelism: ``dp`` (a :class:`~..parallel.mesh.DataParallel`)
    makes the step that of the global batch over its group: the model's
    BatchNorms take the global batch's statistics, the first rank's
    weights are broadcast, the loss is the global batch's and the
    gradients are averaged. ``tp`` (a tensor-parallel group) splits the
    FeaT stacks first (:func:`~..parallel.tp.shard_feat_tp`); in a dp×tp
    grid ``dp`` is the grid's data group.

    Random numbers: augmentation draws come from the generator passed to
    :meth:`train_step` (under ``dp``, the draws of the global batch, of
    which each rank takes its rows); dropout draws from the device's
    default generator, which the caller seeds (``torch.manual_seed``)."""

    def __init__(self, config: dict, modals, downscale, steps_per_epoch: int,
                 state_dict: dict | None = None, dtype=torch.bfloat16,
                 device=None, dp=None, tp=None):
        self.device = resolve_device(device)
        model_cfg, train_cfg = config["model"], config["training"]
        with torch.device(self.device):
            model = dict_models[model_cfg["name"]](model_cfg)
        if state_dict is not None:
            # copied in: training never writes into the caller's tensors
            model.load_state_dict(state_dict, strict=True)
        if tp is not None:
            shard_feat_tp(model, tp)
        self.dp = dp
        if dp is not None:
            dp.replicate(dp.convert_batch_norm(model))
        memory_format = (torch.channels_last if self.device.type == "cuda"
                         else torch.preserve_format)
        self.model = model.to(memory_format=memory_format).train()
        named = [(n, p) for n, p in self.model.named_parameters()
                 if p.requires_grad]
        self.param_names = [n for n, _ in named]
        self.params = [p for _, p in named]
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
        self.lr = float(optim_cfg["lr_init"])
        self.lr_schedule = None
        if sched_cfg["name"] != "ReduceLROnPlateau":
            self.lr_schedule = make_lr_schedule(
                sched_cfg["name"], dict(sched_cfg.get("params") or {}),
                lr_init=self.lr, steps_per_epoch=steps_per_epoch)
        self.preprocess = make_preprocess_fn(
            self.modals, downscale, train=True,
            augment_full_res=bool(train_cfg.get("augment_full_res", True)))
        self.step = 0

    def optimizer_state(self) -> dict:
        """The optimizer's per-parameter tensors, ``{state key: {parameter
        name: tensor}}`` for each of :func:`~.state.moment_keys`; zeros
        before the first step, as optax initializes them."""
        state = self.optimizer.state_dict()["state"]
        return {key: {n: state[i][key] if i in state else
                      torch.zeros_like(self.params[i])
                      for i, n in enumerate(self.param_names)}
                for key in moment_keys(self.optimizer)}

    def load_optimizer_state(self, moments: dict, step: int) -> None:
        """Set the optimizer's state to ``moments`` (as
        :meth:`optimizer_state` gives them) after ``step`` updates, and
        the runtime's step to ``step``. A moment that is missing or of
        another shape than its parameter raises."""
        names = self.param_names
        keys = moment_keys(self.optimizer)
        if set(moments) != set(keys):
            raise ValueError(f"optimizer state {sorted(moments)}, expected "
                             f"{sorted(keys)}")
        for key in keys:
            if set(moments[key]) != set(names):
                missing = sorted(set(names) ^ set(moments[key]))
                raise ValueError(f"{key}: parameters differ, e.g. "
                                 f"{missing[:3]}")
            for n, p in zip(names, self.params):
                if moments[key][n].shape != p.shape:
                    raise ValueError(f"{key} of {n}: shape "
                                     f"{tuple(moments[key][n].shape)}, "
                                     f"parameter {tuple(p.shape)}")
        # torch's Adam and AdamW count their steps per parameter
        with_step = isinstance(self.optimizer,
                               (torch.optim.Adam, torch.optim.AdamW))
        state = {}
        for i, n in enumerate(names):
            state[i] = {key: moments[key][n] for key in keys}
            if with_step:
                state[i]["step"] = torch.tensor(float(step))
        self.optimizer.load_state_dict(
            {"state": state,
             "param_groups": self.optimizer.state_dict()["param_groups"]})
        self.step = int(step)

    def to_device(self, xs) -> tuple:
        return tuple(torch.as_tensor(x).to(self.device, non_blocking=True)
                     for x in xs)

    def sample_draws(self, generator: torch.Generator, batch: int) -> list:
        """One set of augmentation draws per modality, in modality order.
        Under ``dp`` the draws of the global batch (``batch × world``), of
        which this rank takes its rows, as JAX splits one key per sample
        of the global batch."""
        world = 1 if self.dp is None else self.dp.world
        draws = [None if m == "clin" else
                 sample_augment_draws(generator, batch * world)
                 for m in self.modals]
        if self.dp is None:
            return draws
        rows = self.dp.rows(batch)
        return [None if d is None else AugmentDraws(*(t[rows] for t in d))
                for d in draws]

    def train_step(self, xs, ys, generator: torch.Generator | None = None,
                   draws=None):
        """One optimizer step on the raw batch ``xs`` (one array per
        modality, host or device) with integer targets ``ys``.

        The augmentation draws come from ``generator``, or are given as
        ``draws`` (one :class:`~..ops.preproc.AugmentDraws` per modality).
        Returns the loss (under ``dp`` the global batch's) and the float32
        logits of this rank's rows, both detached. The step is the span
        ``train.step``, id the step."""
        with tracing.span("train.step", id=self.step):
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
            if self.dp is None:
                loss = self.loss_fn(logits, ys)
                loss.backward()
            else:
                loss_rank, loss = self.dp.global_loss(self.loss_fn, logits,
                                                      ys)
                loss_rank.backward()
            # parameters the loss does not reach (the per-MRI FeaTs' heads)
            # still take the update, as JAX's zero grads and weight decay do
            for p in self.params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            if self.dp is not None:
                self.dp.all_reduce_grads(self.params)
            set_lr(self.optimizer, self.lr if self.lr_schedule is None
                   else self.lr_schedule(self.step))
            self.optimizer.step()
            self.optimizer.zero_grad(set_to_none=True)
        self.step += 1
        return loss.detach(), logits.detach()


class MetricsLogger:
    """JSONL scalar log, ``scalars.jsonl`` in ``path_dir``: one
    ``{"tag", "value", "step"}`` object per line, the JAX package's tags.
    (The JAX package also writes TensorBoard when it is installed; the
    port does not.) ``enabled=False`` (the ranks after the first of a
    process group) writes nothing."""

    def __init__(self, path_dir, enabled: bool = True):
        self.path_dir = Path(path_dir)
        self._fh = None
        if enabled:
            self.path_dir.mkdir(parents=True, exist_ok=True)
            self._fh = open(self.path_dir / "scalars.jsonl", "a")

    def scalar(self, tag: str, value, step: int):
        if self._fh is not None:
            self._fh.write(json.dumps(
                {"tag": tag, "value": float(value), "step": int(step)})
                + "\n")

    def flush(self):
        if self._fh is not None:
            self._fh.flush()

    def close(self):
        if self._fh is not None and not self._fh.closed:
            self._fh.close()


def _modality_xs(batch: dict, modals) -> tuple:
    return tuple(batch[f"image__{m}"] for m in modals)


class ProgressionTrainer:
    """Model, optimizer, loss, loaders and checkpoints of one fold.

    ``config`` is the JAX package's config as a plain nested dict (its
    ``Config.to_dict()``). ``datasets`` is None, to build the fold's
    train/val/test datasets through the provider (pandas, as the JAX
    trainer does), or a dict ``train``/``val``/``test`` (and ``sel`` for
    ``data.debug``) of objects with ``get(idx, epoch)``, ``__len__`` and
    ``targets()``. ``runtime.compute_dtype`` selects the autocast dtype.
    The trainer runs on ``device``, the GPU unless ``device="cpu"``.

    Random streams are a pure function of (seed, epoch, step), so that a
    resumed run equals an unbroken one: the augmentation draws of a step
    come from a generator seeded from (``seed_train_val`` + 1000, epoch,
    step, 0), JAX's base seed, and its dropout from the device's default
    generator seeded from (…, 1) for the step, and the rank under a
    process group (:meth:`dropout_seed`; the caller's generator state is
    restored after it); the crops from the dataset's (seed,
    epoch, index) and the order from the sampler's (seed, epoch). The
    initial weights come from torch's initialization under seed 0. The
    bits differ from the JAX package's ``jax.random`` streams.

    ``resume=False`` leaves the fold's last checkpoint unread: the
    evaluator takes the trainer for its loaders and restores each fold's
    weights itself.

    Under a process group (``parallel.dcn.initialize_distributed``) the
    trainer is data-parallel: each loader reads the process's contiguous
    shard of every epoch (``data_shard``, its ``(rank, world)``),
    ``batch_size`` is the batch of one process, the step is the global
    batch's (:class:`TrainRuntime` with ``dp``), validation predictions
    are gathered so that every rank computes the same metrics, and only
    rank 0 writes ``scalars.jsonl`` and checkpoints.

    ``timing`` accumulates seconds: ``loader_wait`` (the loop blocked on
    the loader's queue, each wait also the span ``train.loader_wait``, id
    the step), ``ckpt_write``, ``ckpt_read``; and counts ``train_steps``,
    ``val_batches`` and ``ckpt_bytes`` (the last file written)."""

    def __init__(self, config: dict, fold_idx: int, *, device=None,
                 datasets=None, resume: bool = True):
        self.device = resolve_device(device)
        self.config = config
        self.fold_idx = fold_idx
        model_cfg, train_cfg = config["model"], config["training"]
        self.dp = create_group((config.get("runtime") or {}).get(
            "n_devices"))
        self.data_shard = ((0, 1) if self.dp is None
                           else (self.dp.rank, self.dp.world))
        self.is_writer = self.dp is None or self.dp.is_writer

        ds_cfg = next(iter(config["data"]["sets"].values()))
        self.modals = list(ds_cfg["modals"])
        if datasets is None:
            from ..data.provider import prepare_datasets
            datasets = prepare_datasets(config, fold_idx)[ds_cfg["name"]]
        self.datasets = datasets
        if config["data"].get("debug", False):
            self.datasets["sel"].describe()

        arity = MODEL_ARITY[model_cfg["name"]]
        if arity != len(self.modals):
            raise ValueError(f"Model {model_cfg['name']} expects {arity} "
                             f"modalities, got {self.modals}")

        train_ds = self.datasets["train"]
        if train_cfg["sampler"] == "weighted":
            sampler = WeightedSampler(train_ds.targets(),
                                      seed=config["seed_train_val"])
        elif train_cfg["sampler"] == "default":
            sampler = SequentialSampler(len(train_ds))
        else:
            raise ValueError(f"Invalid sampler {train_cfg['sampler']}")
        nw = int(config.get("num_workers", 8))
        lb = config.get("loader_backend", "threads")
        pin = self.device.type == "cuda"

        def loader(name, smp, batch_size, **kw):
            return make_batch_loader(lb, self.datasets[name], smp,
                                     int(batch_size), num_workers=nw,
                                     pin_memory=pin,
                                     shard_index=self.data_shard[0],
                                     shard_count=self.data_shard[1], **kw)

        self.loaders = {
            "train": loader("train", sampler, train_cfg["batch_size"],
                            drop_last=True),
            "val": loader("val", SequentialSampler(len(self.datasets["val"])),
                          config["validation"]["batch_size"], drop_last=True),
            "test": loader("test",
                           SequentialSampler(len(self.datasets["test"])),
                           config["testing"]["batch_size"], drop_last=False,
                           pad_to_batch=True),
        }

        # the reference's layout: weights/prog/fold_k, logs_train/fold_k
        root = Path(config["path_experiment_root"])
        self.path_weights_fold = root / "weights" / "prog" / f"fold_{fold_idx}"
        self.path_weights_fold.mkdir(parents=True, exist_ok=True)
        self.path_logs_fold = root / "logs_train" / f"fold_{fold_idx}"
        self.tb = MetricsLogger(self.path_logs_fold, enabled=self.is_writer)
        self.ckpt = make_checkpoint_handler(
            self.path_weights_fold,
            backend=train_cfg.get("ckpt_backend", "msgpack"))

        downscale = model_cfg.get("downscale") or None
        if downscale:
            downscale = [list(f) for f in downscale]
        self.downscale = downscale
        self.steps_per_epoch = max(1,
                                   self.loaders["train"].batches_per_epoch())
        dtype = COMPUTE_DTYPES[config["runtime"]["compute_dtype"]]
        with self._forked_rng():
            torch.manual_seed(0)
            self.runtime = TrainRuntime(config, self.modals, downscale,
                                        self.steps_per_epoch, dtype=dtype,
                                        device=self.device, dp=self.dp)
        self.preprocess_eval = make_preprocess_fn(self.modals, downscale,
                                                  train=False)
        self.rng = PRNGChain(config["seed_train_val"] + 1000)

        # the metric-driven LR controller (ReduceLROnPlateau)
        self._plateau = None
        sched_cfg = train_cfg["sched"]
        if sched_cfg["name"] == "ReduceLROnPlateau":
            params = dict(sched_cfg.get("params") or {})
            params.setdefault("mode", "min" if config["validation"][
                "criterion"] == "loss" else "max")
            self._plateau = ReduceLROnPlateau(
                lr_init=float(train_cfg["optim"]["lr_init"]), **params)

        self.timing = dict(loader_wait=0.0, ckpt_write=0.0, ckpt_read=0.0,
                           train_steps=0, val_batches=0, ckpt_bytes=0)
        self._init_state(resume)

    # ------------------------------------------------------------------

    def dropout_seed(self, epoch_idx: int, step_idx: int) -> int:
        """The seed of a training step's dropout. Under data parallelism
        each rank's masks are its own (the seed takes the rank), as JAX
        draws one key per sample of the global batch."""
        coords = (epoch_idx, step_idx, 1)
        if self.dp is not None:
            coords += (self.dp.rank,)
        return self.rng.seed(*coords)

    def _forked_rng(self):
        """A scope whose changes to the CPU and the trainer's device's
        default generators are undone at its end."""
        devices = ([self.device.index if self.device.index is not None
                    else torch.cuda.current_device()]
                   if self.device.type == "cuda" else [])
        return torch.random.fork_rng(devices=devices)

    def _ckpt_payload(self) -> dict:
        """The full train state in the JAX package's checkpoint layout,
        with the plateau controller's state where there is one."""
        return runtime_payload(self.config["model"]["name"], self.runtime,
                               self._plateau)

    def _restore(self, path) -> None:
        t0 = time.perf_counter()
        load_runtime_payload(self.config["model"]["name"], self.runtime,
                             load_ckpt(path), self._plateau)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.timing["ckpt_read"] += time.perf_counter() - t0

    def _init_state(self, resume: bool = True):
        model_cfg = self.config["model"]
        n_grafted = apply_pretrained_fes(model_cfg, self.runtime.model)
        if n_grafted:
            logger.info(f"Grafted ImageNet weights into {n_grafted} FEs")
        # explicit weight restore: a checkpoint payload of either package,
        # or a reference-named torch state dict
        if model_cfg.get("restore_weights") and model_cfg.get("path_weights"):
            path_w = str(model_cfg["path_weights"])
            if path_w.endswith((".pth", ".pt")):
                sd = torch.load(path_w, map_location="cpu",
                                weights_only=True)
                self.runtime.model.load_state_dict(sd, strict=True)
            else:
                self._restore(path_w)
            logger.info(f"Restored weights from {path_w}")

        self.start_epoch = 0
        last = self.ckpt.get_last_ckpt() if resume else None
        if last is not None:
            self._restore(last)
            self.start_epoch = self.runtime.step // self.steps_per_epoch
            logger.info(f"Resumed from {last} at epoch {self.start_epoch}")

    # ------------------------------------------------------------------

    def train_epoch(self, epoch_idx: int) -> dict:
        losses = []
        steps = self.loaders["train"].batches_per_epoch()
        debug = self.config["training"].get("debug", False)
        batches = self.loaders["train"].epoch(epoch_idx)
        try:
            for step_idx in range(steps):
                step = self.runtime.step
                t0 = tracing.now()
                batch = next(batches)
                t1 = tracing.now()
                self.timing["loader_wait"] += (t1 - t0) / 1e9
                tracing.add("train.loader_wait", t0, t1, id=step)
                xs = _modality_xs(batch, self.modals)
                ys = batch["target"][:, 0]
                gen = self.rng.generator(epoch_idx, step_idx, 0,
                                         device=self.device)
                with self._forked_rng():
                    torch.manual_seed(self.dropout_seed(epoch_idx, step_idx))
                    loss, logits = self.runtime.train_step(xs, ys, gen)
                loss = loss.item()
                self.timing["train_steps"] += 1
                if debug:
                    logger.info(f"Pred: {logits.argmax(dim=1).tolist()}")
                    logger.info(f"True: {ys.tolist()}")
                losses.append(loss)
                if not np.isfinite(loss):
                    # NaN guard: fail loudly, do not train on
                    logger.error(f"Non-finite loss at epoch {epoch_idx} "
                                 f"step {step_idx}; stopping epoch")
                    break
                self.tb.scalar(f"fold_{self.fold_idx}/loss_prog_batch/train",
                               loss, epoch_idx * steps + step_idx)
        finally:
            batches.close()
        return {"loss_prog": float(np.mean(losses)) if losses else np.nan}

    def val_epoch(self, epoch_idx: int) -> dict:
        """The model in eval mode under ``inference_mode``: float32 logits
        → loss and softmax; then ``calc_metrics_v2``."""
        rt = self.runtime
        losses, targets, probas = [], [], []
        steps = self.loaders["val"].batches_per_epoch()
        autocast = (torch.autocast(self.device.type, dtype=rt.dtype)
                    if rt.dtype != torch.float32
                    else contextlib.nullcontext())
        rt.model.eval()
        try:
            with torch.inference_mode():
                for step_idx, batch in enumerate(
                        self.loaders["val"].epoch(epoch_idx)):
                    ys = batch["target"][:, 0]
                    xs = self.preprocess_eval(rt.to_device(
                        _modality_xs(batch, self.modals)))
                    with autocast:
                        out = rt.model(*xs)
                    logits = (out["main"] if isinstance(out, dict)
                              else out).float()
                    loss = rt.loss_fn(logits, ys.to(self.device)).item()
                    losses.append(loss)
                    targets.append(ys.numpy())
                    probas.append(torch.softmax(logits, dim=-1).cpu().numpy())
                    self.timing["val_batches"] += 1
                    self.tb.scalar(f"fold_{self.fold_idx}/loss_prog_batch/val",
                                   loss, epoch_idx * steps + step_idx)
        finally:
            rt.model.train()
        if self.dp is not None:
            # every rank's shard, in rank order: the metrics of the whole
            # validation set, equal on every rank
            parts = self.dp.all_gather_object((losses, targets, probas))
            losses, targets, probas = (sum((p[i] for p in parts), [])
                                       for i in range(3))
        metrics = calc_metrics_v2(
            prog_target=np.concatenate(targets),
            prog_pred_proba=np.concatenate(probas),
            target=self.config["data"]["target"])
        metrics["loss_prog"] = float(np.mean(losses)) if losses else np.nan
        return metrics

    def _save(self, epoch_idx: int) -> None:
        if not self.is_writer:
            return
        t0 = time.perf_counter()
        path = self.ckpt.save_new_ckpt(
            self._ckpt_payload(), model_name=self.config["model"]["name"],
            fold_idx=self.fold_idx, epoch_idx=epoch_idx)
        self.timing["ckpt_write"] += time.perf_counter() - t0
        self.timing["ckpt_bytes"] = ckpt_bytes(path)

    def fit(self) -> dict:
        """The epoch loop, with the best checkpoint by
        ``validation.criterion`` (``loss``: lower is better;
        ``b_accuracy``, ``avg_precision``: higher)."""
        crit_name = self.config["validation"]["criterion"]
        if crit_name == "loss":
            crit_best, crit_rule = float("inf"), lambda new, ref: new <= ref
        elif crit_name in ("b_accuracy", "avg_precision"):
            crit_best, crit_rule = 0.0, lambda new, ref: new >= ref
        else:
            raise ValueError(f"Unknown criterion: {crit_name}")

        best = {"epoch": -1, "val": {}}
        num_epochs = int(self.config["training"]["epochs"]["num"])
        for epoch_idx in range(self.start_epoch, num_epochs):
            t0 = time.time()
            metrics_train = self.train_epoch(epoch_idx)
            metrics_val = self.val_epoch(epoch_idx)

            for k, v in {**{f"train/{k}": v for k, v in metrics_train.items()},
                         **{f"val/{k}": v
                            for k, v in metrics_val.items()}}.items():
                if isinstance(v, (int, float, np.floating)) \
                        and np.isfinite(v):
                    self.tb.scalar(f"fold_{self.fold_idx}/{k}", v, epoch_idx)
            rt = self.runtime
            lr_now = (self._plateau.current_lr if self._plateau is not None
                      else float(rt.lr_schedule(rt.step)))
            self.tb.scalar(f"fold_{self.fold_idx}/learning_rate", lr_now,
                           epoch_idx)
            self.tb.flush()
            logger.info(
                f"fold {self.fold_idx} epoch {epoch_idx}: "
                f"train_loss={metrics_train['loss_prog']:.4f} "
                f"val_loss={metrics_val['loss_prog']:.4f} "
                f"val_{crit_name}="
                f"{metrics_val.get(crit_name, metrics_val['loss_prog'])} "
                f"({time.time() - t0:.1f}s)")

            crit_curr = metrics_val["loss_prog"] if crit_name == "loss" \
                else metrics_val[crit_name]
            if np.isnan(crit_curr):
                continue
            if self._plateau is not None:
                rt.lr = self._plateau.step(crit_curr)
            if crit_rule(crit_curr, crit_best):
                crit_best = crit_curr
                best = {"epoch": epoch_idx, "val": metrics_val}
                self._save(epoch_idx)

        logger.info(f"Finished fold {self.fold_idx}: best {crit_name}="
                    f"{crit_best} at epoch {best['epoch']}")
        self.tb.close()
        return {"criterion": crit_name, "best": crit_best,
                "epoch": best["epoch"], "val_metrics": best["val"]}
