"""Rolling per-fold checkpoint store with exact-resume payloads, in the JAX
package's layout.

Port of ``oaprogressionmmf_tpu/utils/checkpoint.py``: one directory per
(model, fold), files ``{model_name}__fold_{fold_idx}__epoch_{epoch_idx:03d}
.ckpt``, the newest ``num_saved`` kept. A payload is the JAX train state
as flax writes it (msgpack, through the port's own codec): ``step``,
``params``, ``batch_stats``, ``opt_state`` in optax's layout, and
``plateau`` under ReduceLROnPlateau. :func:`runtime_payload` and
:func:`load_runtime_payload` carry a ``TrainRuntime`` to and from that
tree, so each package resumes the other's checkpoints.

``training.ckpt_backend: orbax`` (the JAX package's directory per
checkpoint, written atomically) is ``torch.distributed.checkpoint`` here:
the same payload tree in a directory of the same name pattern
(``….orbax``), written to a temporary directory that is renamed into
place, with the tree's layout beside the tensors. Under a process group
rank 0 writes it alone (the state is replicated). A directory that JAX's
orbax wrote cannot be read: its storage layer (tensorstore, through
orbax) imports jax; the msgpack backend crosses between the packages.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import warnings
from pathlib import Path

import numpy as np
import torch

from ..train.state import STEP, optax_chain
from .convert import from_jax_variables, to_jax_variables
from .msgpack_io import read_msgpack, write_msgpack

logger = logging.getLogger("checkpoint")


class CheckpointHandler:
    def __init__(self, path_root,
                 fname_pattern=("{model_name}__"
                                "fold_{fold_idx}__"
                                "epoch_{epoch_idx:>03d}.ckpt"),
                 num_saved=1):
        self.path_root = Path(path_root)
        self.fname_pattern = fname_pattern
        self.num_saved = num_saved

        _, ext = os.path.splitext(self.fname_pattern)
        if not self.path_root.exists():
            raise ValueError(f"Path {self.path_root} does not exist")

        self._all_ckpts = sorted(self.path_root.glob("*" + ext))
        logger.info(f"Checkpoints found: {len(self._all_ckpts)}")
        self._remove_excessive_ckpts()

    def _remove_excessive_ckpts(self):
        while len(self._all_ckpts) > self.num_saved:
            try:
                os.remove(self._all_ckpts[0])
                logger.info(f"Removed ckpt: {self._all_ckpts[0]}")
                self._all_ckpts = self._all_ckpts[1:]
            except OSError:
                logger.error(f"Cannot remove {self._all_ckpts[0]}")
                break

    def get_last_ckpt(self):
        if len(self._all_ckpts) == 0:
            logger.warning(f"No checkpoints are available in {self.path_root}")
            return None
        return self._all_ckpts[-1]

    def save_new_ckpt(self, payload, model_name, fold_idx, epoch_idx):
        """Write a payload tree (numpy arrays or tensors); returns the
        path. The file appears complete or not at all."""
        fname = self.fname_pattern.format(model_name=model_name,
                                          fold_idx=fold_idx,
                                          epoch_idx=epoch_idx)
        path_full = Path(self.path_root, fname)
        tmp = path_full.with_name(path_full.name + ".tmp")
        write_msgpack(tmp, payload)
        os.replace(tmp, path_full)
        self._all_ckpts.append(path_full)
        self._remove_excessive_ckpts()
        return path_full


# a torch.distributed.checkpoint directory holds this file; one that JAX's
# orbax wrote does not
DCP_METADATA = ".metadata"
LAYOUT_FILE = "layout.json"


def _flatten(tree, prefix: str, out: dict):
    """Tensors of a payload tree under "/"-joined keys; returns its layout
    (the tree with None leaves, so that empty subtrees survive)."""
    if isinstance(tree, dict):
        return {k: _flatten(v, f"{prefix}{k}/", out) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
    else:
        a = np.asarray(tree)
        t = torch.from_numpy(a if a.flags.writeable else a.copy())
    out[prefix[:-1]] = t.contiguous()
    return None


def _unflatten(layout, prefix: str, flat: dict):
    if isinstance(layout, dict):
        return {k: _unflatten(v, f"{prefix}{k}/", flat)
                for k, v in layout.items()}
    return flat[prefix[:-1]].numpy()


def _dcp(fn, *args, **kwargs):
    """A torch.distributed.checkpoint call of this process alone (no
    collectives, also under a process group)."""
    import torch.distributed.checkpoint as dcp

    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*single process.*")
        return getattr(dcp, fn)(*args, no_dist=True, **kwargs)


def write_dcp(path, payload) -> None:
    """The payload tree as a torch.distributed.checkpoint directory at
    ``path``: written beside it, then renamed into place."""
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    shutil.rmtree(tmp, ignore_errors=True)
    flat: dict = {}
    layout = _flatten(payload, "", flat)
    _dcp("save", flat, checkpoint_id=str(tmp))
    (tmp / LAYOUT_FILE).write_text(json.dumps(layout))
    if path.exists():
        shutil.rmtree(path)
    os.replace(tmp, path)


def read_dcp(path) -> dict:
    """A directory of :func:`write_dcp` as its payload tree of numpy
    arrays."""
    import torch.distributed.checkpoint as dcp

    path = Path(path)
    if not (path / DCP_METADATA).exists():
        raise NotImplementedError(
            f"{path} is not a torch.distributed.checkpoint directory; if "
            f"JAX's orbax wrote it, the port cannot read it: orbax's storage "
            f"layer imports jax. Write the checkpoint with "
            f"training.ckpt_backend=msgpack, which both packages read")
    meta = dcp.FileSystemReader(str(path)).read_metadata()
    flat = {k: torch.empty(m.size, dtype=m.properties.dtype)
            for k, m in meta.state_dict_metadata.items()}
    _dcp("load", flat, checkpoint_id=str(path))
    return _unflatten(json.loads((path / LAYOUT_FILE).read_text()), "",
                      flat)


class DcpCheckpointHandler(CheckpointHandler):
    """``ckpt_backend: orbax``: the JAX package's OrbaxCheckpointHandler
    surface (a directory per checkpoint, named ``….orbax``, the newest
    ``num_saved`` kept), written by torch.distributed.checkpoint."""

    def __init__(self, path_root, num_saved=1):
        super().__init__(path_root,
                         fname_pattern=("{model_name}__fold_{fold_idx}__"
                                        "epoch_{epoch_idx:>03d}.orbax"),
                         num_saved=num_saved)

    def _remove_excessive_ckpts(self):
        while len(self._all_ckpts) > self.num_saved:
            shutil.rmtree(self._all_ckpts[0])
            logger.info(f"Removed ckpt: {self._all_ckpts[0]}")
            self._all_ckpts = self._all_ckpts[1:]

    def save_new_ckpt(self, payload, model_name, fold_idx, epoch_idx):
        path_full = Path(self.path_root, self.fname_pattern.format(
            model_name=model_name, fold_idx=fold_idx, epoch_idx=epoch_idx))
        write_dcp(path_full, payload)
        if path_full not in self._all_ckpts:
            self._all_ckpts.append(path_full)
        self._remove_excessive_ckpts()
        return path_full


def ckpt_bytes(path) -> int:
    """The bytes of a checkpoint file or directory."""
    path = Path(path)
    if path.is_dir():
        return sum(p.stat().st_size for p in path.rglob("*") if p.is_file())
    return path.stat().st_size


def make_checkpoint_handler(path_root, backend: str = "msgpack",
                            num_saved: int = 1) -> CheckpointHandler:
    """Backend-selecting factory (``training.ckpt_backend``): ``msgpack``
    (a file, read by either package) or ``orbax`` (a
    torch.distributed.checkpoint directory)."""
    if backend == "orbax":
        return DcpCheckpointHandler(path_root, num_saved=num_saved)
    if backend in ("msgpack", None, ""):
        return CheckpointHandler(path_root, num_saved=num_saved)
    raise ValueError(f"Unknown checkpoint backend: {backend}")


def migrate_legacy_qkv(tree):
    """Split legacy fused attention kernels in a restored tree.

    Checkpoints written before the JAX package unpacked q/k/v hold one
    ``to_qkv.kernel`` of shape (d, 3d) per attention block; the current
    tree holds ``to_q``/``to_k``/``to_v`` of (d, d) each, a column split.
    Returns (tree, n_migrated)."""
    n = 0

    def walk(node):
        nonlocal n
        if not isinstance(node, dict):
            return node
        out = {}
        for k, v in node.items():
            if (k == "to_qkv" and isinstance(v, dict) and "kernel" in v
                    and getattr(v["kernel"], "ndim", 0) == 2):
                w = np.asarray(v["kernel"])
                d = w.shape[0]
                out["to_q"] = {"kernel": w[:, :d]}
                out["to_k"] = {"kernel": w[:, d:2 * d]}
                out["to_v"] = {"kernel": w[:, 2 * d:]}
                n += 1
            else:
                out[k] = walk(v)
        return out

    return walk(tree), n


def load_ckpt(path):
    """Read a checkpoint into a nested dict of numpy arrays: a msgpack
    file of either package (the arrays view the file's buffer) or a
    directory of :class:`DcpCheckpointHandler`; legacy fused ``to_qkv``
    kernels are split (:func:`migrate_legacy_qkv`).
    :func:`load_runtime_payload` checks the tree against the runtime it
    restores."""
    path = Path(path)
    tree, n = migrate_legacy_qkv(read_dcp(path) if path.is_dir()
                                 else read_msgpack(path))
    if n:
        logger.info(f"Migrated {n} fused to_qkv kernels in {path}")
    return tree


# ---------------------------------------------------------------------------
# TrainRuntime ↔ the JAX payload
# ---------------------------------------------------------------------------

def _count(step: int) -> np.ndarray:
    return np.asarray(step, np.int32)


def optimizer_tree(model_name: str, runtime, lr: float | None = None
                   ) -> dict:
    """The runtime's optimizer state as optax's state dict (see
    :func:`~..train.state.optax_chain`); under ReduceLROnPlateau (``lr``
    given) wrapped as ``optax.inject_hyperparams`` holds it."""
    moments = runtime.optimizer_state()
    trees = {key: to_jax_variables(model_name, sd)["params"]
             for key, sd in moments.items()}
    chain = {}
    for i, part in enumerate(optax_chain(runtime.optimizer)):
        chain[str(i)] = {field: _count(runtime.step) if key == STEP
                         else trees[key] for field, key in part.items()}
    if lr is None:
        return chain
    return {"count": _count(runtime.step),
            "hyperparams": {"learning_rate": np.asarray(lr, np.float32)},
            "hyperparams_states": {}, "inner_state": chain}


def _same_keys(tree, keys, what: str) -> None:
    if not isinstance(tree, dict) or set(tree) != set(keys):
        got = sorted(tree) if isinstance(tree, dict) else type(tree)
        raise ValueError(f"checkpoint {what}: keys {got}, expected "
                         f"{sorted(keys)}")


def load_optimizer_tree(model_name: str, runtime, tree: dict,
                        plateau: bool) -> None:
    """Set the runtime's optimizer state and step from optax's state dict
    (as :func:`optimizer_tree` writes it); a transform, field or moment
    that is missing, or a moment of another shape, raises."""
    if plateau:
        _same_keys(tree, ("count", "hyperparams", "hyperparams_states",
                          "inner_state"), "opt_state")
    chain = tree["inner_state"] if plateau else tree
    layout = optax_chain(runtime.optimizer)
    _same_keys(chain, [str(i) for i in range(len(layout))], "optax chain")
    moments: dict = {}
    counts = {int(tree["count"])} if plateau else set()
    for i, part in enumerate(layout):
        _same_keys(chain[str(i)], part, f"optax chain entry {i}")
        for field, key in part.items():
            value = chain[str(i)][field]
            if key == STEP:
                counts.add(int(value))
            else:
                moments[key] = from_jax_variables(model_name,
                                                  {"params": value})
    if len(counts) != 1:
        raise ValueError(f"the optimizer state's counts differ: {counts}")
    runtime.load_optimizer_state(moments, counts.pop())


def runtime_payload(model_name: str, runtime, plateau=None) -> dict:
    """The JAX package's checkpoint payload of ``runtime`` (and of the
    ReduceLROnPlateau controller ``plateau``, if any)."""
    variables = to_jax_variables(model_name, runtime.model.state_dict())
    payload = {
        "step": _count(runtime.step),
        "params": variables["params"],
        "batch_stats": variables["batch_stats"],
        "opt_state": optimizer_tree(
            model_name, runtime,
            lr=None if plateau is None else plateau.current_lr),
    }
    if plateau is not None:
        sd = plateau.state_dict()
        payload["plateau"] = {
            "current_lr": np.asarray(sd["current_lr"], np.float64),
            "best": np.asarray(sd["best"], np.float64),
            "num_bad_epochs": np.asarray(sd["num_bad_epochs"], np.int64),
            "cooldown_counter": np.asarray(sd["cooldown_counter"], np.int64),
        }
    return payload


def _to_device(tree, device):
    """A read payload's arrays as tensors on ``device``: on the CPU views
    of the file's buffer, to a GPU one copy each, so that the layout's
    transposes run on the card."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, np.ndarray):
        tree = torch.from_numpy(tree if tree.flags.writeable
                                else tree.copy())
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def load_model_variables(path, device) -> dict:
    """The ``params`` and ``batch_stats`` of a checkpoint of either
    package as tensors on ``device``, for
    :func:`~.convert.from_jax_variables`. The optimizer state stays in the
    file's buffer: it is not moved."""
    payload = load_ckpt(path)
    return _to_device({"params": payload["params"],
                       "batch_stats": payload["batch_stats"]}, device)


def load_runtime_payload(model_name: str, runtime, payload: dict,
                         plateau=None) -> None:
    """Restore ``runtime`` (model, BatchNorm statistics, optimizer state,
    step) and ``plateau`` from a payload (as :func:`load_ckpt` reads it).
    A missing key or a tensor of another shape raises: the model loads
    with ``strict=True`` and the optimizer state is checked against its
    layout. BatchNorm's ``num_batches_tracked``, which the JAX layout does
    not hold, is set to the step: one training forward per step. A
    payload without ``plateau`` (an older JAX checkpoint) restores the
    controller's LR alone, from ``inject_hyperparams``' learning rate, as
    the JAX trainer does."""
    with_plateau = plateau is not None and "plateau" in payload
    _same_keys(payload, ("step", "params", "batch_stats", "opt_state")
               + (("plateau",) if with_plateau else ()), "payload")
    step = int(payload["step"])
    sd = from_jax_variables(model_name, _to_device(
        {"params": payload["params"], "batch_stats": payload["batch_stats"]},
        runtime.device))
    for k in sd:
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.tensor(step)
    runtime.model.load_state_dict(sd, strict=True)
    del sd
    load_optimizer_tree(model_name, runtime,
                        _to_device(payload["opt_state"], runtime.device),
                        plateau=plateau is not None)
    if runtime.step != step:
        raise ValueError(f"checkpoint step {step} and optimizer count "
                         f"{runtime.step} differ")
    if with_plateau:
        plateau.load_state_dict({k: np.asarray(v).item()
                                 for k, v in payload["plateau"].items()})
    elif plateau is not None:
        plateau.current_lr = float(np.asarray(
            payload["opt_state"]["hyperparams"]["learning_rate"]))
    if plateau is not None:
        runtime.lr = plateau.current_lr
