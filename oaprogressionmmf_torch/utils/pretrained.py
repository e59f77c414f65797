"""ImageNet initialization of the CNN encoders (``fe.*.pretrained``).

The JAX package reads torchvision ImageNet checkpoints from local files
only (``$OAPROG_PRETRAINED_DIR``, ``fe.path_weights`` or the torch hub
cache), by torchvision's file name, and skips an encoder with a warning
when none is found (``oaprogressionmmf_tpu/utils/pretrained.py``). The
port keeps that rule for finding the file; grafting the weights it finds
is not ported yet (ROADMAP.md §1 item 4), so a file that is found raises
instead of being ignored.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path

logger = logging.getLogger("pretrained")

# torchvision model-zoo checkpoint file names per architecture
CHECKPOINT_FILES = {
    "resnet18": "resnet18-5c106cde.pth",
    "resnet34": "resnet34-333f7ec4.pth",
    "resnet50": "resnet50-19c8e357.pth",
    "resnext50_32x4d": "resnext50_32x4d-7cdf4587.pth",
    "squeezenet1_0": "squeezenet1_0-a815701f.pth",
    "vgg16": "vgg16-397923af.pth",
    "densenet161": "densenet161-8d451a50.pth",
    "inception_v3": "inception_v3_google-1a9a5a14.pth",
}

# model family → config paths of its FE subtrees
FE_CONFIGS = {
    "XR1Cnn": [("fe",)],
    "MR1CnnTrf": [("fe",)],
    "MR2CnnTrf": [("fe",)],
    "XR1MR1CnnTrf": [("fe", "xr"), ("fe", "mr")],
    "XR1MR2CnnTrf": [("fe", "xr"), ("fe", "mr")],
    "XR1MR2C1CnnTrf": [("fe", "xr"), ("fe", "mr")],
}


def find_checkpoint(arch: str) -> Path | None:
    """Locate a local torchvision checkpoint for ``arch``, or None."""
    fname = CHECKPOINT_FILES.get(arch)
    if fname is None:
        return None
    candidates = []
    env_dir = os.environ.get("OAPROG_PRETRAINED_DIR")
    if env_dir:
        candidates.append(Path(env_dir) / fname)
        candidates.append(Path(env_dir) / f"{arch}.pth")
    hub = os.environ.get("TORCH_HOME", os.path.expanduser("~/.cache/torch"))
    candidates.append(Path(hub) / "hub" / "checkpoints" / fname)
    for c in candidates:
        if c.exists():
            return c
    return None


def check_pretrained_fes(model_cfg: dict) -> None:
    """Apply the JAX package's rule to every FE with ``pretrained: true``:
    without a local file it keeps its initialization, with a warning; with
    one, the graft is not ported and this raises."""
    for cfg_path in FE_CONFIGS.get(model_cfg["name"], []):
        fe_cfg = model_cfg
        for p in cfg_path:
            fe_cfg = fe_cfg[p]
        if not fe_cfg.get("pretrained", False):
            continue
        arch = fe_cfg["arch"]
        path = fe_cfg.get("path_weights") or find_checkpoint(arch)
        if path is None or not Path(path).exists():
            logger.warning(
                f"No local ImageNet checkpoint for {arch} "
                f"(set OAPROG_PRETRAINED_DIR); falling back to random init")
            continue
        raise NotImplementedError(
            f"ImageNet initialization from {path} is not ported "
            f"(ROADMAP.md §1 item 4); set {'.'.join(cfg_path)}.pretrained "
            f"to false")
