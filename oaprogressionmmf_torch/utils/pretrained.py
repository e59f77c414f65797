"""ImageNet initialization of the CNN encoders (``fe.*.pretrained``).

Port of ``oaprogressionmmf_tpu/utils/pretrained.py``. The reference
downloads torchvision ImageNet checkpoints; here, as in the JAX package,
they are read from local files only (``$OAPROG_PRETRAINED_DIR``,
``fe.path_weights`` or the torch hub cache), by torchvision's file name,
and an encoder without a file keeps its initialization, with a warning.
A file that is found is grafted: torchvision's names become the port's
reference names (a ResNet's ``conv1``, ``bn1``, ``layer1``-``layer4`` are
its ``nn.Sequential``'s 0, 1 and 4-7; SqueezeNet, VGG16, DenseNet-161
and Inception v3 keep torchvision's names), the classifiers are dropped,
and the FE's parameters and BatchNorm statistics are overwritten in
place.
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

# model family → (FE module, config path to its fe subtree), the JAX
# package's FE_SUBTREES under the port's module names
FE_MODULES = {
    "XR1Cnn": [("_fe", ("fe",))],
    "MR1CnnTrf": [("_fe", ("fe",))],
    "MR2CnnTrf": [("_fe0", ("fe",)), ("_fe1", ("fe",))],
    "XR1MR1CnnTrf": [("_fe0", ("fe", "xr")), ("_fe1", ("fe", "mr"))],
    "XR1MR2CnnTrf": [("_fe0", ("fe", "xr")), ("_fe1", ("fe", "mr")),
                     ("_fe2", ("fe", "mr"))],
    "XR1MR2C1CnnTrf": [("_fe0", ("fe", "xr")), ("_fe1", ("fe", "mr")),
                       ("_fe2", ("fe", "mr"))],
}

# torchvision ResNet children → indices of the port's ResNetFE
_RESNET_CHILDREN = {"conv1": "0", "bn1": "1", "layer1": "4", "layer2": "5",
                    "layer3": "6", "layer4": "7"}
# encoders whose FE is torchvision's ``features`` alone
_FEATURES_ONLY = ("squeezenet1_0", "vgg16", "densenet161")


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


def torchvision_fe_state_dict(arch: str, sd: dict) -> dict:
    """A torchvision ImageNet state dict of ``arch`` → the port FE's keys
    (relative to the FE module), the classifier and ``num_batches_tracked``
    dropped, as the JAX package's ``convert_torch_*_state`` read it."""
    out = {}
    for key, value in sd.items():
        if key.endswith("num_batches_tracked"):
            continue
        if arch in _FEATURES_ONLY:
            if not key.startswith("features."):
                continue
        elif arch == "inception_v3":
            if key.startswith(("AuxLogits.", "fc.")):
                continue
        else:
            head, rest = key.split(".", 1)
            if head == "fc":
                continue
            key = f"{_RESNET_CHILDREN[head]}.{rest}"
        out[key] = value
    return out


def load_imagenet_fe_state(arch: str, path=None) -> dict | None:
    """The port-named ImageNet state of ``arch`` from ``path`` or the
    local file :func:`find_checkpoint` finds; None (with a warning) when
    there is none."""
    import torch

    path = Path(path) if path else find_checkpoint(arch)
    if path is None or not Path(path).exists():
        logger.warning(
            f"No local ImageNet checkpoint for {arch} "
            f"(set OAPROG_PRETRAINED_DIR); falling back to random init")
        return None
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    logger.info(f"Loaded ImageNet weights for {arch} from {path}")
    return torchvision_fe_state_dict(arch, sd)


def apply_pretrained_fes(model_cfg: dict, model) -> int:
    """Graft ImageNet weights into every FE of ``model`` whose config has
    ``pretrained: true`` and a local file; returns how many were grafted.
    A key the FE lacks, or one of its parameters or statistics that the
    file lacks, raises."""
    n = 0
    cache: dict = {}
    for module, cfg_path in FE_MODULES.get(model_cfg["name"], []):
        fe_cfg = model_cfg
        for p in cfg_path:
            fe_cfg = fe_cfg[p]
        if not fe_cfg.get("pretrained", False):
            continue
        arch = fe_cfg["arch"]
        if arch not in cache:
            cache[arch] = load_imagenet_fe_state(
                arch, path=fe_cfg.get("path_weights"))
        if cache[arch] is None:
            continue
        missing, unexpected = model.get_submodule(module).load_state_dict(
            cache[arch], strict=False)
        missing = [k for k in missing if not k.endswith("num_batches_tracked")]
        if missing or unexpected:
            raise KeyError(f"ImageNet {arch} state does not fit {module}: "
                           f"missing {missing[:5]}, unexpected "
                           f"{unexpected[:5]}")
        n += 1
    return n
