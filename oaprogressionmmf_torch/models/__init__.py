"""Model registry of the port — name → nn.Module class.

Holds only the families ported so far; ``dict_models[config["name"]]``
builds a model from the same ``model`` config subtree as the JAX package.
"""

from .families import FeatC1, XR1MR2C1CnnTrf
from .feat import Attention, FeaT, FeedForward, Transformer
from .resnet import (FE_ARCHS, FE_OUT_CHANNELS, FE_STRIDE32, ResNetFE,
                     resnet18, resnet34, resnet50, resnext50_32x4d)

dict_models = {
    "XR1MR2C1CnnTrf": XR1MR2C1CnnTrf,
}

# how many input arrays each family's forward takes, in modality order
MODEL_ARITY = {
    "XR1MR2C1CnnTrf": 4,
}

__all__ = [
    "dict_models", "MODEL_ARITY", "XR1MR2C1CnnTrf", "FeatC1",
    "FeaT", "Attention", "FeedForward", "Transformer",
    "ResNetFE", "FE_ARCHS", "FE_OUT_CHANNELS", "FE_STRIDE32",
    "resnet18", "resnet34", "resnet50", "resnext50_32x4d",
]
