"""Model registry of the port — name → nn.Module class.

``dict_models[config["name"]]`` builds a model from the same ``model``
config subtree as the JAX package.
"""

from .encoders import (DenseNetFE, InceptionV3FE, RGBStemConv, SqueezeNetFE,
                       VGGFE)
from .families import (MR1CnnTrf, MR2CnnTrf, XR1Cnn, XR1MR1CnnTrf,
                       XR1MR2C1CnnTrf, XR1MR2CnnTrf, FeatC1)
from .feat import Attention, FeaT, FeedForward, Transformer
from .resnet import (FE_ARCHS, FE_OUT_CHANNELS, FE_STRIDE32, ResNetFE,
                     resnet18, resnet34, resnet50, resnext50_32x4d)

dict_models = {
    "XR1Cnn": XR1Cnn,
    "MR1CnnTrf": MR1CnnTrf,
    "MR2CnnTrf": MR2CnnTrf,
    "XR1MR1CnnTrf": XR1MR1CnnTrf,
    "XR1MR2CnnTrf": XR1MR2CnnTrf,
    "XR1MR2C1CnnTrf": XR1MR2C1CnnTrf,
}

# how many input arrays each family's forward takes, in modality order
MODEL_ARITY = {
    "XR1Cnn": 1,
    "MR1CnnTrf": 1,
    "MR2CnnTrf": 2,
    "XR1MR1CnnTrf": 2,
    "XR1MR2CnnTrf": 3,
    "XR1MR2C1CnnTrf": 4,
}

__all__ = [
    "dict_models", "MODEL_ARITY", "XR1Cnn", "MR1CnnTrf", "MR2CnnTrf",
    "XR1MR1CnnTrf", "XR1MR2CnnTrf", "XR1MR2C1CnnTrf", "FeatC1",
    "FeaT", "Attention", "FeedForward", "Transformer",
    "ResNetFE", "FE_ARCHS", "FE_OUT_CHANNELS", "FE_STRIDE32",
    "resnet18", "resnet34", "resnet50", "resnext50_32x4d",
    "SqueezeNetFE", "VGGFE", "DenseNetFE", "InceptionV3FE", "RGBStemConv",
]
