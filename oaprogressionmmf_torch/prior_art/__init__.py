"""Prior-art cohorts of the port (``oaprogressionmmf_tpu/prior_art``)."""

from .tiulpin2019 import build_clinical, build_img_progression_meta

__all__ = ["build_img_progression_meta", "build_clinical"]
