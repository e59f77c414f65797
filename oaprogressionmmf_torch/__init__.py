"""PyTorch/CUDA port of `oaprogressionmmf_tpu` for NVIDIA Hopper (H100).

The package mirrors the JAX package's layout (`ops/`, `models/`, `train/`,
`utils/`, `serving.py`) so each module has an obvious counterpart. It
imports torch and numpy only — never jax, flax or the JAX package.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a GPU they raise instead of silently falling back
(:func:`resolve_device`). Hand-written kernels (``ops/csrc/*.cu``) are
compiled with nvcc at first use on the card, never at import.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
