"""Determinism controls.

Port of ``oaprogressionmmf_tpu/utils/seeding.py``. :func:`set_ultimate_seed`
seeds every host-side RNG and torch's default generators. The JAX
package's ``PRNGChain`` derives a ``jax.random`` key from (seed, *coords);
the port's :class:`PRNGChain` derives a ``torch.Generator`` the same way,
from numpy's ``SeedSequence`` of the coordinates, so any step of any epoch
is replayable: a pure function of its coordinates. Its bits differ from
``jax.random``'s.
"""

from __future__ import annotations

import os
import random

import numpy as np
import torch


def set_ultimate_seed(base_seed: int = 777) -> None:
    """Seed every host-side RNG and torch's default generators."""
    os.environ["PYTHONHASHSEED"] = str(base_seed)
    random.seed(base_seed)
    np.random.seed(base_seed)
    torch.manual_seed(base_seed)


class PRNGChain:
    """Deterministic, replayable seeds and generators.

    ``seed(*coords)`` is a 63-bit integer, a pure function of the root seed
    and the coordinates; ``generator(*coords, device=...)`` is a
    ``torch.Generator`` on ``device`` seeded with it."""

    def __init__(self, seed: int):
        self._root = int(seed)

    def seed(self, *coords: int) -> int:
        state = np.random.SeedSequence(
            [self._root, *(int(c) for c in coords)]).generate_state(
                1, np.uint64)[0]
        return int(state >> np.uint64(1))

    def generator(self, *coords: int, device="cpu") -> torch.Generator:
        return torch.Generator(device=device).manual_seed(self.seed(*coords))
