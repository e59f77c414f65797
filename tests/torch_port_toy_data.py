"""A toy dataset for the loader tests, in a module of its own: the
worker-process loader spawns its workers, which import the dataset's
module, and this one imports numpy only."""

import numpy as np


class ToyDataset:
    """Samples that depend on (idx, epoch): an image, a target, a name."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def get(self, idx, epoch=0):
        img = np.full((1, 3, 2), idx * 100 + epoch, np.uint8)
        return {"image__xr_pa": img,
                "target": np.asarray([idx % 2], np.int32),
                "exam_knee_id": f"knee{idx}"}
