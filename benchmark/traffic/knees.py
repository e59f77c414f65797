"""Synthetic knees from a seed: the one generator that every traffic mix's
parameters feed.

Each knee holds one array per modality at the configuration's prepared
sizes and types, as the OAI preparation writes them: the X-ray and the
DESS volume uint8, the T2 map float32 (seconds), the clinical values
float32. The values are uniform noise, made to differ from knee to knee
and from slice to slice (a per-knee min-max scaling would erase one
amplitude a knee): a share of each X-ray's blocks, growing across the
cohort, is dimmed to a tenth, and every MRI slice has an amplitude of its
own. The labels are a seeded permutation with both classes in equal
parts. Everything is drawn on ``device`` by one ``torch.Generator`` and
handed over as host arrays, as a loader would read them.

Traffic parameters (a workload file's ``traffic``): ``knees``, and
optionally ``xr_blocks`` (blocks a side, default 7), ``xr_dark``
(the dimmed share's range across the cohort, default [0.1, 0.9]),
``slice_amp`` (default [0.1, 1.0]), ``t2_levels`` and ``t2_step``
(default 1000 levels of 1e-4 s).
"""

from __future__ import annotations

import numpy as np
import torch


def _knee(gen, device, modals, sizes, share, tr) -> dict:
    out = {}
    lo, hi = tr.get("slice_amp", [0.1, 1.0])
    for m, size in zip(modals, sizes):
        size = tuple(int(s) for s in size)
        if m == "clin":
            out[m] = torch.rand((1, 9), generator=gen, device=device)
        elif m == "xr_pa":
            nb = int(tr.get("xr_blocks", 7))
            r, c = size
            x = torch.randint(0, 256, (1, r, c), generator=gen,
                              device=device).float()
            dark = torch.rand((nb, nb), generator=gen, device=device) < share
            scale = torch.where(dark, 0.1, 1.0)
            scale = scale.repeat_interleave(-(-r // nb), 0)[:r]
            scale = scale.repeat_interleave(-(-c // nb), 1)[:, :c]
            out[m] = (x * scale).to(torch.uint8)
        else:
            amp = lo + (hi - lo) * torch.rand(size[-1], generator=gen,
                                              device=device)
            if m == "sag_t2_map":
                x = torch.randint(0, int(tr.get("t2_levels", 1000)),
                                  (1, *size), generator=gen, device=device)
                out[m] = x.float() * float(tr.get("t2_step", 1e-4)) * amp
            else:
                x = torch.randint(0, 256, (1, *size), generator=gen,
                                  device=device)
                out[m] = (x.float() * amp).to(torch.uint8)
    return out


class Cohort:
    """``knees`` synthetic knees of ``model_cfg``'s input sizes, with
    ``get(idx, epoch)``, ``__len__`` and ``targets()`` as the trainer's
    loaders read a dataset."""

    def __init__(self, model_cfg: dict, modals, traffic: dict, seed: int,
                 device):
        n = int(traffic["knees"])
        self.modals = list(modals)
        sizes = [[9] if m == "clin" else s
                 for m, s in zip(self.modals, model_cfg["input_size"])]
        gen = torch.Generator(device=device).manual_seed(
            int(seed) % 2 ** 63)
        perm = torch.randperm(n, generator=gen, device=device).cpu().numpy()
        self.labels = (perm % 2).astype(np.int32)
        lo, hi = traffic.get("xr_dark", [0.1, 0.9])
        self.arrays = {m: [] for m in self.modals}
        for i in range(n):
            share = lo + (hi - lo) * i / max(n - 1, 1)
            knee = _knee(gen, device, self.modals, sizes, share, traffic)
            for m in self.modals:
                self.arrays[m].append(knee[m].cpu().numpy())
        self.seed = seed

    def __len__(self):
        return len(self.labels)

    def targets(self) -> np.ndarray:
        return self.labels

    def get(self, idx: int, epoch: int = 0) -> dict:
        item = {f"image__{m}": self.arrays[m][idx] for m in self.modals}
        item["target"] = self.labels[idx:idx + 1]
        item["exam_knee_id"] = f"synth{self.seed}__{idx:04d}"
        return item

    def batch(self, idx) -> tuple:
        """The raw arrays of knees ``idx``, stacked: one (B, 1, ...) host
        array per modality."""
        return tuple(np.stack([self.arrays[m][i] for i in idx])
                     for m in self.modals)
