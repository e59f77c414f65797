"""Host-side OAI multimodal dataset.

Port of ``oaprogressionmmf_tpu/data/dataset.py``: read NIfTI/PNG per
modality, check the per-sequence minimum shapes, flip RIGHT knees to LEFT
orientation (DESS/T2 flip the last axis, TSE/XR axis 2), build the
standardized 9-value clinical vector, and crop (a random crop for training
from a counter-based RNG, the centre crop otherwise). The float
preprocessing and augmentation run on the device
(``train.trainer.make_preprocess_fn``). The rows come from a pandas frame
(``data/index.py``), but this module imports no pandas itself.
"""

from __future__ import annotations

import logging
from typing import Sequence

import numpy as np

from ..ops.preproc import center_crop_np, random_crop_np
from ..utils.formats import nifti_to_numpy, png_to_numpy

logger = logging.getLogger("dataset")

# (min shape, flip axis for RIGHT→LEFT) per sequence, incl. channel axis 0
_SEQ_SPEC = {
    "SAG_3D_DESS": {"min_shape": (320, 320, 128), "flip_axis": -1,
                    "reader": "ipr"},
    "COR_IW_TSE": {"min_shape": (320, 320, 32), "flip_axis": 2,
                   "reader": "irp"},
    "SAG_T2_MAP": {"min_shape": (320, 320, 25), "flip_axis": -1,
                   "reader": "ipr"},
    "XR_PA": {"min_shape": (700, 700), "flip_axis": 2, "reader": "png"},
}

# OAI population statistics that standardize the clinical vector
CLIN_STATS = {"AGE": (60.945, 9.209), "P01BMI": (28.734, 4.917),
              "WOMTS-": (10.940, 14.573)}


def read_image(path_file: str, sequence: str) -> np.ndarray:
    """Read one image and prepend the channel axis → (1, R, C[, S]).

    Integer volumes keep their stored dtype (uint8 DESS, uint16 TSE, uint8
    PNG); the device's unit-range step casts them."""
    spec = _SEQ_SPEC.get(sequence)
    if spec is None:
        raise ValueError(f"Unsupported sequence: {sequence}")
    if spec["reader"] == "ipr":
        image, _ = nifti_to_numpy(path_file, ras_to_ipr=True,
                                  preserve_dtype=True)
    elif spec["reader"] == "irp":
        image, _ = nifti_to_numpy(path_file, ras_to_irp=True,
                                  preserve_dtype=True)
    else:
        image = png_to_numpy(path_file)
    return image.reshape((1, *image.shape))


def make_clin_vector(row: dict) -> np.ndarray:
    """9-value standardized clinical vector: age, sex 1-hot, BMI, injury
    1-hot, surgery 1-hot, WOMAC total."""
    vec: list[float] = []
    mu, sd = CLIN_STATS["AGE"]
    vec.append((float(row[("-", "AGE")]) - mu) / sd)
    vec.extend([1.0, 0.0] if row[("-", "P02SEX")] == "MALE" else [0.0, 1.0])
    mu, sd = CLIN_STATS["P01BMI"]
    vec.append((float(row[("-", "P01BMI")]) - mu) / sd)
    for var in ("P01INJ-", "P01KSURG-"):
        onehot = [0.0, 0.0]
        onehot[int(row[("-", var)])] = 1.0
        vec.extend(onehot)
    mu, sd = CLIN_STATS["WOMTS-"]
    vec.append((float(row[("-", "WOMTS-")]) - mu) / sd)
    return np.asarray(vec, dtype=np.float32)


class DatasetOAI3d:
    """Multimodal sample reader with replayable random crops.

    Args:
        df_meta: two-level-column index DataFrame (see data/index.py).
        modals: modality keys in model-input order.
        crop_sizes: per-modality output sizes (config model.input_size);
            None disables cropping.
        train: random crop from a per-(epoch, idx) RNG if True, centre
            crop else.
        seed: base seed of the crop RNG.
    """

    def __init__(self, df_meta, modals: Sequence[str], crop_sizes=None,
                 train: bool = False, seed: int = 0):
        self.df_meta = df_meta
        self.modals = list(modals)
        self.crop_sizes = crop_sizes
        self.train = train
        self.seed = seed

    def __len__(self):
        return len(self.df_meta)

    def targets(self) -> np.ndarray:
        """The progression target of every sample, in index order (the
        weighted sampler's weights)."""
        return self.df_meta[("-", "target")].values.astype(int)

    def _crop(self, image: np.ndarray, size, epoch: int, idx: int,
              branch: int) -> np.ndarray:
        if size is None:
            return image
        size = list(size)
        if not self.train:
            return center_crop_np(image, size)
        rng = np.random.default_rng([self.seed, epoch, idx, branch])
        return random_crop_np(image, size, rng.random(len(size)))

    def get(self, idx: int, epoch: int = 0) -> dict:
        """Read sample ``idx``; its crops are a pure function of (seed,
        epoch, idx)."""
        row = dict(self.df_meta.iloc[idx])
        item: dict = {"clin_vec": make_clin_vector(row)}

        for branch, m in enumerate(self.modals):
            if m == "clin":
                item[f"image__{m}"] = item["clin_vec"][None, :]  # (CH, D)
                continue
            seq = row[(m, "sequence")]
            path = row[(m, "path_image")]
            spec = _SEQ_SPEC[seq]

            image = read_image(path, seq)
            min_shape = np.asarray(spec["min_shape"])
            cur_shape = np.asarray(image.shape[-len(min_shape):])
            if np.any(cur_shape < min_shape):
                logger.error(f"{path} is {cur_shape}, expected >{min_shape}")
            if row[("-", "side")] == "RIGHT":
                image = np.flip(image, axis=spec["flip_axis"])

            size = (list(self.crop_sizes[branch])
                    if self.crop_sizes is not None else None)
            image = self._crop(np.ascontiguousarray(image), size, epoch, idx,
                               branch)
            if not np.issubdtype(image.dtype, np.integer):
                image = image.astype(np.float32)
            item[f"image__{m}"] = image

        item["target"] = np.asarray([row[("-", "target")]], dtype=np.int32)
        item["exam_knee_id"] = row[("-", "exam_knee_id")]
        return item

    def describe(self, num_samples: int | None = None) -> dict:
        """Scan samples for zero or NaN slices and count the classes
        (``data.debug``)."""
        info: dict = {"zero_slice_paths": [], "nan_slice_paths": []}
        targets = []
        n = len(self) if num_samples is None else num_samples
        for i in range(n):
            item = self.get(i)
            for m in self.modals:
                if m == "clin":
                    continue
                img = item[f"image__{m}"]
                path = dict(self.df_meta.iloc[i])[(m, "path_image")]
                spatial_axes = tuple(range(img.ndim - 1))
                if np.sum(np.sum(img, axis=spatial_axes) == 0) >= 1:
                    logger.error(f"Zero slices in {path}")
                    info["zero_slice_paths"].append(path)
                if np.any(np.isnan(img)):
                    logger.error(f"NaN values in {path}")
                    info["nan_slice_paths"].append(path)
            targets.append(item["target"])
        u, c = np.unique(np.asarray(targets), return_counts=True)
        info["target_counts"] = dict(zip(u.tolist(), c.tolist()))
        logger.info(f"Dataset statistics: {sorted(info.items())}")
        return info
