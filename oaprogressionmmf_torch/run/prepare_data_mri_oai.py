"""CLI: OAI MRI data preparation —
``python -m oaprogressionmmf_torch.run.prepare_data_mri_oai``.

Port of ``oaprogressionmmf_tpu/run/prepare_data_mri_oai.py``, function for
function (the reference's koafusion/run/prepare_data_mri_oai.py:31-401):
DICOM series → oriented volume (IPR+/IRP+ anatomical conventions) →
bit-shift/percentile-clip/uint compression + 16px margin crop →
``image.nii.gz`` per exam + ``meta_images.csv``. The SAG_T2_MAP branch
assembles the 4D MESE stack (slices × rows × cols × echoes, per-slice TEs)
and fits the T2 map on the card (``ops/t2_fit.py``) unless the caller
passes ``device="cpu"``.

DICOM IO uses the port's minimal reader (``utils/dicom.py``); geometry is
derived from ImageOrientationPatient/ImagePositionPatient. ``main`` reads
the extract CSV with pandas and its overrides with PyYAML, both imported
inside it; ``handle_series`` and everything below it need neither. Its
worker processes are spawned, not forked: a forked child cannot
initialise CUDA once the parent has.
"""

from __future__ import annotations

import logging
import multiprocessing
import sys
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np

from ..data.constants import RELEASE_TO_PREFIX_VAR, RELEASE_TO_VISIT_MONTH
from ..data.t2_mapping import fit_t2_map
from ..device import resolve_device
from ..utils.dicom import dcmread
from ..utils.formats import numpy_to_nifti

logger = logging.getLogger("prepare_mri")


# ---------------------------------------------------------------------------
# Geometry: slice stack → anatomical convention
# ---------------------------------------------------------------------------

_AXIS_LABELS = ("L", "P", "S")  # +x → Left, +y → Posterior, +z → Superior


def _dominant_direction(vec) -> str:
    """Anatomical label of a direction vector, e.g. 'I' for mostly -z."""
    vec = np.asarray(vec, dtype=float)
    idx = int(np.argmax(np.abs(vec)))
    label = _AXIS_LABELS[idx]
    if vec[idx] < 0:
        label = {"L": "R", "P": "A", "S": "I"}[label]
    return label


_OPPOSITE = {"L": "R", "R": "L", "A": "P", "P": "A", "S": "I", "I": "S"}


def reorient_to(volume: np.ndarray, axis_dirs, target: str) -> np.ndarray:
    """Permute/flip a (d0, d1, d2) volume so axes point along `target`.

    axis_dirs: 3 direction vectors (LPS+) of the volume's axes.
    target: e.g. "IPR" — axis0→Inferior, axis1→Posterior, axis2→Right.
    """
    labels = [_dominant_direction(v) for v in axis_dirs]
    out = volume
    perm = []
    flips = []
    for want in target:
        if want in labels:
            src = labels.index(want)
            flip = False
        elif _OPPOSITE[want] in labels:
            src = labels.index(_OPPOSITE[want])
            flip = True
        else:
            raise ValueError(f"Cannot orient axes {labels} to {target}")
        perm.append(src)
        flips.append(flip)
    out = np.transpose(out, perm)
    for ax, f in enumerate(flips):
        if f:
            out = np.flip(out, axis=ax)
    return np.ascontiguousarray(out)


def _read_series_slices(dir_dicom):
    """Read all slices of one series, sorted along the slice normal."""
    files = sorted(Path(dir_dicom).glob("*"))
    slices = []
    for fn in files:
        if fn.is_dir():
            continue
        try:
            slices.append(dcmread(fn))
        except Exception as e:  # noqa: BLE001 - skip-and-log (prep contract)
            logger.warning(f"Unreadable DICOM {fn}: {e!r}")
    if not slices:
        return None

    first = slices[0]
    iop = np.asarray(first.get("ImageOrientationPatient",
                               [1, 0, 0, 0, 1, 0]), dtype=float)
    row_dir, col_dir = iop[:3], iop[3:]
    normal = np.cross(row_dir, col_dir)

    def sort_key(ds):
        ipp = ds.get("ImagePositionPatient")
        if ipp is not None:
            return float(np.dot(np.asarray(ipp, dtype=float), normal))
        return float(ds.get("InstanceNumber", 0))

    slices.sort(key=sort_key)
    return slices, row_dir, col_dir, normal


def _series_meta(ds) -> dict:
    meta = {}
    if "ImagerPixelSpacing" in ds:
        sp = ds.ImagerPixelSpacing
    elif "PixelSpacing" in ds:
        sp = ds.PixelSpacing
    else:
        raise AttributeError("DICOM does not contain spacing info")
    sp = sp if isinstance(sp, (list, tuple)) else [sp, sp]
    meta["pixel_spacing_0"] = float(sp[0])
    meta["pixel_spacing_1"] = float(sp[1])
    meta["slice_thickness"] = float(ds.SliceThickness)
    meta["body_part"] = str(ds.get("BodyPartExamined", "KNEE")).upper()

    series = str(ds.SeriesDescription).upper()
    if "RIGHT" in series:
        meta["side"] = "RIGHT"
    elif "LEFT" in series:
        meta["side"] = "LEFT"
    else:
        raise AttributeError("DICOM does not contain side info")
    meta["series"] = series
    meta["sequence"] = None
    for seq in ("SAG_3D_DESS", "COR_IW_TSE"):
        if seq in series:
            meta["sequence"] = seq
    return meta


def dicom_series_to_numpy_meta(dir_dicom):
    """DESS/TSE series → (volume in IPR+/IRP+, meta)."""
    ret = _read_series_slices(dir_dicom)
    if ret is None:
        logger.warning(f"Skipped {dir_dicom}")
        return None
    slices, row_dir, col_dir, normal = ret

    try:
        meta = _series_meta(slices[0])
    except AttributeError as e:
        logger.warning(f"Skipped {dir_dicom}: {e}")
        return None
    if meta["sequence"] is None:
        logger.error(f"Unsupported series: {dir_dicom}, {meta['series']}")
        return None

    vol = np.stack([s.pixel_array for s in slices], axis=-1).astype(np.float64)
    # axis dirs of (row, col, slice) in LPS+
    axis_dirs = (row_dir, col_dir, normal)
    target = "IPR" if meta["sequence"] == "SAG_3D_DESS" else "IRP"
    vol = reorient_to(vol, axis_dirs, target)

    if str(slices[0].get("PhotometricInterpretation", "")) == "MONOCHROME1":
        vol = vol.max(initial=0) - vol
    return vol, meta


def assemble_4d_mese(dir_dicom):
    """SAG_T2_MAP series → ((slices, rows, cols, echoes), TEs (slices, echoes))."""
    files = sorted(Path(dir_dicom).glob("*"))
    if not files:
        return None
    datasets = []
    for fn in files:
        try:
            datasets.append(dcmread(fn))
        except Exception as e:  # noqa: BLE001
            logger.error(f"Error while assembling {dir_dicom}, {fn}: {e!r}")
            return None

    slice_locs = np.asarray([float(d.SliceLocation) for d in datasets])
    echo_nums = np.asarray([int(d.EchoNumbers) for d in datasets])
    uniq_locs = np.sort(np.unique(slice_locs))
    uniq_echoes = np.sort(np.unique(echo_nums))

    rows = int(datasets[0].Rows)
    cols = int(datasets[0].Columns)
    vol = np.empty((len(uniq_locs), rows, cols, len(uniq_echoes)))
    tes = np.full((len(uniq_locs), len(uniq_echoes)), np.nan)
    for d, loc, echo in zip(datasets, slice_locs, echo_nums):
        si = int(np.searchsorted(uniq_locs, loc))
        ei = int(np.searchsorted(uniq_echoes, echo))
        vol[si, :, :, ei] = d.pixel_array
        te = d.get("EchoTime")
        if te is not None:
            tes[si, ei] = float(te) / 1000.0  # ms → s
        else:
            logger.warning(f"Missing EchoTime in {dir_dicom}")
    return vol, tes, datasets[0]


def dicom_series_to_t2_map_meta(dir_dicom, device=None):
    """SAG_T2_MAP series → (T2 map in IPR+, meta); the map is fitted on
    ``device``, the GPU unless ``device="cpu"``."""
    ret = assemble_4d_mese(dir_dicom)
    if ret is None:
        return None
    vol, tes, first = ret

    # float32 on the host before the copy: the fit's own type, half the bytes
    t2_map = fit_t2_map(vol.astype(np.float32), tes.astype(np.float32),
                        device=device)
    t2_map = np.round(t2_map, decimals=6)

    try:
        meta = _series_meta(first)
    except AttributeError as e:
        logger.warning(f"Skipped {dir_dicom}: {e}")
        return None
    meta["sequence"] = "SAG_T2_MAP"

    # (slices, rows, cols) sagittal stack → IPR+: rows are I→S-ish per OAI
    # MESE; matches the reference's fixed LAS+→IPR+ remap
    t2_map = np.moveaxis(t2_map, [0, 1, 2], [2, 0, 1])
    return t2_map, meta


def preproc_compress_series(image_in, meta, path_stack):
    """Bit-shift, percentile-clip, discretize + margin-crop one series."""
    margin = 16
    seq = meta["sequence"]
    if seq in ("SAG_3D_DESS", "COR_IW_TSE"):
        img = image_in.astype(np.uint16) >> 3
        lo, hi = np.percentile(img, q=(0.0, 99.9))
        if seq == "SAG_3D_DESS" and hi > 255:
            raise ValueError(
                f"Out-of-range intensity after clipping: {path_stack}")
        img = np.clip(img, lo, hi)
        img = img.astype(np.uint8 if seq == "SAG_3D_DESS" else np.uint16)
    elif seq == "SAG_T2_MAP":
        img = image_in
    else:
        raise NotImplementedError(f"Preprocessing not available: {seq}")
    out = np.ascontiguousarray(img[margin:-margin, margin:-margin, :])
    return out, meta


def _guess_sequence(path_stack: str) -> str | None:
    for seq in ("SAG_3D_DESS", "COR_IW_TSE", "SAG_T2_MAP"):
        if seq in path_stack:
            return seq
    # not in the path — sniff the first slice's SeriesDescription
    for fn in sorted(Path(path_stack).glob("*")):
        try:
            series = str(dcmread(fn, stop_before_pixels=True)
                         .SeriesDescription).upper()
        except Exception:  # noqa: BLE001
            continue
        for seq in ("SAG_3D_DESS", "COR_IW_TSE", "SAG_T2_MAP"):
            if seq in series:
                return seq
        return None
    return None


def handle_series(config: dict, path_stack: str, device=None):
    """Prepare one series into ``config["dir_root_output"]`` → its meta
    row, or None when it is skipped. The T2 fit runs on ``device``, the
    GPU unless ``device="cpu"``; without a GPU this raises before reading
    anything."""
    device = resolve_device(device)
    seq = _guess_sequence(path_stack)
    if seq in ("SAG_3D_DESS", "COR_IW_TSE"):
        ret = dicom_series_to_numpy_meta(path_stack)
    elif seq == "SAG_T2_MAP":
        ret = dicom_series_to_t2_map_meta(path_stack, device=device)
    else:
        raise ValueError("Error guessing sequence")
    if ret is None:
        logger.warning(f"Error reading: {path_stack}")
        return None
    image, meta = ret
    image, meta = preproc_compress_series(image, meta, path_stack)

    meta["release"], meta["patient"] = path_stack.split("/")[-4:-2]
    meta["visit_month"] = RELEASE_TO_VISIT_MONTH[meta["release"]]
    meta["prefix_var"] = RELEASE_TO_PREFIX_VAR[meta["release"]]

    protocol = f"{meta['body_part']}__{meta['side']}__{meta['sequence']}"
    dir_out = Path(config["dir_root_output"], meta["patient"],
                   meta["visit_month"], protocol)
    dir_out.mkdir(exist_ok=True, parents=True)
    spacings = (meta["pixel_spacing_0"], meta["pixel_spacing_1"],
                meta["slice_thickness"])
    path_image = str(dir_out / "image.nii.gz")
    if meta["sequence"] in ("SAG_3D_DESS", "SAG_T2_MAP"):
        numpy_to_nifti(image, path_image, spacings=spacings, ipr_to_ras=True)
    elif meta["sequence"] == "COR_IW_TSE":
        numpy_to_nifti(image, path_image, spacings=spacings, irp_to_ras=True)
    else:
        numpy_to_nifti(image, path_image, spacings=spacings)

    keep = ("patient", "release", "visit_month", "prefix_var", "sequence",
            "body_part", "side", "pixel_spacing_0", "pixel_spacing_1",
            "slice_thickness")
    return {k: meta[k] for k in keep}


def main(argv=None, device=None) -> None:
    """Prepare every series of the extract CSV (overrides ``key=value``);
    the T2 fits run on ``device``, the GPU unless ``device="cpu"``."""
    import pandas as pd
    import yaml

    device = resolve_device(device)
    logging.basicConfig(level=logging.INFO)
    argv = list(sys.argv[1:] if argv is None else argv)
    config = {"dir_root_oai_mri": None, "path_csv_extract": None,
              "dir_root_output": None, "num_threads": 1, "debug": False,
              "ignore_cache": False}
    for ov in argv:
        k, v = ov.split("=", 1)
        config[k] = yaml.safe_load(v)
    for k in ("dir_root_oai_mri", "path_csv_extract", "dir_root_output"):
        if not config[k]:
            raise SystemExit(f"Missing required override: {k}=...")

    logger.warning("Only SAG_3D_DESS, COR_IW_TSE, SAG_T2_MAP are supported!")
    logger.warning("Only baseline (00m) images are processed!")

    path_df_images = Path(config["dir_root_output"], "meta_images.csv")
    if path_df_images.exists() and not config["ignore_cache"]:
        logger.info("Cached version of the index exists")
        return

    df_extract = pd.read_csv(config["path_csv_extract"])
    paths_stacks = [str(Path(config["dir_root_oai_mri"], "00m", subdir))
                    for subdir in df_extract["Folder"].tolist()]
    paths_stacks.sort(key=lambda x: int(x.split("/")[-3]))

    if int(config["num_threads"]) == 1:
        metas = [handle_series(config, p, device) for p in paths_stacks]
    else:
        n = len(paths_stacks)
        with ProcessPoolExecutor(
                int(config["num_threads"]),
                mp_context=multiprocessing.get_context("spawn")) as pool:
            metas = list(pool.map(handle_series, [config] * n, paths_stacks,
                                  [str(device)] * n))

    rows = [m for m in metas if m is not None]
    df_images = pd.DataFrame(rows).astype(
        {"patient": str, "visit_month": str, "side": str, "sequence": str})
    Path(config["dir_root_output"]).mkdir(parents=True, exist_ok=True)
    df_images.to_csv(path_df_images, index=False)
    logger.info(f"Wrote {len(df_images)} rows to {path_df_images}")


if __name__ == "__main__":
    main()
