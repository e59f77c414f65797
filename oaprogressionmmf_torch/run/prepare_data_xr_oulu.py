"""CLI: OAI X-ray ROI preparation —
``python -m oaprogressionmmf_torch.run.prepare_data_xr_oulu``.

Port of ``oaprogressionmmf_tpu/run/prepare_data_xr_oulu.py`` (the
reference's koafusion/run/prepare_data_xr_oulu.py:24-131): takes the
Oulu-pipeline knee-ROI PNGs (``<patient>_<visit>_<side>.png``), keeps
baseline visits only, re-lays them into the per-exam directory scheme, and
emits ``meta_images.csv`` + ``meta_base.csv``. Host work only: PNGs through
PIL, the tables through pandas and the overrides through PyYAML, each
imported inside the functions that need it.
"""

from __future__ import annotations

import logging
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from ..utils.formats import numpy_to_png, png_to_numpy

logger = logging.getLogger("prepare_xr")

XR_PIXEL_SPACING = 0.195  # mm, Oulu ROI pipeline output


def png_to_numpy_meta(path_png):
    try:
        image = png_to_numpy(path_png)
        if image is None:
            raise IOError("unreadable PNG")
    except Exception as e:  # noqa: BLE001 - skip-and-log
        logger.warning(f"Skipped {path_png}: {e!r}")
        return None
    stem = Path(path_png).stem
    patient, visit, side = stem.split("_")[:3]
    meta = {
        "sequence": "XR_PA",
        "pixel_spacing_0": XR_PIXEL_SPACING,
        "pixel_spacing_1": XR_PIXEL_SPACING,
        "body_part": "KNEE",
        "patient": patient,
        "visit_month": f"0{visit}m",
        "side": {"L": "LEFT", "R": "RIGHT"}[side],
    }
    return image, meta


def handle_series(config: dict, path_image: str):
    ret = png_to_numpy_meta(path_image)
    if ret is None:
        return None
    image, meta = ret

    protocol = f"{meta['body_part']}__{meta['side']}__{meta['sequence']}"
    dir_out = Path(config["dir_root_output"], meta["patient"],
                   meta["visit_month"], protocol)
    dir_out.mkdir(exist_ok=True, parents=True)
    numpy_to_png(image, str(dir_out / "image.png"))

    keep = ("patient", "visit_month", "sequence", "body_part", "side",
            "pixel_spacing_0", "pixel_spacing_1")
    return {k: meta[k] for k in keep}


def main(argv=None) -> None:
    """Prepare the baseline ROI PNGs (overrides ``key=value``). The app
    does no torch work and runs on any host."""
    import pandas as pd
    import yaml

    logging.basicConfig(level=logging.INFO)
    argv = list(sys.argv[1:] if argv is None else argv)
    config = {"dir_root_mipt_xr": None, "dir_root_output": None,
              "num_threads": 1, "debug": False, "ignore_cache": False}
    for ov in argv:
        k, v = ov.split("=", 1)
        config[k] = yaml.safe_load(v)
    for k in ("dir_root_mipt_xr", "dir_root_output"):
        if not config[k]:
            raise SystemExit(f"Missing required override: {k}=...")

    path_df_images = Path(config["dir_root_output"], "meta_images.csv")
    if path_df_images.exists() and not config["ignore_cache"]:
        logger.info("Loading from the cache")
        df_images = pd.read_csv(path_df_images)
    else:
        paths = sorted(str(p) for p in Path(config["dir_root_mipt_xr"]).glob("*"))
        logger.warning(f"Scans before baseline selection: {len(paths)}")
        paths = [p for p in paths if "_00_" in p.split("/")[-1]]
        logger.warning(f"Scans after baseline selection: {len(paths)}")

        if int(config["num_threads"]) == 1:
            metas = [handle_series(config, p) for p in paths]
        else:
            with ThreadPoolExecutor(int(config["num_threads"])) as pool:
                metas = list(pool.map(lambda p: handle_series(config, p),
                                      paths))
        rows = [m for m in metas if m is not None]
        df_images = pd.DataFrame(rows)
        Path(config["dir_root_output"]).mkdir(parents=True, exist_ok=True)
        df_images.to_csv(path_df_images, index=False)

    df_out = df_images.sort_values(
        by=["patient", "visit_month", "side", "sequence"])
    df_out.to_csv(Path(config["dir_root_output"], "meta_base.csv"),
                  index=False)
    logger.info(f"Wrote {len(df_out)} rows")


if __name__ == "__main__":
    main()
