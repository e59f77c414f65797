"""The port's DICOM codec and prep apps (utils/dicom.py,
run/prepare_data_mri_oai.py, run/prepare_data_xr_oulu.py) against the JAX
package's, on the CPU over small synthetic series.

DICOM files written by either package read equal in the other;
``reorient_to`` equals JAX's for all 48 axis permutations and flips;
``handle_series`` of both packages over the same DESS, TSE (MONOCHROME1
too) and MESE series gives equal meta rows, DESS and TSE images with the
same bytes once inflated, and T2 maps within the T2 bar
(tests/test_torch_port_t2_fit.py: the maps are float32 in both but not
bit-equal); the X-ray app's ``main`` of both writes equal
``meta_images.csv`` and ``meta_base.csv``.
"""

import gzip
import itertools
import shutil
import struct

import numpy as np
import pandas as pd
import pytest
import torch

from oaprogressionmmf_tpu.run import prepare_data_mri_oai as jax_mri
from oaprogressionmmf_tpu.run import prepare_data_xr_oulu as jax_xr
from oaprogressionmmf_tpu.utils import dicom as jax_dicom
from oaprogressionmmf_torch.run import prepare_data_mri_oai as mri
from oaprogressionmmf_torch.run import prepare_data_xr_oulu as xr
from oaprogressionmmf_torch.utils import dicom as D
from oaprogressionmmf_torch.utils.formats import nifti_to_numpy, numpy_to_png
from test_torch_port_t2_fit import check_maps

PACKAGES = {"port": D, "jax": jax_dicom}


def write_slice(path, dicom=D, *, rows=8, cols=8, value=None,
                series="SAG_3D_DESS_RIGHT", instance=1, slice_loc=0.0,
                echo=1, echo_time=10.0, ipp=(0.0, 0.0, 0.0),
                iop=(0, 1, 0, 0, 0, -1), photometric="MONOCHROME2",
                explicit=True):
    pix = (np.full((rows, cols), instance, np.uint16) if value is None
           else value.astype(np.uint16))
    elements = {
        "PatientID": "9000001", "SeriesDescription": series,
        "Rows": rows, "Columns": cols, "BitsAllocated": 16,
        "PixelRepresentation": 0, "SamplesPerPixel": 1,
        "PixelSpacing": [0.36, 0.36], "SliceThickness": 0.7,
        "EchoNumbers": echo, "SliceLocation": slice_loc,
        "InstanceNumber": instance, "ImagePositionPatient": list(ipp),
        "ImageOrientationPatient": list(iop),
        "PhotometricInterpretation": photometric,
        "BodyPartExamined": "KNEE", "PixelData": pix.tobytes()}
    if echo_time is not None:
        elements["EchoTime"] = echo_time
    dicom.dcmwrite(path, elements, explicit=explicit)
    return pix


def write_unreadable(path):
    """A part-10 file in a compressed transfer syntax: both readers raise."""
    uid = b"1.2.840.10008.1.2.4.50"
    meta = struct.pack("<HH", 2, 0x10) + b"UI" + struct.pack("<H", len(uid))
    path.write_bytes(b"\x00" * 128 + b"DICM" + meta + uid)


# -- the codec --

@pytest.mark.parametrize("explicit", [True, False])
@pytest.mark.parametrize("writer,reader", list(itertools.product(
    PACKAGES, PACKAGES)))
def test_dicom_roundtrip_across_packages(tmp_path, explicit, writer,
                                         reader):
    value = np.random.RandomState(0).randint(0, 4000, (8, 8))
    pix = write_slice(tmp_path / "a.dcm", PACKAGES[writer], value=value,
                      explicit=explicit)
    ds = PACKAGES[reader].dcmread(tmp_path / "a.dcm")
    assert ds.PatientID == "9000001"
    assert ds.SeriesDescription == "SAG_3D_DESS_RIGHT"
    assert float(ds.SliceThickness) == pytest.approx(0.7)
    assert list(np.asarray(ds.PixelSpacing)) == pytest.approx([0.36, 0.36])
    assert ds.ImageOrientationPatient == [0, 1, 0, 0, 0, -1]
    assert ds.Rows == 8 and ds.EchoNumbers == 1
    assert "EchoTime" in ds and "RescaleSlope" not in ds
    np.testing.assert_array_equal(ds.pixel_array, pix)


def test_dicom_files_are_the_same_bytes(tmp_path):
    for explicit in (True, False):
        for name, pkg in PACKAGES.items():
            write_slice(tmp_path / f"{name}.dcm", pkg, explicit=explicit,
                        series="COR_IW_TSE_LEFT")
        assert ((tmp_path / "port.dcm").read_bytes()
                == (tmp_path / "jax.dcm").read_bytes())


def test_dicom_stop_before_pixels(tmp_path):
    write_slice(tmp_path / "a.dcm", jax_dicom)
    ds = D.dcmread(tmp_path / "a.dcm", stop_before_pixels=True)
    assert float(ds.SliceLocation) == 0.0
    assert ds.get("PixelData") is None
    with pytest.raises(AttributeError):
        _ = ds.pixel_array


def test_dicom_unreadable_raises_in_both(tmp_path):
    write_unreadable(tmp_path / "bad.dcm")
    for pkg in PACKAGES.values():
        with pytest.raises(ValueError, match="transfer syntax"):
            pkg.dcmread(tmp_path / "bad.dcm")


# -- the geometry --

SIGNED_AXES = [(axes, signs)
               for axes in itertools.permutations(range(3))
               for signs in itertools.product((1, -1), repeat=3)]


@pytest.mark.parametrize("axes,signs", SIGNED_AXES,
                         ids=[f"{a}{s}" for a, s in SIGNED_AXES])
def test_reorient_to_equals_jax(axes, signs):
    """Every assignment of the volume's axes to ±x, ±y, ±z (6 permutations
    × 8 flips), to both targets; the directions are tilted off the axes as
    real scanners are."""
    vol = np.arange(2 * 3 * 4, dtype=np.float64).reshape(2, 3, 4)
    tilt = np.array([[0.0, 0.1, -0.05], [0.08, 0.0, 0.1], [-0.1, 0.06, 0.0]])
    dirs = [np.eye(3)[a] * s + tilt[i] for i, (a, s) in
            enumerate(zip(axes, signs))]
    for target in ("IPR", "IRP"):
        got = mri.reorient_to(vol, dirs, target)
        want = jax_mri.reorient_to(vol, dirs, target)
        assert got.flags.c_contiguous
        np.testing.assert_array_equal(got, want)


# -- handle_series of both packages over the same series --

def dess_series(root, n_slices=20, size=40):
    # sagittal: row dir +y (P), col dir -z (I); normal row x col = -x (R)
    sdir = root / "0.C.2" / "9000001" / "20050101" / "12345"
    sdir.mkdir(parents=True)
    rng = np.random.RandomState(0)
    for i in range(n_slices):
        write_slice(sdir / f"{i:03d}.dcm", rows=size, cols=size,
                    value=rng.randint(0, 2000, (size, size)),
                    series="SAG_3D_DESS_RIGHT", instance=i + 1,
                    ipp=(-i * 0.7, 0.0, 0.0), iop=(0, 1, 0, 0, 0, -1))
    write_unreadable(sdir / "000_bad.dcm")   # sorts first: the sniff skips it
    return sdir


def tse_series(root, photometric, n_slices=6, size=40):
    # coronal: row dir -x (R), col dir -z (I); normal = -y (A); slices
    # written in reverse, implicit VR
    sdir = root / "1.C.2" / "9000002" / "20060101" / "54321"
    sdir.mkdir(parents=True)
    rng = np.random.RandomState(1)
    for i in reversed(range(n_slices)):
        write_slice(sdir / f"{i:03d}.dcm", rows=size, cols=size + 4,
                    value=rng.randint(0, 30000, (size, size + 4)),
                    series="COR_IW_TSE_LEFT", instance=i + 1,
                    ipp=(0.0, -3.0 * i, 0.0), iop=(-1, 0, 0, 0, 0, -1),
                    photometric=photometric, explicit=False)
    write_unreadable(sdir / "zzz_bad.dcm")
    return sdir


def mese_series(root, n_slices=3, n_echoes=7, size=40, nan_te_slice=1):
    sdir = root / "0.E.1" / "9000003" / "20050101" / "777"
    sdir.mkdir(parents=True)
    rng = np.random.RandomState(2)
    tes_ms = np.linspace(10, 70, n_echoes)
    t2 = rng.uniform(0.01, 0.09, (n_slices, size, size))
    t2[:, 18:22, :] = 0.1 + rng.uniform(-2e-4, 2e-4, (n_slices, 4, size))
    amp = rng.uniform(30000, 60000, (n_slices, size, size))
    for s in range(n_slices):
        for e in range(n_echoes):
            img = amp[s] * np.exp(-(tes_ms[e] / 1000.0) / t2[s])
            img = np.clip(np.rint(img + rng.normal(0, 1, img.shape)), 0,
                          65535)
            img[20:30, 5:15] = 0
            write_slice(sdir / f"s{s}_e{e}.dcm", rows=size, cols=size,
                        value=img, series="SAG_T2_MAP_LEFT",
                        instance=s * n_echoes + e + 1, slice_loc=float(s),
                        echo=e + 1, echo_time=(None if s == nan_te_slice
                                               and e == 3
                                               else float(tes_ms[e])))
    return sdir


def inflated(path):
    with gzip.open(path, "rb") as f:
        return f.read()


def test_handle_series_equals_jax(tmp_path):
    raw = tmp_path / "raw"
    series = [dess_series(raw), tse_series(raw, "MONOCHROME2"),
              mese_series(raw)]
    outs = {}
    for name, module, kw in (("port", mri, {"device": "cpu"}),
                             ("jax", jax_mri, {})):
        out = tmp_path / name
        metas = [module.handle_series({"dir_root_output": str(out)},
                                      str(s), **kw) for s in series]
        outs[name] = (out, metas)
    (out_p, metas_p), (out_j, metas_j) = outs["port"], outs["jax"]
    assert metas_p == metas_j
    assert [m["sequence"] for m in metas_p] == ["SAG_3D_DESS", "COR_IW_TSE",
                                                "SAG_T2_MAP"]
    rel = {}
    for meta in metas_p:
        sub = (f"{meta['patient']}/{meta['visit_month']}/KNEE__"
               f"{meta['side']}__{meta['sequence']}/image.nii.gz")
        if meta["sequence"] != "SAG_T2_MAP":
            assert inflated(out_p / sub) == inflated(out_j / sub)
            continue
        got, sp_p = nifti_to_numpy(out_p / sub, ras_to_ipr=True)
        want, sp_j = nifti_to_numpy(out_j / sub, ras_to_ipr=True)
        assert sp_p == sp_j and got.shape == want.shape == (8, 8, 3)
        # the header is equal; the map within the T2 bar (its stored
        # values are the 6-decimal rounding of each package's fit)
        assert inflated(out_p / sub)[:352] == inflated(out_j / sub)[:352]
        vol, tes = t2_inputs(series[2])
        rel = check_maps(to_fit_order(got), to_fit_order(want),
                         crop(vol), tes, rounded=True)
        assert np.count_nonzero(got) > 0.5 * got.size
    assert rel


def t2_inputs(sdir):
    vol, tes, _ = mri.assemble_4d_mese(sdir)
    return vol, tes


def crop(vol, margin=16):
    return vol[:, margin:-margin, margin:-margin]


def to_fit_order(ipr):
    """The prepared (rows, cols, slices) map back to the fit's (slices,
    rows, cols)."""
    return np.moveaxis(ipr, [2, 0, 1], [0, 1, 2])


def test_monochrome1_tse_equals_jax(tmp_path):
    sdir = tse_series(tmp_path / "raw", "MONOCHROME1")
    got = mri.dicom_series_to_numpy_meta(sdir)
    want = jax_mri.dicom_series_to_numpy_meta(sdir)
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[0], want[0])
    plain = mri.dicom_series_to_numpy_meta(
        tse_series(tmp_path / "raw2", "MONOCHROME2"))[0]
    np.testing.assert_array_equal(got[0], plain.max(initial=0) - plain)
    assert got[0].shape == (44, 40, 6)   # IRP: cols, rows, slices
    meta = mri.handle_series({"dir_root_output": str(tmp_path / "p")},
                             str(sdir), device="cpu")
    meta_j = jax_mri.handle_series({"dir_root_output": str(tmp_path / "j")},
                                   str(sdir))
    assert meta == meta_j
    sub = "9000002/012m/KNEE__LEFT__COR_IW_TSE/image.nii.gz"
    assert inflated(tmp_path / "p" / sub) == inflated(tmp_path / "j" / sub)
    img, _ = nifti_to_numpy(tmp_path / "p" / sub, ras_to_irp=True,
                            preserve_dtype=True)
    assert img.dtype == np.uint16 and img.shape == (44 - 32, 40 - 32, 6)


def test_t2_series_pieces_equal_jax(tmp_path):
    """The assembled MESE volume and its echo times equal JAX's (a slice
    without EchoTime gives NaN there, and that slice's map is 0); a series
    with an unreadable file is skipped by both."""
    sdir = mese_series(tmp_path / "raw")
    vol, tes, first = mri.assemble_4d_mese(sdir)
    vol_j, tes_j, first_j = jax_mri.assemble_4d_mese(sdir)
    np.testing.assert_array_equal(vol, vol_j)
    np.testing.assert_array_equal(tes, tes_j)
    assert np.isnan(tes[1, 3]) and np.isfinite(np.delete(tes, 1, 0)).all()
    assert first.SeriesDescription == first_j.SeriesDescription
    t2, meta = mri.dicom_series_to_t2_map_meta(sdir, device="cpu")
    t2_j, meta_j = jax_mri.dicom_series_to_t2_map_meta(sdir)
    assert meta == meta_j and t2.dtype == t2_j.dtype == np.float32
    assert not t2[:, :, 1].any() and not t2_j[:, :, 1].any()
    write_unreadable(sdir / "zz.dcm")
    assert mri.handle_series({"dir_root_output": str(tmp_path / "o")},
                             str(sdir), device="cpu") is None
    assert jax_mri.handle_series({"dir_root_output": str(tmp_path / "o")},
                                 str(sdir)) is None


def test_compress_equals_jax():
    rng = np.random.RandomState(5)
    for seq, hi in (("SAG_3D_DESS", 2040), ("COR_IW_TSE", 60000)):
        image = rng.randint(0, hi, (40, 40, 5)).astype(np.float64)
        got, _ = mri.preproc_compress_series(image, {"sequence": seq}, "p")
        want, _ = jax_mri.preproc_compress_series(image, {"sequence": seq},
                                                  "p")
        assert got.dtype == want.dtype and got.flags.c_contiguous
        np.testing.assert_array_equal(got, want)
    too_bright = np.full((40, 40, 2), 4000.0)
    with pytest.raises(ValueError, match="Out-of-range"):
        mri.preproc_compress_series(too_bright, {"sequence": "SAG_3D_DESS"},
                                    "p")


def test_mri_main_equals_jax(tmp_path):
    """``main`` of both over an extract CSV; the port's with two spawned
    worker processes, JAX's in one."""
    root = tmp_path / "raw"
    series = [dess_series(root / "00m"), tse_series(root / "00m",
                                                    "MONOCHROME2"),
              mese_series(root / "00m")]
    extract = tmp_path / "extract.csv"
    pd.DataFrame({"Folder": [str(s.relative_to(root / "00m"))
                             for s in series]}).to_csv(extract, index=False)
    argv = [f"dir_root_oai_mri={root}", f"path_csv_extract={extract}"]
    mri.main(argv + [f"dir_root_output={tmp_path / 'p'}", "num_threads=2"],
             device="cpu")
    jax_mri.main(argv + [f"dir_root_output={tmp_path / 'j'}"])
    assert ((tmp_path / "p" / "meta_images.csv").read_bytes()
            == (tmp_path / "j" / "meta_images.csv").read_bytes())
    df = pd.read_csv(tmp_path / "p" / "meta_images.csv")
    assert len(df) == 3
    # the cache: a second run leaves the index alone
    mri.main(argv + [f"dir_root_output={tmp_path / 'p'}"], device="cpu")


def test_prep_entry_points_raise_without_a_gpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sdir = dess_series(tmp_path / "raw")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mri.handle_series({"dir_root_output": str(tmp_path / "o")},
                          str(sdir))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mri.main([])
    assert not (tmp_path / "o").exists()
    # the X-ray app does no torch work: it resolves no device and raises
    # only for its own missing arguments
    with pytest.raises(SystemExit, match="Missing required override"):
        xr.main([])


# -- the X-ray app --

def test_xr_main_equals_jax(tmp_path):
    raw = tmp_path / "raw"
    raw.mkdir()
    rng = np.random.RandomState(2)
    for name in ("9000002_00_L.png", "9000001_00_R.png", "9000001_00_L.png",
                 "9000001_12_L.png", "9000003_00_R.png"):
        numpy_to_png((rng.rand(32, 24) * 255).astype(np.uint8), raw / name)
    (raw / "9000004_00_L.png").write_bytes(b"not a png")
    for name, app in (("p", xr), ("j", jax_xr)):
        app.main([f"dir_root_mipt_xr={raw}",
                  f"dir_root_output={tmp_path / name}", "num_threads=2"])
    for csv in ("meta_images.csv", "meta_base.csv"):
        assert ((tmp_path / "p" / csv).read_bytes()
                == (tmp_path / "j" / csv).read_bytes()), csv
    df = pd.read_csv(tmp_path / "p" / "meta_base.csv", dtype=str)
    assert len(df) == 4   # baseline visits only, the unreadable one skipped
    for _, row in df.iterrows():
        sub = f"{row.patient}/{row.visit_month}/KNEE__{row.side}__XR_PA"
        from PIL import Image
        got = np.asarray(Image.open(tmp_path / "p" / sub / "image.png"))
        want = np.asarray(Image.open(tmp_path / "j" / sub / "image.png"))
        np.testing.assert_array_equal(got, want)
    # from the cache: meta_base rebuilt from meta_images
    (tmp_path / "p" / "meta_base.csv").unlink()
    shutil.rmtree(raw)
    xr.main([f"dir_root_mipt_xr={raw}", f"dir_root_output={tmp_path / 'p'}"])
    assert ((tmp_path / "p" / "meta_base.csv").read_bytes()
            == (tmp_path / "j" / "meta_base.csv").read_bytes())
