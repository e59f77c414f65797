"""The port's SAS codec, prior-art cohort and targets app (utils/sas.py,
prior_art/tiulpin2019.py, run/prepare_targets_oai.py) against the JAX
package's, on the fixtures of tests/test_sas.py and
tests/test_prepare_targets.py: SAS files written by either package are the
same bytes and read equal in the other, and every frame equals JAX's.
"""

import itertools

import numpy as np
import pandas as pd
import pytest
import torch

from oaprogressionmmf_tpu.prior_art import tiulpin2019 as jax_tiulpin
from oaprogressionmmf_tpu.run import prepare_targets_oai as jax_targets
from oaprogressionmmf_tpu.utils import dicom as jax_dicom
from oaprogressionmmf_tpu.utils import sas as jax_sas
from oaprogressionmmf_torch import prior_art
from oaprogressionmmf_torch.prior_art import tiulpin2019
from oaprogressionmmf_torch.run import prepare_targets_oai as targets
from oaprogressionmmf_torch.utils import dicom as D
from oaprogressionmmf_torch.utils import sas
from test_torch_port_dicom_prep import write_unreadable

SAS = {"port": sas, "jax": jax_sas}


def frame():
    return pd.DataFrame({
        "ID": [9000001.0, 9000002.0, 9000003.0],
        "SIDE": [1.0, 2.0, 1.0],
        "V00XRKL": [0.0, 3.0, np.nan],
        "VERSION": ["V00", "V01", "V99"],
        "NOTE": ["hello", "", "a longer string"],
    })


@pytest.mark.parametrize("writer,reader", list(itertools.product(SAS, SAS)))
def test_sas_roundtrip_across_packages(tmp_path, writer, reader):
    df = frame()
    p = SAS[writer].write_sas7bdat(df, tmp_path / "t.sas7bdat")
    out = SAS[reader].read_sas_table(p)
    pd.testing.assert_frame_equal(out, jax_sas.read_sas_table(p))
    assert list(out.columns) == list(df.columns)
    np.testing.assert_allclose(out["ID"], df["ID"])
    assert np.isnan(out["V00XRKL"].iloc[2])
    assert out["VERSION"].tolist() == ["V00", "V01", "V99"]
    assert out["NOTE"].iloc[2] == "a longer string"
    assert pd.isna(out["NOTE"].iloc[1])   # SAS blank character == missing


@pytest.mark.parametrize("n", [3, 2000])
def test_sas_files_are_the_same_bytes(tmp_path, n):
    """More rows than one page holds exercises the page chain."""
    rng = np.random.RandomState(0)
    df = (frame() if n == 3 else
          pd.DataFrame({"X": rng.randn(n),
                        "LABEL": [f"row{i:04d}" for i in range(n)]}))
    a = sas.write_sas7bdat(df, tmp_path / "port.sas7bdat",
                           dataset_name="KXR")
    b = jax_sas.write_sas7bdat(df, tmp_path / "jax.sas7bdat",
                               dataset_name="KXR")
    assert a.read_bytes() == b.read_bytes()
    pd.testing.assert_frame_equal(sas.read_sas_table(a),
                                  jax_sas.read_sas_table(b))


def test_write_sas7bdat_rejects_empty(tmp_path):
    with pytest.raises(ValueError, match="no columns"):
        sas.write_sas7bdat(pd.DataFrame(), tmp_path / "x.sas7bdat")


# -- the fixtures of tests/test_sas.py --

TRAJ = {
    (1, 1): [1, 1, 2, 2, 3, 3],    # progressor at 2nd follow-up
    (1, 2): [0, 0, 0, 0, 0, 0],    # non-progressor, present at last
    (2, 1): [2, 2, 2, 2, 2, 2],    # non-progressor
    (2, 2): [3, 3, 3, 9, 9, 9],    # TKR (coded out-of-range)
    (3, 1): [4, 4, 4, 4, 4, 4],    # KL4 at baseline -> excluded
    (3, 2): [1, 2, 2, 2, 2, 2],    # early progressor
}


def write_kxr_tables(dirpath, codes, as_sas=True):
    for ci, code in enumerate(codes):
        rows = []
        for (pid, side), kls in TRAJ.items():
            kl = kls[min(ci, len(kls) - 1)]
            rows.append({"ID": float(9000000 + pid), "SIDE": float(side),
                         f"V{code}XRKL": float(kl)})
        t = pd.DataFrame(rows)
        if as_sas:
            sas.write_sas7bdat(t, dirpath / f"kxr_sq_bu{code}.sas7bdat")
        else:
            t.to_csv(dirpath / f"kxr_sq_bu{code}.csv", index=False)


def write_clinical_sas(d):
    ids = sorted({pid for pid, _ in TRAJ})
    clin = pd.DataFrame({
        "ID": [float(9000000 + pid) for pid in ids],
        "V00AGE": [61.0, 55.0, 70.0], "P01BMI": [27.5, 31.0, 24.2],
        "V00WOMTSL": [5.0, 12.0, 3.0], "V00WOMTSR": [4.0, 10.0, 2.0],
        "V00WOMADLL": [3.0, 8.0, 1.0], "V00WOMADLR": [2.0, 7.0, 1.0],
        "V00WOMKPL": [1.0, 3.0, 0.0], "V00WOMKPR": [1.0, 2.0, 0.0],
        "V00WOMSTFL": [1.0, 1.0, 2.0], "V00WOMSTFR": [1.0, 1.0, 1.0],
        "P01INJL": [0.0, 1.0, 0.0], "P01INJR": [0.0, 0.0, 0.0],
        "P01KSURGL": [0.0, 0.0, 0.0], "P01KSURGR": [0.0, 1.0, 0.0],
    })
    sas.write_sas7bdat(clin, d / "allclinical00.sas7bdat")
    enr = pd.DataFrame({
        "ID": [float(9000000 + pid) for pid in ids],
        "P02SEX": [1.0, 2.0, 1.0], "P02RACE": [1.0, 1.0, 2.0],
        "V00SITE": ["A", "B", "D"]})
    sas.write_sas7bdat(enr, d / "enrollees.sas7bdat")


@pytest.mark.parametrize("as_sas", [True, False])
def test_img_progression_meta_equals_jax(tmp_path, as_sas):
    write_kxr_tables(tmp_path, tiulpin2019.EXAM_CODES, as_sas=as_sas)
    got = tiulpin2019.build_img_progression_meta(tmp_path)
    pd.testing.assert_frame_equal(
        got, jax_tiulpin.build_img_progression_meta(tmp_path))
    assert len(got) > 0
    assert not ((got.ID == 9000003) & (got.Side == "R")).any()


def test_img_progression_meta_csv_cases_equal_jax(tmp_path):
    """tests/test_analysis_priorart.py's fixtures: early, late (TKR) and
    non-progressors, a KL4 baseline; KL0 → KL1 never counts."""
    def kxr(d, code, rows):
        d.mkdir(exist_ok=True)
        pd.DataFrame(rows, columns=["ID", "SIDE", f"V{code}XRKL"]).to_csv(
            d / f"kxr_sq_bu{code}.csv", index=False)
    a, b = tmp_path / "a", tmp_path / "b"
    kxr(a, "00", [(1, 1, 1), (2, 1, 1), (3, 1, 0), (4, 1, 4)])
    for code in ("01", "03", "05", "08"):
        kxr(a, code, [(1, 1, 2), (2, 1, 1), (3, 1, 0)])
    kxr(a, "10", [(1, 1, 2), (2, 1, 1), (3, 1, None)])
    kxr(b, "00", [(1, 1, 0)])
    for code in ("01", "03", "05", "08", "10"):
        kxr(b, code, [(1, 1, 1)])
    for d in (a, b):
        pd.testing.assert_frame_equal(
            prior_art.build_img_progression_meta(d),
            jax_tiulpin.build_img_progression_meta(d))
    out = prior_art.build_img_progression_meta(a).set_index("ID")
    assert out.loc[3, "Progressor"] == 2 and out.loc[3, "Prog_increase"] == 5


@pytest.mark.parametrize("as_sas", [True, False])
def test_build_clinical_equals_jax(tmp_path, as_sas):
    if as_sas:
        write_clinical_sas(tmp_path)
    else:
        pd.DataFrame({"ID": [1, 2], "P02SEX": [1, 2]}).to_csv(
            tmp_path / "enrollees.csv", index=False)
        pd.DataFrame({
            "ID": [1, 2], "V00AGE": [60, 70], "P01BMI": [25.0, 30.0],
            "P01INJL": [0, 1], "P01INJR": [1, 0],
            "P01KSURGL": [0, 0], "P01KSURGR": [0, 1],
            "V00WOMTSL": [5.0, 10.0], "V00WOMTSR": [6.0, 11.0],
        }).to_csv(tmp_path / "allclinical00.csv", index=False)
    got = prior_art.build_clinical(tmp_path)
    pd.testing.assert_frame_equal(got, jax_tiulpin.build_clinical(tmp_path))
    assert set(got.columns) == {"ID", "Side", "AGE", "SEX", "BMI", "INJ",
                                "SURG", "WOMAC"}


def test_meta_base_from_sas_equals_jax(tmp_path):
    write_kxr_tables(tmp_path, list(targets.SAS_EXAM_MONTHS), as_sas=True)
    write_clinical_sas(tmp_path)
    pd.testing.assert_frame_equal(targets.build_kl_long_from_sas(tmp_path),
                                  jax_targets.build_kl_long_from_sas(tmp_path))
    pd.testing.assert_frame_equal(
        targets.build_clin_base_from_sas(tmp_path),
        jax_targets.build_clin_base_from_sas(tmp_path))
    got = targets.build_meta_base_from_sas(tmp_path)
    pd.testing.assert_frame_equal(
        got, jax_targets.build_meta_base_from_sas(tmp_path))
    assert len(got) == 6
    row = got[(got.patient == "9000001") & (got.side == "RIGHT")].iloc[0]
    assert row["prog_kl_96"] == 1


# -- the fixtures of tests/test_prepare_targets.py --

def write_inputs(tmp_path):
    kl_rows = []
    for patient, side, traj in [
        ("9000001", "RIGHT", {0: 1, 12: 2, 24: 2, 36: 2, 48: 2, 72: 2, 96: 2}),
        ("9000002", "LEFT", {0: 2, 12: 2, 24: 2, 36: 2, 48: 2, 72: 2, 96: 2}),
        ("9000003", "RIGHT", {0: 4, 12: 4}),
    ]:
        for visit, kl in traj.items():
            kl_rows.append({"patient": patient, "side": side,
                            "visit": visit, "XRKL": kl})
    pd.DataFrame(kl_rows).to_csv(tmp_path / "kl_long.csv", index=False)
    clin_rows = [
        {"patient": p, "side": s, "P02SEX": "MALE", "V00SITE": "A",
         "AGE": 60, "P01BMI": 27.0, "XRKL": 1, "WOMTS-": 3.0,
         "P01INJ-": 0, "P01KSURG-": 0}
        for p, s in [("9000001", "RIGHT"), ("9000002", "LEFT"),
                     ("9000003", "RIGHT")]]
    pd.DataFrame(clin_rows).to_csv(tmp_path / "clin.csv", index=False)
    pd.DataFrame({"ID": [9000001], "Side": ["R"], "Progressor": [1],
                  "Prog_increase": [1]}).to_csv(
        tmp_path / "tiulpin.csv", index=False)


@pytest.mark.parametrize("tiulpin", [True, False])
def test_build_meta_base_equals_jax(tmp_path, tiulpin):
    write_inputs(tmp_path)
    args = (tmp_path / "kl_long.csv", tmp_path / "clin.csv",
            tmp_path / "tiulpin.csv" if tiulpin else None)
    got = targets.build_meta_base(*args)
    pd.testing.assert_frame_equal(got, jax_targets.build_meta_base(*args))
    got = got.set_index("patient")
    assert got.loc["9000003", "reason_kl_12"] == "1: KLG4_at_baseline"
    assert got.loc["9000001", "tiulpin2019_prog"] == (1 if tiulpin else -1)


def test_main_equals_jax(tmp_path):
    write_inputs(tmp_path)
    sas_dir = tmp_path / "sas"
    sas_dir.mkdir()
    write_kxr_tables(sas_dir, list(targets.SAS_EXAM_MONTHS), as_sas=True)
    write_clinical_sas(sas_dir)
    runs = {"csv": [f"path_kl_long={tmp_path / 'kl_long.csv'}",
                    f"path_clin_base={tmp_path / 'clin.csv'}",
                    f"path_tiulpin={tmp_path / 'tiulpin.csv'}"],
            "sas": [f"dir_oai_sas={sas_dir}"]}
    for name, argv in runs.items():
        for who, app in (("p", targets), ("j", jax_targets)):
            app.main(argv + [f"dir_root_output={tmp_path / name / who}"])
        assert ((tmp_path / name / "p" / "meta_base.csv").read_bytes()
                == (tmp_path / name / "j" / "meta_base.csv").read_bytes())
    with pytest.raises(SystemExit, match="Nothing to do"):
        targets.main([])


def test_build_scan_extract_equals_jax(tmp_path):
    def write_series(release, patient, barcode, series, dicom):
        d = tmp_path / "00m" / release / patient / "20050101" / barcode
        d.mkdir(parents=True)
        write_unreadable(d / "000_bad.dcm")   # sorts first: skipped
        dicom.dcmwrite(d / "001.dcm", {
            "PatientID": patient, "SeriesDescription": series,
            "Rows": 4, "Columns": 4, "BitsAllocated": 16,
            "PixelRepresentation": 0, "PixelSpacing": [0.36, 0.36],
            "SliceThickness": 0.7,
            "PixelData": np.zeros((4, 4), np.uint16).tobytes()})

    write_series("0.C.2", "9000001", "111", "SAG_3D_DESS_RIGHT", D)
    write_series("0.C.2", "9000001", "222", "COR_IW_TSE_RIGHT", jax_dicom)
    write_series("0.E.1", "9000002", "333", "SAG_3D_DESS_LEFT", jax_dicom)
    write_series("0.E.1", "9000003", "444", "SAG_T2_MAP_LEFT", D)
    for seq, patients in (("SAG_3D_DESS", None), ("COR_IW_TSE", None),
                          ("SAG_3D_DESS", ["9000002"])):
        got = targets.build_scan_extract(tmp_path, seq, patients=patients)
        pd.testing.assert_frame_equal(
            got, jax_targets.build_scan_extract(tmp_path, seq,
                                                patients=patients))
    assert len(targets.build_scan_extract(tmp_path, "SAG_3D_DESS")) == 2


@pytest.mark.parametrize("dry_run", [False, True])
def test_copy_scans_from_oai_equals_jax(tmp_path, dry_run):
    src = tmp_path / "OAIBaselineImages"
    series = src / "00m" / "0.E.1" / "9000001" / "20050101" / "12345"
    series.mkdir(parents=True)
    (series / "001").write_bytes(b"fake-dicom")
    df = pd.DataFrame([
        {"Folder": "0.E.1/9000001/20050101/12345", "visit_month": "000m",
         "ParticipantID": "9000001"},
        {"Folder": "0.E.1/9000002/20050101/99999", "visit_month": "000m",
         "ParticipantID": "9000002"},   # missing on disk
    ])
    got = targets.copy_scans_from_oai(src, tmp_path / "p", df,
                                      num_threads=2, dry_run=dry_run)
    want = jax_targets.copy_scans_from_oai(src, tmp_path / "j", df,
                                           num_threads=2, dry_run=dry_run)
    pd.testing.assert_frame_equal(got, want)
    copied = "00m/0.E.1/9000001/20050101/12345/001"
    for who in ("p", "j"):
        assert (tmp_path / who / copied).exists() != dry_run


def test_targets_main_raises_without_a_gpu(monkeypatch):
    """The app does no torch work: without a GPU it resolves no device and
    raises only for its own missing arguments, as on any host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="Nothing to do"):
        targets.main([])
