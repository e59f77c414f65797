"""Minimal pure-Python DICOM (part-10) reader/writer.

The port's copy of ``oaprogressionmmf_tpu/utils/dicom.py`` (pure Python and
numpy; files written by either package read equal in the other). The
subset of DICOM the OAI distribution uses is small: single-frame,
uncompressed, little-endian MR images. This module implements exactly that
subset:

  * part-10 files (128-byte preamble + "DICM") and bare datasets,
  * implicit VR little endian (1.2.840.10008.1.2) and
    explicit VR little endian (1.2.840.10008.1.2.1),
  * value decoding for the text/numeric VRs the prep pipeline consumes,
  * `pixel_array` from Rows/Columns/BitsAllocated/PixelRepresentation,
  * a writer for the same subset (used for test fixtures and round-trips).
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

IMPLICIT_VR_LE = "1.2.840.10008.1.2"
EXPLICIT_VR_LE = "1.2.840.10008.1.2.1"

# VRs with 2-byte reserved + 4-byte length in explicit encoding
_LONG_VRS = {"OB", "OW", "OF", "SQ", "UT", "UN"}

# tag → (VR, keyword) for everything the prep apps touch; implicit-VR files
# are decoded through this table
TAG_DICT = {
    (0x0008, 0x0016): ("UI", "SOPClassUID"),
    (0x0008, 0x0018): ("UI", "SOPInstanceUID"),
    (0x0008, 0x0060): ("CS", "Modality"),
    (0x0008, 0x103E): ("LO", "SeriesDescription"),
    (0x0010, 0x0020): ("LO", "PatientID"),
    (0x0018, 0x0015): ("CS", "BodyPartExamined"),
    (0x0018, 0x0050): ("DS", "SliceThickness"),
    (0x0018, 0x0080): ("DS", "RepetitionTime"),
    (0x0018, 0x0081): ("DS", "EchoTime"),
    (0x0018, 0x0086): ("IS", "EchoNumbers"),
    (0x0018, 0x1164): ("DS", "ImagerPixelSpacing"),
    (0x0020, 0x000D): ("UI", "StudyInstanceUID"),
    (0x0020, 0x000E): ("UI", "SeriesInstanceUID"),
    (0x0020, 0x0011): ("IS", "SeriesNumber"),
    (0x0020, 0x0013): ("IS", "InstanceNumber"),
    (0x0020, 0x0032): ("DS", "ImagePositionPatient"),
    (0x0020, 0x0037): ("DS", "ImageOrientationPatient"),
    (0x0020, 0x1041): ("DS", "SliceLocation"),
    (0x0028, 0x0002): ("US", "SamplesPerPixel"),
    (0x0028, 0x0004): ("CS", "PhotometricInterpretation"),
    (0x0028, 0x0010): ("US", "Rows"),
    (0x0028, 0x0011): ("US", "Columns"),
    (0x0028, 0x0030): ("DS", "PixelSpacing"),
    (0x0028, 0x0100): ("US", "BitsAllocated"),
    (0x0028, 0x0101): ("US", "BitsStored"),
    (0x0028, 0x0102): ("US", "HighBit"),
    (0x0028, 0x0103): ("US", "PixelRepresentation"),
    (0x0028, 0x1052): ("DS", "RescaleIntercept"),
    (0x0028, 0x1053): ("DS", "RescaleSlope"),
    (0x7FE0, 0x0010): ("OW", "PixelData"),
}
_KEYWORD_TO_TAG = {kw: tag for tag, (_, kw) in TAG_DICT.items()}
_TAG_TO_VR = {tag: vr for tag, (vr, _) in TAG_DICT.items()}

_TEXT_VRS = {"AE", "AS", "CS", "DA", "DT", "LO", "LT", "PN", "SH", "ST",
             "TM", "UC", "UI", "UR", "UT"}


def _decode_value(vr: str, raw: bytes):
    if vr in _TEXT_VRS:
        text = raw.decode("ascii", errors="replace").rstrip("\x00 ")
        return text
    if vr == "DS":
        vals = [float(v) for v in
                raw.decode("ascii", errors="replace").strip("\x00 ").split("\\")
                if v.strip()]
        return vals[0] if len(vals) == 1 else vals
    if vr == "IS":
        vals = [int(v) for v in
                raw.decode("ascii", errors="replace").strip("\x00 ").split("\\")
                if v.strip()]
        return vals[0] if len(vals) == 1 else vals
    if vr == "US":
        vals = list(struct.unpack(f"<{len(raw) // 2}H", raw))
        return vals[0] if len(vals) == 1 else vals
    if vr == "UL":
        vals = list(struct.unpack(f"<{len(raw) // 4}I", raw))
        return vals[0] if len(vals) == 1 else vals
    if vr == "SS":
        vals = list(struct.unpack(f"<{len(raw) // 2}h", raw))
        return vals[0] if len(vals) == 1 else vals
    if vr == "SL":
        vals = list(struct.unpack(f"<{len(raw) // 4}i", raw))
        return vals[0] if len(vals) == 1 else vals
    if vr == "FL":
        vals = list(struct.unpack(f"<{len(raw) // 4}f", raw))
        return vals[0] if len(vals) == 1 else vals
    if vr == "FD":
        vals = list(struct.unpack(f"<{len(raw) // 8}d", raw))
        return vals[0] if len(vals) == 1 else vals
    return raw  # OB/OW/UN: raw bytes


class DicomDataset:
    """Parsed dataset with pydicom-style attribute access."""

    def __init__(self, elements: dict):
        self._elements = elements  # (group, elem) → decoded value

    def __contains__(self, keyword: str) -> bool:
        tag = _KEYWORD_TO_TAG.get(keyword)
        return tag is not None and tag in self._elements

    def __getattr__(self, keyword: str):
        tag = _KEYWORD_TO_TAG.get(keyword)
        if tag is None or tag not in self._elements:
            raise AttributeError(keyword)
        return self._elements[tag]

    def get(self, keyword: str, default=None):
        try:
            return getattr(self, keyword)
        except AttributeError:
            return default

    def __getitem__(self, tag: tuple):
        return self._elements[tag]

    @property
    def pixel_array(self) -> np.ndarray:
        raw = self._elements.get((0x7FE0, 0x0010))
        if raw is None:
            raise AttributeError("No PixelData in dataset")
        bits = int(self.get("BitsAllocated", 16))
        signed = int(self.get("PixelRepresentation", 0)) == 1
        dtype = {8: (np.int8 if signed else np.uint8),
                 16: (np.int16 if signed else np.uint16)}[bits]
        rows = int(self.Rows)
        cols = int(self.Columns)
        arr = np.frombuffer(raw, dtype=dtype, count=rows * cols)
        return arr.reshape(rows, cols)


def _parse_elements(buf: bytes, offset: int, explicit: bool,
                    stop_before_pixels: bool = False) -> dict:
    elements = {}
    n = len(buf)
    while offset + 8 <= n:
        group, elem = struct.unpack_from("<HH", buf, offset)
        offset += 4
        if explicit:
            vr = buf[offset:offset + 2].decode("ascii", errors="replace")
            if vr in _LONG_VRS:
                length = struct.unpack_from("<I", buf, offset + 4)[0]
                offset += 8
            else:
                length = struct.unpack_from("<H", buf, offset + 2)[0]
                offset += 4
        else:
            vr = _TAG_TO_VR.get((group, elem), "UN")
            length = struct.unpack_from("<I", buf, offset)[0]
            offset += 4
        if length == 0xFFFFFFFF:
            raise ValueError("Undefined-length elements are not supported "
                             "(compressed transfer syntaxes)")
        tag = (group, elem)
        if tag == (0x7FE0, 0x0010) and stop_before_pixels:
            break
        raw = buf[offset:offset + length]
        offset += length
        elements[tag] = _decode_value(vr, raw)
    return elements


def dcmread(path, stop_before_pixels: bool = False) -> DicomDataset:
    """Read a part-10 (or bare implicit-VR-LE) DICOM file."""
    buf = Path(path).read_bytes()

    if len(buf) > 132 and buf[128:132] == b"DICM":
        # file meta: always explicit VR LE, group 0002 only
        offset = 132
        meta_elements = {}
        while offset + 8 <= len(buf):
            group, elem = struct.unpack_from("<HH", buf, offset)
            if group != 0x0002:
                break
            vr = buf[offset + 4:offset + 6].decode("ascii", "replace")
            if vr in _LONG_VRS:
                length = struct.unpack_from("<I", buf, offset + 8)[0]
                body = offset + 12
            else:
                length = struct.unpack_from("<H", buf, offset + 6)[0]
                body = offset + 8
            meta_elements[(group, elem)] = _decode_value(
                vr if vr.isalpha() else "UN", buf[body:body + length])
            offset = body + length
        ts = meta_elements.get((0x0002, 0x0010), EXPLICIT_VR_LE)
        if isinstance(ts, bytes):
            ts = ts.decode("ascii", "replace").rstrip("\x00 ")
        if ts == IMPLICIT_VR_LE:
            explicit = False
        elif ts == EXPLICIT_VR_LE:
            explicit = True
        else:
            raise ValueError(f"Unsupported transfer syntax: {ts}")
        return DicomDataset(_parse_elements(buf, offset, explicit,
                                            stop_before_pixels))
    # bare dataset: assume implicit VR LE
    return DicomDataset(_parse_elements(buf, 0, False, stop_before_pixels))


# ---------------------------------------------------------------------------
# Writer (fixture/round-trip support)
# ---------------------------------------------------------------------------

def _encode_value(vr: str, value) -> bytes:
    if vr in _TEXT_VRS:
        raw = str(value).encode("ascii")
    elif vr in ("DS", "IS"):
        if isinstance(value, (list, tuple)):
            raw = "\\".join(str(v) for v in value).encode("ascii")
        else:
            raw = str(value).encode("ascii")
    elif vr == "US":
        vals = value if isinstance(value, (list, tuple)) else [value]
        raw = struct.pack(f"<{len(vals)}H", *[int(v) for v in vals])
    elif vr == "UL":
        vals = value if isinstance(value, (list, tuple)) else [value]
        raw = struct.pack(f"<{len(vals)}I", *[int(v) for v in vals])
    elif vr in ("OW", "OB", "UN"):
        raw = bytes(value)
    else:
        raise ValueError(f"Unsupported VR for writing: {vr}")
    if len(raw) % 2:
        raw += b"\x00" if vr not in _TEXT_VRS else b" "
    return raw


def dcmwrite(path, elements: dict, explicit: bool = True) -> None:
    """Write {keyword: value} as a part-10 explicit/implicit VR LE file."""
    tagged = []
    for kw, value in elements.items():
        tag = _KEYWORD_TO_TAG[kw]
        tagged.append((tag, _TAG_TO_VR[tag], value))
    tagged.sort(key=lambda t: t[0])

    body = bytearray()
    for (group, elem), vr, value in tagged:
        raw = _encode_value(vr, value)
        body += struct.pack("<HH", group, elem)
        if explicit:
            if vr in _LONG_VRS:
                body += vr.encode() + b"\x00\x00" + struct.pack("<I", len(raw))
            else:
                body += vr.encode() + struct.pack("<H", len(raw))
        else:
            body += struct.pack("<I", len(raw))
        body += raw

    ts = EXPLICIT_VR_LE if explicit else IMPLICIT_VR_LE
    meta = bytearray()
    for (group, elem), vr, value in [
        ((0x0002, 0x0010), "UI", ts),
    ]:
        raw = _encode_value(vr, value)
        meta += struct.pack("<HH", group, elem)
        meta += vr.encode() + struct.pack("<H", len(raw))
        meta += raw

    out = b"\x00" * 128 + b"DICM" + bytes(meta) + bytes(body)
    Path(path).write_bytes(out)
