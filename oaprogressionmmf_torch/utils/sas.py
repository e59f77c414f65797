"""SAS7BDAT ingestion (+ a minimal writer for fixtures).

The port's copy of ``oaprogressionmmf_tpu/utils/sas.py``; pandas is
imported inside the reader, so the module imports where pandas is not
installed. The reference consumes raw OAI releases as ``.sas7bdat`` tables
(the prior-art label script and the targets notebook):

* :func:`read_sas_table` — reads a ``.sas7bdat`` into a DataFrame with
  decoded strings, via pandas' SAS7BDAT parser.
* :func:`write_sas7bdat` — a small pure-Python writer for the uncompressed
  little-endian 32-bit subset of the format, used to build synthetic OAI
  release fixtures (the same bytes as the JAX package's writer). Follows
  the public format description (BioStatMatt / Shotwell ``sas7bdat.pdf``
  vignette).
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

__all__ = ["read_sas_table", "write_sas7bdat"]


def read_sas_table(path) -> pd.DataFrame:
    """Read a .sas7bdat table; bytes columns are decoded to str.

    Matches what the reference's `SAS7BDAT(...).to_data_frame()` produced:
    float64 numerics and python-str characters (empty string → NaN is NOT
    applied here; pandas already maps blank character values to NaN when
    `blank_missing`, which mirrors SAS missing semantics).
    """
    import pandas as pd

    df = pd.read_sas(str(path), format="sas7bdat", encoding="infer")
    # unknown encoding byte → pandas leaves bytes; decode as latin-1
    for col in df.columns:
        if df[col].dtype == object:
            df[col] = df[col].map(
                lambda v: v.decode("latin-1") if isinstance(v, bytes) else v)
    return df


# ---------------------------------------------------------------------------
# writer (uncompressed, little-endian, 32-bit layout)
# ---------------------------------------------------------------------------

_MAGIC = (b"\x00\x00\x00\x00\x00\x00\x00\x00"
          b"\x00\x00\x00\x00\xc2\xea\x81\x60"
          b"\xb3\x14\x11\xcf\xbd\x92\x08\x00"
          b"\x09\xc7\x31\x8c\x18\x1f\x10\x11")
_HEADER_SIZE = 1024
_PAGE_BIT_OFFSET = 16           # 32-bit layout
_POINTER_LEN = 12
_SIG_ROWSIZE = b"\xf7\xf7\xf7\xf7"
_SIG_COLSIZE = b"\xf6\xf6\xf6\xf6"
_SIG_COLTEXT = b"\xfd\xff\xff\xff"
_SIG_COLNAME = b"\xff\xff\xff\xff"
_SIG_COLATTR = b"\xfc\xff\xff\xff"
_SIG_FORMAT = b"\xfe\xfb\xff\xff"
_SAS_EPOCH_SECONDS = 2_000_000_000.0  # fixed timestamp (determinism)


def _column_specs(df: pd.DataFrame):
    """(name, ctype, width, values) per column; numerics→f64, strings→
    fixed-width latin-1 bytes."""
    specs = []
    for name in df.columns:
        s = df[name]
        if s.dtype == object or str(s.dtype).startswith(("str", "string")):
            vals = ["" if v is None or (isinstance(v, float) and np.isnan(v))
                    else str(v) for v in s.tolist()]
            raw = [v.encode("latin-1") for v in vals]
            width = max([len(r) for r in raw] + [1])
            specs.append((str(name), "s", width, raw))
        else:
            vals = np.asarray(s, dtype=np.float64)
            specs.append((str(name), "d", 8, vals))
    return specs


def write_sas7bdat(df: pd.DataFrame, path, dataset_name: str | None = None
                   ) -> Path:
    """Write `df` as an uncompressed little-endian 32-bit .sas7bdat.

    Supports float64 (any numeric dtype is cast) and string columns —
    exactly the subset the OAI releases use. Readable by pandas.read_sas
    and any conformant reader.
    """
    path = Path(path)
    if dataset_name is None:
        dataset_name = path.stem.upper()[:64]
    specs = _column_specs(df)
    ncols = len(specs)
    if ncols == 0:
        raise ValueError("cannot write a table with no columns")
    nrows = len(df)

    # row layout: doubles first (8-aligned), then fixed-width strings
    offsets = {}
    pos = 0
    for name, ctype, width, _ in specs:
        if ctype == "d":
            offsets[name] = pos
            pos += 8
    for name, ctype, width, _ in specs:
        if ctype == "s":
            offsets[name] = pos
            pos += width
    row_length = max(pos, 1)

    # --- column-text blob: all names back to back (offsets relative to
    # the blob start, which is the u16 size field itself) ---
    blob = bytearray(b"\x00\x00\x00\x00")      # size u16 + 2 pad
    name_spans = []
    for name, _, _, _ in specs:
        nb = name.encode("latin-1")
        name_spans.append((len(blob), len(nb)))
        blob += nb
    struct.pack_into("<H", blob, 0, len(blob))

    # --- subheaders ---
    def u32(x):
        return struct.pack("<I", x)

    sh_rowsize = bytearray(480)
    sh_rowsize[0:4] = _SIG_ROWSIZE
    struct.pack_into("<I", sh_rowsize, 5 * 4, row_length)
    struct.pack_into("<I", sh_rowsize, 6 * 4, nrows)
    struct.pack_into("<I", sh_rowsize, 9 * 4, ncols)    # col_count_p1
    struct.pack_into("<I", sh_rowsize, 10 * 4, 0)       # col_count_p2
    struct.pack_into("<I", sh_rowsize, 15 * 4, 0)       # rows on mix page
    struct.pack_into("<H", sh_rowsize, 354, 0)          # lcs
    struct.pack_into("<H", sh_rowsize, 378, 0)          # lcp

    sh_colsize = _SIG_COLSIZE + u32(ncols) + b"\x00" * 4

    sh_coltext = bytearray(_SIG_COLTEXT) + blob

    sh_colname = bytearray(8 * ncols + 20)
    sh_colname[0:4] = _SIG_COLNAME
    for i, (off, ln) in enumerate(name_spans):
        base = 4 + 8 * (i + 1)                 # after sig + 8-byte header
        struct.pack_into("<H", sh_colname, base + 0, 0)      # text idx
        struct.pack_into("<H", sh_colname, base + 2, off)
        struct.pack_into("<H", sh_colname, base + 4, ln)

    sh_colattr = bytearray(12 * ncols + 20)
    sh_colattr[0:4] = _SIG_COLATTR
    for i, (name, ctype, width, _) in enumerate(specs):
        struct.pack_into("<I", sh_colattr, 12 + 12 * i, offsets[name])
        struct.pack_into("<I", sh_colattr, 16 + 12 * i, width)
        sh_colattr[22 + 12 * i] = 1 if ctype == "d" else 2

    sh_formats = []
    for _ in specs:
        sh = bytearray(52)
        sh[0:4] = _SIG_FORMAT
        # all-zero format/label pointers → empty format, empty label
        sh_formats.append(sh)

    subheaders = [bytes(sh_rowsize), bytes(sh_colsize), bytes(sh_coltext),
                  bytes(sh_colname), bytes(sh_colattr)] + \
                 [bytes(sh) for sh in sh_formats]

    # --- page sizing ---
    meta_needed = (_PAGE_BIT_OFFSET + 8 + _POINTER_LEN * len(subheaders)
                   + sum(len(s) for s in subheaders))
    data_needed = _PAGE_BIT_OFFSET + 8 + row_length
    page_size = 4096
    while page_size < max(meta_needed, data_needed):
        page_size *= 2

    # --- meta page: pointers up front, subheader bodies at the tail ---
    meta = bytearray(page_size)
    struct.pack_into("<H", meta, _PAGE_BIT_OFFSET + 0, 0x0000)   # meta type
    struct.pack_into("<H", meta, _PAGE_BIT_OFFSET + 2, len(subheaders))
    struct.pack_into("<H", meta, _PAGE_BIT_OFFSET + 4, len(subheaders))
    tail = page_size
    for i, sh in enumerate(subheaders):
        tail -= len(sh)
        meta[tail:tail + len(sh)] = sh
        pbase = _PAGE_BIT_OFFSET + 8 + _POINTER_LEN * i
        struct.pack_into("<I", meta, pbase + 0, tail)
        struct.pack_into("<I", meta, pbase + 4, len(sh))
        meta[pbase + 8] = 0                                      # uncompressed
        meta[pbase + 9] = 0

    # --- data pages ---
    rows_per_page = max(1, (page_size - _PAGE_BIT_OFFSET - 8) // row_length)
    row_bufs = []
    for r in range(nrows):
        row = bytearray(b"\x20" * row_length)
        for name, ctype, width, vals in specs:
            off = offsets[name]
            if ctype == "d":
                struct.pack_into("<d", row, off, float(vals[r]))
            else:
                sval = vals[r][:width]
                row[off:off + width] = sval.ljust(width, b"\x20")
        row_bufs.append(bytes(row))

    data_pages = []
    for start in range(0, nrows, rows_per_page):
        chunk = row_bufs[start:start + rows_per_page]
        page = bytearray(page_size)
        struct.pack_into("<H", page, _PAGE_BIT_OFFSET + 0, 0x0100)  # data
        struct.pack_into("<H", page, _PAGE_BIT_OFFSET + 2, len(chunk))
        struct.pack_into("<H", page, _PAGE_BIT_OFFSET + 4, 0)
        at = _PAGE_BIT_OFFSET + 8
        for row in chunk:
            page[at:at + row_length] = row
            at += row_length
        data_pages.append(bytes(page))
    if nrows == 0:
        data_pages.append(bytes(bytearray(page_size)))  # empty trailing page

    # --- header ---
    hdr = bytearray(_HEADER_SIZE)
    hdr[0:32] = _MAGIC
    hdr[32] = 0x22              # not '3' → 32-bit layout, align2=0
    hdr[35] = 0x22              # not '3' → align1=0
    hdr[37] = 0x01              # little endian
    hdr[39] = ord("1")          # unix
    hdr[70] = 20                # utf-8
    hdr[84:92] = b"SAS FILE"
    hdr[92:156] = dataset_name.encode("latin-1")[:64].ljust(64, b"\x20")
    hdr[156:164] = b"DATA".ljust(8, b"\x20")
    struct.pack_into("<d", hdr, 164, _SAS_EPOCH_SECONDS)   # created
    struct.pack_into("<d", hdr, 172, _SAS_EPOCH_SECONDS)   # modified
    struct.pack_into("<I", hdr, 196, _HEADER_SIZE)
    struct.pack_into("<I", hdr, 200, page_size)
    struct.pack_into("<I", hdr, 204, 1 + len(data_pages))
    hdr[216:224] = b"9.0401M2"
    hdr[224:240] = b"X64_SRV12".ljust(16, b"\x20")
    hdr[240:256] = b"6.2".ljust(16, b"\x20")
    hdr[256:272] = b"OAPROG".ljust(16, b"\x20")
    hdr[272:288] = b"Linux".ljust(16, b"\x20")

    with open(path, "wb") as fh:
        fh.write(bytes(hdr))
        fh.write(bytes(meta))
        for page in data_pages:
            fh.write(page)
    return path
