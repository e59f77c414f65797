"""Medical-image readers: NIfTI-1 and grayscale PNG.

The port's copy of the reading half of ``oaprogressionmmf_tpu/utils/
formats.py``: a self-contained NIfTI-1 reader in numpy (``.nii`` and
``.nii.gz``, scalar dtypes, sform or pixdim affine, scl_slope/scl_inter),
the reference's RAS+ → IPR+/IRP+ axis remaps, and a PNG reader through PIL,
imported inside the function (the machine with the card has no PIL; the
data layer runs on the host that holds the data).
"""

from __future__ import annotations

import gzip
import struct

import numpy as np

_NIFTI_DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32, 64: np.float64,
    256: np.int8, 512: np.uint16, 768: np.uint32, 1024: np.int64,
    1280: np.uint64,
}
_HDR_SIZE = 348


def read_nifti(fname_in, preserve_dtype: bool = False):
    """Read a NIfTI-1 file → (data in RAS/native order, affine 4x4).

    By default float64 with scl_slope/scl_inter applied, in Fortran
    (column-major) axis order, as nibabel's ``get_fdata()``.
    ``preserve_dtype=True`` keeps the stored dtype when no intensity
    scaling is present."""
    opener = gzip.open if str(fname_in).endswith(".gz") else open
    with opener(str(fname_in), "rb") as f:
        raw = f.read()

    hdr = raw[:_HDR_SIZE]
    endian = "<"
    if struct.unpack_from("<i", hdr, 0)[0] != _HDR_SIZE:
        if struct.unpack_from(">i", hdr, 0)[0] != _HDR_SIZE:
            raise ValueError(f"Not a NIfTI-1 file: {fname_in}")
        endian = ">"

    dim = struct.unpack_from(endian + "8h", hdr, 40)
    datatype = struct.unpack_from(endian + "h", hdr, 70)[0]
    pixdim = struct.unpack_from(endian + "8f", hdr, 76)
    vox_offset = int(struct.unpack_from(endian + "f", hdr, 108)[0])
    scl_slope = struct.unpack_from(endian + "f", hdr, 112)[0]
    scl_inter = struct.unpack_from(endian + "f", hdr, 116)[0]
    sform_code = struct.unpack_from(endian + "h", hdr, 254)[0]
    srow = np.array([struct.unpack_from(endian + "4f", hdr, off)
                     for off in (280, 296, 312)], dtype=np.float64)

    shape = tuple(int(d) for d in dim[1:1 + dim[0]])
    if datatype not in _NIFTI_DTYPES:
        raise ValueError(f"Unsupported NIfTI datatype code: {datatype}")
    dtype = np.dtype(_NIFTI_DTYPES[datatype]).newbyteorder(endian)
    data = np.frombuffer(raw, dtype=dtype, count=int(np.prod(shape)),
                         offset=vox_offset).reshape(shape, order="F")

    scaled = scl_slope not in (0.0, 1.0) or scl_inter != 0.0
    if preserve_dtype and not scaled:
        # one copy, in the file's axis order: the bytes are read-only, and
        # the sagittal remap (a full axis reversal) makes it C-contiguous
        data = data.astype(dtype.newbyteorder("="), order="F")
    else:
        data = data.astype(np.float64)
        if scaled:
            slope = scl_slope if scl_slope != 0.0 else 1.0
            data = data * slope + scl_inter

    affine = np.eye(4)
    if sform_code > 0:
        affine[:3, :] = srow
    else:
        affine[0, 0], affine[1, 1], affine[2, 2] = pixdim[1:4]
    return data, affine


def nifti_to_numpy(fname_in, ras_to_ipr=False, ras_to_irp=False,
                   preserve_dtype=False):
    """Read NIfTI → (stack, spacings) with the reference's axis
    conventions (RAS+ → IPR+ for sagittal, RAS+ → IRP+ for coronal)."""
    stack, affine = read_nifti(fname_in, preserve_dtype=preserve_dtype)
    spacings = [affine[i, i] for i in range(3)]
    if ras_to_ipr:
        stack = np.moveaxis(stack, [2, 1, 0], [0, 1, 2])
        spacings = [-spacings[2], -spacings[1], spacings[0]]
    elif ras_to_irp:
        stack = np.moveaxis(stack, [2, 1, 0], [0, 2, 1])
        spacings = [-spacings[2], spacings[0], -spacings[1]]
    return stack, spacings


def png_to_numpy(fname_in):
    """Read a grayscale PNG → [R, C] uint8 ndarray."""
    from PIL import Image
    return np.asarray(Image.open(fname_in).convert("L"))
