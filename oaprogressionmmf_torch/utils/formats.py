"""Medical-image I/O: NIfTI-1 and grayscale PNG.

The port's copy of ``oaprogressionmmf_tpu/utils/formats.py``: a
self-contained NIfTI-1 reader and writer in numpy (``.nii`` and
``.nii.gz``, scalar dtypes, sform or pixdim affine, scl_slope/scl_inter on
read, a diagonal sform on write), the reference's RAS+ ↔ IPR+/IRP+ axis
remaps with signed-spacing affines, and PNG through PIL, imported inside
the functions (the machine with the card has no PIL; the data layer runs
on the host that holds the data). The JAX package writes PNGs through cv2
where it is installed; the port through PIL only (lossless either way).
``.gz`` files go through the native inflate and deflate of
``utils/native_io.py`` first, Python's gzip where it is unavailable.
"""

from __future__ import annotations

import gzip
import struct
from glob import glob

import numpy as np

from .native_io import deflate_gz, inflate_gz

_NIFTI_DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32, 64: np.float64,
    256: np.int8, 512: np.uint16, 768: np.uint32, 1024: np.int64,
    1280: np.uint64,
}
_NIFTI_CODES = {np.dtype(v): k for k, v in _NIFTI_DTYPES.items()}
_HDR_SIZE = 348


def _open_maybe_gz(fname, mode):
    return gzip.open(str(fname), mode) if str(fname).endswith(".gz") else \
        open(str(fname), mode)


def read_nifti(fname_in, preserve_dtype: bool = False):
    """Read a NIfTI-1 file → (data in RAS/native order, affine 4x4).

    By default float64 with scl_slope/scl_inter applied, in Fortran
    (column-major) axis order, as nibabel's ``get_fdata()``.
    ``preserve_dtype=True`` keeps the stored dtype when no intensity
    scaling is present."""
    # one native call (GIL-free, no chunk list) first; None → Python's gzip
    raw = inflate_gz(fname_in) if str(fname_in).endswith(".gz") else None
    if raw is None:
        with _open_maybe_gz(fname_in, "rb") as f:
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
        # in the file's axis order: a view of the native inflate's fresh
        # buffer, else one copy (Python's bytes are read-only, a big-endian
        # file is swapped); the sagittal remap (a full axis reversal) makes
        # it C-contiguous
        if not (dtype.isnative and data.flags.writeable):
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


def write_nifti(data, fname_out, affine=None):
    """Write an array as single-file NIfTI-1 (sform diagonal affine,
    ``vox_offset`` 352, Fortran order); ``.gz`` through the native deflate
    when it is available."""
    data = np.asarray(data)
    if affine is None:
        affine = np.eye(4)
    affine = np.asarray(affine, dtype=np.float64)

    if data.dtype not in _NIFTI_CODES:
        data = data.astype(np.float32)
    code = _NIFTI_CODES[np.dtype(data.dtype)]
    bitpix = data.dtype.itemsize * 8

    hdr = bytearray(_HDR_SIZE)
    struct.pack_into("<i", hdr, 0, _HDR_SIZE)
    struct.pack_into("<b", hdr, 39, ord("r"))  # dim_info unused; keep regular
    dim = [data.ndim] + list(data.shape) + [1] * (7 - data.ndim)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, bitpix)
    pixdim = [1.0] + [float(abs(affine[i, i])) for i in range(3)] + [1.0] * 4
    struct.pack_into("<8f", hdr, 76, *pixdim)
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)    # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)    # scl_inter
    struct.pack_into("<h", hdr, 252, 0)      # qform_code
    struct.pack_into("<h", hdr, 254, 1)      # sform_code = SCANNER_ANAT
    struct.pack_into("<4f", hdr, 280, *affine[0, :])
    struct.pack_into("<4f", hdr, 296, *affine[1, :])
    struct.pack_into("<4f", hdr, 312, *affine[2, :])
    hdr[344:348] = b"n+1\x00"

    payload = (bytes(hdr) + b"\x00" * 4
               + np.asfortranarray(data).tobytes(order="F"))
    if str(fname_out).endswith(".gz") and deflate_gz(payload, fname_out):
        return
    with _open_maybe_gz(fname_out, "wb") as f:
        f.write(payload)


def numpy_to_nifti(stack, fname_out, spacings=None, ipr_to_ras=False,
                   irp_to_ras=False):
    """Write an array to NIfTI with the reference's signed-spacing affines
    (IPR+ → RAS+ for sagittal, IRP+ → RAS+ for coronal)."""
    stack = np.asarray(stack)
    if ipr_to_ras:
        stack = np.moveaxis(stack, [0, 1, 2], [2, 1, 0])
        affine = np.diag([1., -1., -1., 1.])
        if spacings is not None:
            affine[0, 0] = spacings[2]
            affine[1, 1] = -spacings[1]
            affine[2, 2] = -spacings[0]
    elif irp_to_ras:
        stack = np.moveaxis(stack, [0, 1, 2], [2, 0, 1])
        affine = np.diag([1., -1., -1., 1.])
        if spacings is not None:
            affine[0, 0] = spacings[1]
            affine[1, 1] = -spacings[2]
            affine[2, 2] = -spacings[0]
    else:
        affine = np.eye(4)
        if spacings is not None:
            affine[0, 0] = spacings[0]
            affine[1, 1] = spacings[1]
            affine[2, 2] = spacings[2]
    write_nifti(stack, fname_out, affine=affine)


def numpy_to_png(image, fname_out):
    """Write an [R, C] array as a PNG through PIL. Another type than uint8
    or uint16 is rounded and saturated to uint8, as cv2.imwrite (the JAX
    package's route) falls back to."""
    from PIL import Image
    image = np.asarray(image)
    if image.dtype not in (np.uint8, np.uint16):
        image = np.clip(np.rint(image), 0, 255).astype(np.uint8)
    Image.fromarray(image).save(fname_out)


def png_series_to_numpy(pattern_fname_in, reverse=False):
    """Stack a sorted glob of grayscale PNGs → [R, C, P] ndarray."""
    fnames_in = sorted(glob(str(pattern_fname_in)))
    stack = np.stack([png_to_numpy(fn) for fn in fnames_in], axis=2)
    if reverse:
        stack = stack[..., ::-1]
    return stack


def png_series_to_nifti(pattern_fname_in, fname_out, spacings=None,
                        reverse=False, ipr_to_ras=False):
    stack = png_series_to_numpy(pattern_fname_in, reverse=reverse)
    numpy_to_nifti(stack=stack, fname_out=fname_out, spacings=spacings,
                   ipr_to_ras=ipr_to_ras)


def nifti_to_png_series(fname_in, pattern_fname_out, reverse=False,
                        ras_to_ipr=False):
    stack, _ = nifti_to_numpy(fname_in=fname_in, ras_to_ipr=ras_to_ipr)
    if reverse:
        stack = stack[..., ::-1]
    for i in range(stack.shape[-1]):
        numpy_to_png(stack[..., i], pattern_fname_out.format(i=i))
