"""The port's native inflate/deflate (oaprogressionmmf_torch/native/
fast_inflate.cpp through utils/native_io.py) and its NIfTI and PNG writers,
against the JAX package's.

The cases of tests/test_native_io.py run on the port's copy: byte identity
with Python's codec, the multi-member grow path (ISIZE undercounts), None on
corrupt input. The library is built with g++ into the checkout's build/
directory (a deliberate difference: JAX's Makefile builds beside its
source), keyed by a hash of the source and the flags. Files written by
either package read equal in the other.
"""

import ctypes
import gzip
import os
import shutil
import struct
import subprocess
import sys

import numpy as np
import pytest

from oaprogressionmmf_tpu.utils import formats as jax_formats
from oaprogressionmmf_torch.ops import _build
from oaprogressionmmf_torch.utils import formats as F
from oaprogressionmmf_torch.utils import native_io

REPO = _build.BUILD_DIR.parent


@pytest.fixture(scope="module")
def lib_available():
    if native_io._load() is None:
        pytest.skip(f"native library {native_io.route()}")
    return True


def test_inflate_identity(tmp_path, lib_available):
    rng = np.random.RandomState(0)
    data = np.concatenate([
        np.repeat(rng.randint(0, 50, 40_000), 17).astype(np.uint8),
        rng.randint(0, 256, 123_457).astype(np.uint8),
    ]).tobytes()
    p = tmp_path / "vol.bin.gz"
    p.write_bytes(gzip.compress(data, 6))
    out = native_io.inflate_gz(p)
    assert out is not None
    assert out.tobytes() == data


def test_inflate_empty_payload(tmp_path, lib_available):
    p = tmp_path / "empty.gz"
    p.write_bytes(gzip.compress(b"", 6))
    # ISIZE == 0 → None (the caller takes Python's gzip), never a
    # wrong-sized buffer
    assert native_io.inflate_gz(p) is None


def test_inflate_multimember_grow_path(tmp_path, lib_available):
    # concatenated members: ISIZE counts only the last one, so the first
    # sized attempt reports "more data" and the wrapper grows it (×4)
    rng = np.random.RandomState(2)
    m1 = rng.randint(0, 256, 40_000).astype(np.uint8).tobytes()
    m2 = rng.randint(0, 256, 30_000).astype(np.uint8).tobytes()
    p = tmp_path / "multi.gz"
    p.write_bytes(gzip.compress(m1, 6) + gzip.compress(m2, 6))
    out = native_io.inflate_gz(p)
    assert out is not None
    assert out.tobytes() == m1 + m2


def test_inflate_extreme_undercount_falls_back(tmp_path, lib_available):
    # last-member ISIZE < total/64: outside the grow budget → None, and
    # read_nifti's Python route (gzip reads every member) stays correct
    big = bytes(range(256)) * 4096
    small = b"t" * 16
    p = tmp_path / "extreme.gz"
    p.write_bytes(gzip.compress(big, 6) + gzip.compress(small, 6))
    assert native_io.inflate_gz(p) is None
    with gzip.open(p, "rb") as f:
        assert f.read() == big + small


def test_inflate_corrupt_returns_none(tmp_path, lib_available):
    good = gzip.compress(b"x" * 10_000, 6)
    p = tmp_path / "corrupt.gz"
    p.write_bytes(good[: len(good) // 2])
    assert native_io.inflate_gz(p) is None
    q = tmp_path / "notgzip.gz"
    q.write_bytes(b"this is not a gzip stream, not even close" * 100)
    assert native_io.inflate_gz(q) is None


def test_read_nifti_uses_native_path(tmp_path, lib_available, monkeypatch):
    rng = np.random.RandomState(1)
    vol = rng.randint(0, 255, (31, 17, 9)).astype(np.uint8)
    p = tmp_path / "v.nii.gz"
    F.numpy_to_nifti(vol, str(p))
    calls = []
    inflate = F.inflate_gz
    monkeypatch.setattr(F, "inflate_gz",
                        lambda path: calls.append(path) or inflate(path))
    data, _ = F.read_nifti(str(p), preserve_dtype=True)
    np.testing.assert_array_equal(data, vol)
    assert data.flags.writeable
    stack, _ = F.nifti_to_numpy(str(p))
    np.testing.assert_array_equal(stack, vol)
    assert len(calls) == 2


def test_deflate_roundtrip(tmp_path, lib_available):
    rng = np.random.RandomState(3)
    raw = np.concatenate([
        np.repeat(rng.randint(0, 60, 30_000), 11).astype(np.uint8),
        rng.randint(0, 256, 77_001).astype(np.uint8),
    ]).tobytes()
    p = tmp_path / "w.gz"
    assert native_io.deflate_gz(raw, p, level=6) == (
        native_io.route() == "built: libdeflate")
    with gzip.open(p, "rb") as f:
        assert f.read() == raw
    out = native_io.inflate_gz(p)
    assert out is not None and out.tobytes() == raw


def test_write_nifti_gz_native_path(tmp_path, lib_available):
    rng = np.random.RandomState(4)
    vol = rng.randint(0, 255, (23, 11, 7)).astype(np.uint8)
    p = tmp_path / "w.nii.gz"
    F.numpy_to_nifti(vol, str(p))
    stack, _ = F.nifti_to_numpy(str(p))
    np.testing.assert_array_equal(stack, vol)
    with gzip.open(p, "rb") as f:   # a plain gzip stream
        assert f.read(4) == b"\x5c\x01\x00\x00"


def test_build_from_an_empty_build_directory(tmp_path, monkeypatch):
    """First use in a fresh checkout: the library is built from the source
    into an empty build/ (libdeflate when the toolchain has it, zlib
    otherwise), under a name keyed by the source and the flags, and loads
    in a fresh process."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    path, codec = native_io.build()
    assert path.parent == tmp_path / "build" and path.exists()
    assert path.name.startswith("libfastinflate-")
    assert codec in ("libdeflate", "zlib")
    assert [p.name for p in path.parent.iterdir()] == [path.name]
    assert native_io.build() == (path, codec)   # reused, not rebuilt
    code = ("import ctypes, sys\n"
            f"lib = ctypes.CDLL({str(path)!r})\n"
            "assert lib.fnifti_inflate and lib.fnifti_deflate\n"
            "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=60)
    assert proc.stdout.strip() == "ok", proc.stderr
    # the checkout's own build/ is where it goes unpatched
    monkeypatch.undo()
    assert _build.BUILD_DIR == REPO / "build"


@pytest.mark.parametrize("codec", sorted(native_io.CODECS))
def test_each_codec_build_inflates(tmp_path, monkeypatch, codec):
    """The libdeflate and the zlib build both inflate what Python's gzip
    wrote; only the libdeflate build deflates (the zlib build's deflate
    returns -1 and the writers take Python's codec, as in JAX's copy)."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host")
    if codec == "libdeflate" and not native_io._has_libdeflate():
        pytest.skip("no libdeflate on this host")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    path, _ = _build.compile_library("fastinflate", native_io.SOURCE,
                                     native_io._gxx,
                                     *native_io.CODECS[codec])
    lib = ctypes.CDLL(str(path))
    lib.fnifti_deflate.restype = ctypes.c_int64
    lib.fnifti_deflate.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                   ctypes.c_char_p, ctypes.c_int]
    lib.fnifti_inflate.restype = ctypes.c_int64
    lib.fnifti_inflate.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                   ctypes.c_int64]
    rng = np.random.RandomState(5)
    raw = np.concatenate([
        np.repeat(rng.randint(0, 60, 40_000), 13).astype(np.uint8),
        rng.randint(0, 256, 90_001).astype(np.uint8)])
    p = tmp_path / f"{codec}.gz"
    p.write_bytes(gzip.compress(raw.tobytes(), 9))
    out = np.empty(raw.size, np.uint8)
    assert lib.fnifti_inflate(str(p).encode(),
                              out.ctypes.data_as(ctypes.c_void_p),
                              out.size) == raw.size
    np.testing.assert_array_equal(out, raw)
    q = tmp_path / f"{codec}-deflated.gz"
    n = lib.fnifti_deflate(raw.ctypes.data_as(ctypes.c_void_p), raw.size,
                           str(q).encode(), 6)
    if codec == "zlib":
        assert n == -1 and not q.exists()
    else:
        assert n == q.stat().st_size > 0
        assert gzip.decompress(q.read_bytes()) == raw.tobytes()


def test_no_native_env_takes_the_python_codec(tmp_path):
    code = (
        "import numpy as np\n"
        "from oaprogressionmmf_torch.utils import formats, native_io\n"
        f"p = {str(tmp_path / 'v.nii.gz')!r}\n"
        "vol = np.arange(60, dtype=np.int16).reshape(3, 4, 5)\n"
        "formats.write_nifti(vol, p)\n"
        "assert native_io.inflate_gz(p) is None\n"
        "assert not native_io.deflate_gz(b'x', p + '.x')\n"
        "got, _ = formats.read_nifti(p, preserve_dtype=True)\n"
        "assert (got == vol).all()\n"
        "print(native_io.route())\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=60,
                          env={**os.environ, "OAPROG_NO_NATIVE": "1"})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "unavailable: OAPROG_NO_NATIVE is set"


# -- the writers against the JAX package's (tests/test_formats.py dtypes) --

@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.int16,
                                   np.float32, np.float64])
@pytest.mark.parametrize("gz", [False, True])
def test_nifti_written_by_either_reads_equal_in_the_other(tmp_path, dtype,
                                                          gz):
    rng = np.random.RandomState(0)
    if np.issubdtype(dtype, np.integer):
        data = rng.randint(0, 200, size=(7, 5, 3)).astype(dtype)
    else:
        data = rng.rand(7, 5, 3).astype(dtype)
    affine = np.diag([0.5, -0.7, 2.0, 1.0])
    name = "vol.nii.gz" if gz else "vol.nii"
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    F.write_nifti(data, tmp_path / "port" / name, affine=affine)
    jax_formats.write_nifti(data, tmp_path / "jax" / name, affine=affine)
    raw = []
    for who in ("port", "jax"):
        fn = tmp_path / who / name
        affines = []
        for reader in (F.read_nifti, jax_formats.read_nifti):
            out, aff = reader(fn)
            np.testing.assert_array_equal(out, data.astype(np.float64))
            affines.append(aff)
            kept, _ = reader(fn, preserve_dtype=True)
            assert kept.dtype == dtype
            np.testing.assert_array_equal(kept, data)
        np.testing.assert_array_equal(affines[0], affines[1])
        np.testing.assert_allclose(affines[0], affine, rtol=1e-7)  # float32
        opener = gzip.open if gz else open
        with opener(fn, "rb") as f:
            raw.append(f.read())
    assert raw[0] == raw[1]   # the same bytes once inflated


@pytest.mark.parametrize("remap", ["ipr", "irp"])
def test_remapped_nifti_equal_to_jax(tmp_path, remap):
    rng = np.random.RandomState(1)
    stack = rng.rand(6, 5, 4).astype(np.float32)
    spacings = (0.36, 0.36, 0.7)
    kw_w = {f"{remap}_to_ras": True}
    kw_r = {f"ras_to_{remap}": True}
    F.numpy_to_nifti(stack, tmp_path / "p.nii.gz", spacings=spacings, **kw_w)
    jax_formats.numpy_to_nifti(stack, tmp_path / "j.nii.gz",
                               spacings=spacings, **kw_w)
    with gzip.open(tmp_path / "p.nii.gz") as fp, \
            gzip.open(tmp_path / "j.nii.gz") as fj:
        assert fp.read() == fj.read()
    out, sp = F.nifti_to_numpy(tmp_path / "j.nii.gz", **kw_r)
    np.testing.assert_array_equal(out, stack)
    np.testing.assert_allclose(sp, spacings)


def test_png_written_by_either_reads_equal_in_the_other(tmp_path):
    """The port writes PNGs through PIL only (a deliberate difference: the
    JAX package takes cv2 where it is installed); the pixels are equal
    either way."""
    img = (np.random.RandomState(3).rand(20, 30) * 255).astype(np.uint8)
    F.numpy_to_png(img, tmp_path / "p.png")
    jax_formats.numpy_to_png(img, tmp_path / "j.png")
    for fn in ("p.png", "j.png"):
        np.testing.assert_array_equal(F.png_to_numpy(tmp_path / fn), img)
        np.testing.assert_array_equal(
            jax_formats.png_to_numpy(tmp_path / fn), img)


def test_png_series_roundtrip_equal_to_jax(tmp_path):
    rng = np.random.RandomState(4)
    stack = (rng.rand(8, 9, 5) * 255).astype(np.uint8)
    for i in range(stack.shape[-1]):
        F.numpy_to_png(stack[..., i], tmp_path / f"s_{i:03d}.png")
    pattern = tmp_path / "s_*.png"
    for reverse in (False, True):
        got = F.png_series_to_numpy(pattern, reverse=reverse)
        np.testing.assert_array_equal(
            got, jax_formats.png_series_to_numpy(pattern, reverse=reverse))
        np.testing.assert_array_equal(got, stack[..., ::-1] if reverse
                                      else stack)
    F.png_series_to_nifti(pattern, tmp_path / "s.nii.gz",
                          spacings=(0.5, 0.5, 1.0), ipr_to_ras=True)
    out, sp = jax_formats.nifti_to_numpy(tmp_path / "s.nii.gz",
                                         ras_to_ipr=True)
    np.testing.assert_array_equal(out, stack)
    np.testing.assert_allclose(sp, (0.5, 0.5, 1.0))
    # the series comes back float64 and is written as uint8, as cv2 does
    F.nifti_to_png_series(tmp_path / "s.nii.gz",
                          str(tmp_path / "o_{i:03d}.png"), ras_to_ipr=True)
    jax_formats.nifti_to_png_series(tmp_path / "s.nii.gz",
                                    str(tmp_path / "j_{i:03d}.png"),
                                    ras_to_ipr=True)
    got = F.png_series_to_numpy(tmp_path / "o_*.png")
    np.testing.assert_array_equal(got, stack)
    np.testing.assert_array_equal(
        got, jax_formats.png_series_to_numpy(tmp_path / "j_*.png"))


def test_png_of_another_type_is_saturated_to_uint8_as_cv2_does(tmp_path):
    img = np.array([[-3.0, 0.4, 0.5, 1.5], [2.5, 254.5, 255.6, 300.0]])
    F.numpy_to_png(img, tmp_path / "p.png")
    jax_formats.numpy_to_png(img, tmp_path / "j.png")
    got = F.png_to_numpy(tmp_path / "p.png")
    np.testing.assert_array_equal(got, [[0, 0, 0, 2], [2, 254, 255, 255]])
    np.testing.assert_array_equal(got, F.png_to_numpy(tmp_path / "j.png"))


def test_big_endian_nifti_keeps_its_values(tmp_path):
    """A big-endian file read with ``preserve_dtype`` keeps its values in
    the port (one swapped copy). A fault of the reference: the JAX
    package's reader reinterprets the big-endian values in the host's order
    there (``oaprogressionmmf_tpu/utils/formats.py:110``), so 3 reads 768;
    without ``preserve_dtype`` it reads them right."""
    data = np.arange(24, dtype=np.int16).reshape(2, 3, 4) * 257 + 3
    fn = tmp_path / "be.nii"
    F.write_nifti(data, fn)
    raw = bytearray(fn.read_bytes())
    hdr = bytearray(raw[:348])
    be = bytearray(348)
    struct.pack_into(">i", be, 0, 348)
    struct.pack_into(">8h", be, 40, *struct.unpack_from("<8h", hdr, 40))
    struct.pack_into(">2h", be, 70, *struct.unpack_from("<2h", hdr, 70))
    struct.pack_into(">8f", be, 76, *struct.unpack_from("<8f", hdr, 76))
    struct.pack_into(">3f", be, 108, *struct.unpack_from("<3f", hdr, 108))
    struct.pack_into(">2h", be, 252, *struct.unpack_from("<2h", hdr, 252))
    struct.pack_into(">12f", be, 280, *struct.unpack_from("<12f", hdr, 280))
    be[344:348] = hdr[344:348]
    body = np.asfortranarray(data).astype(">i2").tobytes(order="F")
    fn.write_bytes(bytes(be) + b"\x00" * 4 + body)
    for preserve in (False, True):
        out, _ = F.read_nifti(fn, preserve_dtype=preserve)
        np.testing.assert_array_equal(out, data)
    np.testing.assert_array_equal(jax_formats.read_nifti(fn)[0], data)
    swapped, _ = jax_formats.read_nifti(fn, preserve_dtype=True)
    np.testing.assert_array_equal(swapped, data.byteswap())
