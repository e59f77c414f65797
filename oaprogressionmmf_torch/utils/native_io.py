"""ctypes bindings for the port's native host-I/O helpers
(``oaprogressionmmf_torch/native/fast_inflate.cpp``).

The port's copy of ``oaprogressionmmf_tpu/utils/native_io.py``, with its
contract: ``inflate_gz(path)`` inflates a gzip file into a fresh numpy
uint8 buffer in one native call with the GIL released, and
``deflate_gz(data, path)`` writes one; they return ``None`` / ``False``
when the library is unavailable (the callers then take Python's gzip
codec), and ``OAPROG_NO_NATIVE=1`` disables the library.

The library is built at first use with g++ from the source in the
checkout into ``build/`` at its root, through ``ops/_build.py``'s
``compile_library`` as the kernels are: its file name carries a hash of
the source and the flags, and it is written to a temporary name and
renamed, so concurrent first uses (loader threads, the prep apps' worker
processes) never see half a file. libdeflate is taken when the toolchain
can include and link it, zlib otherwise (the zlib build inflates only:
its deflate returns -1 and the writers take Python's codec). Nothing here
runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import logging
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

logger = logging.getLogger("native_io")

SOURCE = Path(__file__).resolve().parents[1] / "native" / "fast_inflate.cpp"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
CODECS = {"libdeflate": (CXX_FLAGS + ("-DHAVE_LIBDEFLATE",),
                         ("-lz", "-ldeflate")),
          "zlib": (CXX_FLAGS, ("-lz",))}
_PROBE = "#include <libdeflate.h>\nint main() { return 0; }\n"

_lock = threading.Lock()
_lib = None
_route = None  # "built: libdeflate|zlib" or "unavailable: <reason>"


def _gxx() -> str:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found")
    return cxx


def _has_libdeflate() -> bool:
    """Whether the toolchain can both include and link libdeflate (a host
    with the library but no header takes zlib)."""
    proc = subprocess.run([_gxx(), "-x", "c++", "-", "-ldeflate", "-o",
                           os.devnull], input=_PROBE, capture_output=True,
                          text=True, timeout=120)
    return proc.returncode == 0


def build() -> tuple[Path, str]:
    """Compile the library unless it is already built (through
    ``ops/_build.py``'s ``compile_library``); returns its path and the codec
    it uses ("libdeflate" or "zlib"). A libdeflate build already in
    ``build/`` is taken without asking the toolchain again."""
    from ..ops._build import compile_library, library_path

    if library_path("fastinflate", SOURCE, *CODECS["libdeflate"]).exists():
        codec = "libdeflate"
    else:
        codec = "libdeflate" if _has_libdeflate() else "zlib"
    path, _ = compile_library("fastinflate", SOURCE, _gxx, *CODECS[codec])
    return path, codec


def _load():
    global _lib, _route
    if _route is not None:
        return _lib
    with _lock:
        if _route is not None:
            return _lib
        if os.environ.get("OAPROG_NO_NATIVE"):
            _route = "unavailable: OAPROG_NO_NATIVE is set"
            return None
        try:
            path, codec = build()
            lib = ctypes.CDLL(str(path))
            lib.fnifti_inflate.restype = ctypes.c_int64
            lib.fnifti_inflate.argtypes = [
                ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64]
            lib.fnifti_gz_isize.restype = ctypes.c_int64
            lib.fnifti_gz_isize.argtypes = [ctypes.c_char_p]
            lib.fnifti_deflate.restype = ctypes.c_int64
            lib.fnifti_deflate.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p,
                ctypes.c_int]
            _lib, _route = lib, f"built: {codec}"
        except Exception as e:  # noqa: BLE001 — any failure → Python codec
            reason = str(e).splitlines()[0] if str(e) else repr(e)
            logger.info(f"native inflate unavailable ({reason}); using the "
                        f"Python codec")
            _route = f"unavailable: {reason}"
    return _lib


def route() -> str:
    """How gzip files are read and written here: ``built: libdeflate``,
    ``built: zlib`` (native inflate; deflate through Python's codec) or
    ``unavailable: <reason>`` (Python's codec both ways). Builds the
    library if it is not built yet."""
    _load()
    return _route


def deflate_gz(data, path, level: int = 6) -> bool:
    """Gzip-compress bytes or a uint8 array to ``path`` in one GIL-free
    native call (libdeflate). False: the caller takes Python's codec."""
    lib = _load()
    if lib is None:
        return False
    buf = np.frombuffer(data, dtype=np.uint8) if isinstance(
        data, (bytes, bytearray, memoryview)) else np.ascontiguousarray(
        data, dtype=np.uint8)
    n = lib.fnifti_deflate(buf.ctypes.data_as(ctypes.c_void_p),
                           ctypes.c_int64(buf.size), str(path).encode(),
                           ctypes.c_int(level))
    return n > 0


def inflate_gz(path) -> np.ndarray | None:
    """Inflate a .gz file → uint8 array, or None (the caller takes
    Python's codec)."""
    lib = _load()
    if lib is None:
        return None
    p = str(path).encode()
    isize = lib.fnifti_gz_isize(p)
    if isize <= 0:
        return None
    for _ in range(3):  # ISIZE is mod 2^32; grow on -3 (>4 GB, multi-member)
        buf = np.empty(isize, dtype=np.uint8)
        n = lib.fnifti_inflate(p, buf.ctypes.data_as(ctypes.c_void_p),
                               ctypes.c_int64(buf.size))
        if n == -3:
            isize *= 4
            continue
        if n < 0:
            return None
        return buf[:n] if n != buf.size else buf
    return None
