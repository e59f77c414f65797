"""Build the port's native sources and load them with ctypes.

Each ``ops/csrc/<name>.cu`` exports a plain C interface. At first use it
is compiled for Hopper (``sm_90a``) into ``build/`` at the root of the
checkout and loaded with ctypes. The library's file name carries a hash
of its source, of the port's headers (``csrc/*.cuh``) and of the nvcc
flags, so an edited source or header or a changed flag is rebuilt and a
stale library is never loaded. ``compile_library`` does the same for the
host I/O library (``utils/native_io.py``, g++). Nothing here runs when the
package is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from collections.abc import Callable, Sequence
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the port's kernels")
    return path


def library_path(stem: str, src: Path, flags: Sequence[str],
                 libs: Sequence[str] = (), key: bytes = b"") -> Path:
    """Where ``compile_library`` puts the library of these inputs."""
    digest = hashlib.sha1(src.read_bytes() + key + " ".join(
        (*flags, *libs)).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{stem}-{digest}.so"


def compile_library(stem: str, src: Path, compiler: Callable[[], str],
                    flags: Sequence[str], libs: Sequence[str] = (),
                    key: bytes = b"") -> tuple[Path, str]:
    """Compile ``src`` into ``build/lib<stem>-<hash>.so`` unless that
    library is already built; the hash covers the source, ``key`` (headers
    it includes), the flags and the libraries. ``compiler()`` names the
    compiler and is asked only when there is something to compile. The
    library is written to a temporary name and renamed, so concurrent first
    uses (threads, worker processes) never see half a file.

    Returns the library's path and the compiler's report (empty when the
    library was already built)."""
    out = library_path(stem, src, flags, libs, key)
    if out.exists():
        return out, ""
    exe = compiler()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}"
                        f".tmp")
    proc = subprocess.run([exe, *flags, "-o", str(tmp), str(src), *libs],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{Path(exe).name} failed on {src.name}:\n"
                           f"{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out, proc.stderr


def build(name: str) -> tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` unless its library is already built.

    Returns the library's path and the compiler's report (ptxas's
    registers, shared memory and spills per kernel; empty when the
    library was already built)."""
    # the port's own headers too: an edited header rebuilds what includes it
    headers = b"".join(p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cuh")))
    return compile_library(name, CSRC_DIR / f"{name}.cu", _nvcc, NVCC_FLAGS,
                           key=headers)


def load(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and load it."""
    path, _ = build(name)
    return ctypes.CDLL(str(path))
