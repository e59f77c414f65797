"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``ops/csrc/<name>.cu`` exports a plain C interface. At first use it
is compiled for Hopper (``sm_90a``) into ``build/`` at the root of the
checkout and loaded with ctypes. The library's file name carries a hash
of its source, of the port's headers (``csrc/*.cuh``) and of the nvcc
flags, so an edited source or header or a changed flag is rebuilt and a
stale library is never loaded. Nothing here runs
when the package is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
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


def build(name: str) -> tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` unless its library is already built.

    Returns the library's path and the compiler's report (ptxas's
    registers, shared memory and spills per kernel; empty when the
    library was already built)."""
    src = CSRC_DIR / f"{name}.cu"
    # the port's own headers too: an edited header rebuilds what includes it
    headers = b"".join(p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha1(src.read_bytes() + headers
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out, proc.stderr


def load(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and load it."""
    path, _ = build(name)
    return ctypes.CDLL(str(path))
