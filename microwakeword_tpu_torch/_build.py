"""Builds the port's CUDA sources at first use and loads them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into a shared library with a
plain C interface under ``_build/`` (listed in ``.gitignore``), named by a hash
of the source and the flags, so an edited source is rebuilt and an unchanged
one is loaded as it is.  Nothing is built when a module is imported: the
wrappers call ``load`` inside the function that launches the kernel.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# --fmad=false: expressions round operation by operation, like PyTorch's
# eager ops; the kernels call fmaf where they want a fused multiply-add.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
    "--fmad=false", "-Xptxas", "-v",
)


def nvcc_path() -> str:
    """nvcc of the toolkit PyTorch finds (``CUDA_HOME``, ``PATH``, default)."""
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = Path(CUDA_HOME or "") / "bin" / "nvcc"
    if CUDA_HOME is None or not nvcc.exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return str(nvcc)


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build(name: str) -> tuple[Path, str]:
    """Compiles ``csrc/<name>.cu`` unless its library exists.

    Returns (library path, the compiler's report; empty if nothing was built).
    The library is written to a temporary name and renamed into place, so
    processes building at the same time never load a half-written file.
    """
    out = library_path(name)
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
            capture_output=True,
            text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on csrc/{name}.cu:\n{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out, proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Builds (if needed) and loads ``csrc/<name>.cu``'s library."""
    path, _ = build(name)
    return ctypes.CDLL(str(path))
