"""Builds the port's native sources at first use and loads them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into a shared library with a
plain C interface under ``_build/`` (listed in ``.gitignore``), named by a hash
of the source and the flags, so an edited source is rebuilt and an unchanged
one is loaded as it is.  The repo's two standalone C++ sources are compiled
the same way by ``g++``: the streaming runtime ``native/src/mww_runtime.cc``
(``build_runtime``) and the host I/O library ``native/src/mww_native.cc``
(``build_native``: window gather, WAV decode and encode, resampler, VAD).
Nothing is built when a module is imported: the wrappers call ``load``,
``load_runtime`` or ``load_native`` inside the function that needs the
library.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
RUNTIME_SRC = _PKG.parent / "native" / "src" / "mww_runtime.cc"
NATIVE_SRC = _PKG.parent / "native" / "src" / "mww_native.cc"
GXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
# the gather runs on std::thread workers
NATIVE_GXX_FLAGS = (*GXX_FLAGS, "-pthread")

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


def _compile(command: list[str], src: Path, out: Path) -> str:
    """Runs ``command + ["-o", tmp, src]`` and renames ``tmp`` to ``out``, so
    processes building at the same time never load a half-written file.
    Returns the compiler's report."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([*command, "-o", tmp, str(src)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{command[0]} failed on {src.name}:\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return proc.stdout + proc.stderr


def build(name: str) -> tuple[Path, str]:
    """Compiles ``csrc/<name>.cu`` unless its library exists.

    Returns (library path, the compiler's report; empty if nothing was built).
    """
    out = library_path(name)
    if out.exists():
        return out, ""
    return out, _compile([nvcc_path(), *NVCC_FLAGS], CSRC / f"{name}.cu", out)


def _gxx_library_path(src: Path, flags: tuple, stem: str) -> Path:
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode())
    return BUILD_DIR / f"lib{stem}_{digest.hexdigest()[:16]}.so"


def _gxx_build(src: Path, flags: tuple, stem: str) -> tuple[Path, str]:
    """Compiles the standalone C++ source ``src`` (C interface, standard
    headers only) with ``g++`` unless its library exists; returns (library
    path, the compiler's report).  There is no fallback: without ``g++`` or
    the source this raises."""
    out = _gxx_library_path(src, flags, stem)
    if out.exists():
        return out, ""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found: {src.name} is built from source")
    return out, _compile([gxx, *flags], src, out)


def runtime_library_path() -> Path:
    return _gxx_library_path(RUNTIME_SRC, GXX_FLAGS, "mww_runtime")


def build_runtime() -> tuple[Path, str]:
    """Builds the C++ streaming runtime (``native/src/mww_runtime.cc``)."""
    return _gxx_build(RUNTIME_SRC, GXX_FLAGS, "mww_runtime")


def native_library_path() -> Path:
    return _gxx_library_path(NATIVE_SRC, NATIVE_GXX_FLAGS, "mww_native")


def build_native() -> tuple[Path, str]:
    """Builds the host I/O library (``native/src/mww_native.cc``)."""
    return _gxx_build(NATIVE_SRC, NATIVE_GXX_FLAGS, "mww_native")


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Builds (if needed) and loads ``csrc/<name>.cu``'s library."""
    path, _ = build(name)
    return ctypes.CDLL(str(path))


@functools.lru_cache(maxsize=None)
def load_runtime() -> ctypes.CDLL:
    """Builds (if needed) and loads the C++ streaming runtime."""
    path, _ = build_runtime()
    return ctypes.CDLL(str(path))


@functools.lru_cache(maxsize=None)
def load_native() -> ctypes.CDLL:
    """Builds (if needed) and loads the host I/O library."""
    path, _ = build_native()
    return ctypes.CDLL(str(path))
