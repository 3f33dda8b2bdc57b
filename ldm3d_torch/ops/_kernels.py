"""Build and load the port's hand-written CUDA kernels.

Each source under ``ldm3d_torch/csrc`` has a plain C interface. It is compiled
with ``nvcc`` for ``sm_90a`` into a shared library under ``build/ldm3d_torch/``
at the root of the checkout, at first use, and loaded with ``ctypes``. The
library's file name carries a hash of the source, so an edited source is
rebuilt and a stale library is never loaded. Nothing here runs at import time:
a machine without ``nvcc`` or a GPU imports the port and uses the kernels'
plain PyTorch versions on CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["BUILD_DIR", "CSRC_DIR", "build_library", "flash_fwd_library", "nvcc_path"]

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ldm3d_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    """``nvcc`` from ``PATH``, else from the CUDA toolkit PyTorch finds."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels of ldm3d_torch are built "
                       "from source at first use and need the CUDA toolkit")


def build_library(source: str) -> Path:
    """Compile ``csrc/<source>`` into ``build/ldm3d_torch`` (once per source hash)
    and return the library's path. ``nvcc``'s register and shared-memory report
    is kept beside the library as ``<name>.log``."""
    src = CSRC_DIR / source
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{src.stem}-{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src} (exit {proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent build never sees a partial library
    return out


@functools.cache
def flash_fwd_library() -> ctypes.CDLL:
    """The flash-attention forward library, built on first call."""
    lib = ctypes.CDLL(str(build_library("flash_fwd.cu")))
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib.ldm3d_flash_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i, i,
                                    ctypes.POINTER(ctypes.c_int64), ctypes.c_float, p]
    lib.ldm3d_flash_fwd.restype = ctypes.c_int
    return lib
