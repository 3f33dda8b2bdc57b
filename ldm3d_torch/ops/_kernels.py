"""Build and load the port's hand-written CUDA kernels.

Each source under ``ldm3d_torch/csrc`` has a plain C interface. It is compiled
with ``nvcc`` for ``sm_90a`` into a shared library under ``build/ldm3d_torch/``
at the root of the checkout, at first use, and loaded with ``ctypes``. The
library's file name carries a hash of the source, so an edited source is
rebuilt and a stale library is never loaded. :func:`build_libraries` starts
one ``nvcc`` per source, all at once. Nothing here runs at import time: a
machine without ``nvcc`` or a GPU imports the port and uses the kernels'
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

__all__ = ["BUILD_DIR", "CSRC_DIR", "SOURCES", "build_library", "build_libraries",
           "flash_fwd_library", "flash_bwd_library", "groupnorm_library", "conv3d_library",
           "nvcc_path"]

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ldm3d_torch"
SOURCES = ("flash_fwd.cu", "flash_bwd.cu", "groupnorm_sums.cu", "conv3d_igemm.cu")

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


def _library_path(source: str) -> Path:
    src = CSRC_DIR / source
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{src.stem}-{digest}.so"


def build_libraries(sources) -> list[Path]:
    """Compile each ``csrc/<source>`` into ``build/ldm3d_torch`` (once per
    source hash), one ``nvcc`` process per source started together, and
    return the libraries' paths. ``nvcc``'s register and shared-memory report
    is kept beside each library as ``<name>.log``."""
    outs = [_library_path(s) for s in sources]
    running = []
    for source, out in zip(sources, outs):
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / source)],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        running.append((source, out, tmp, proc))
    failures = []
    for source, out, tmp, proc in running:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {CSRC_DIR / source} (exit {proc.returncode}):\n"
                            f"{stdout}\n{stderr}")
            continue
        out.with_suffix(".log").write_text(stdout + stderr)
        os.replace(tmp, out)  # atomic: a concurrent build never sees a partial library
    if failures:
        raise RuntimeError("\n".join(failures))
    return outs


def build_library(source: str) -> Path:
    """:func:`build_libraries` for one source."""
    return build_libraries([source])[0]


_P = ctypes.c_void_p
_I = ctypes.c_int
_STRIDES = ctypes.POINTER(ctypes.c_int64)


@functools.cache
def flash_fwd_library() -> ctypes.CDLL:
    """The flash-attention forward library, built on first call."""
    lib = ctypes.CDLL(str(build_library("flash_fwd.cu")))
    lib.ldm3d_flash_fwd.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                    _STRIDES, ctypes.c_float, _P]
    lib.ldm3d_flash_fwd.restype = ctypes.c_int
    return lib


@functools.cache
def flash_bwd_library() -> ctypes.CDLL:
    """The flash-attention backward library (dQ and dK/dV), built on first call."""
    lib = ctypes.CDLL(str(build_library("flash_bwd.cu")))
    lib.ldm3d_flash_bwd_dq.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                       _STRIDES, ctypes.c_float, _P]
    lib.ldm3d_flash_bwd_dq.restype = ctypes.c_int
    lib.ldm3d_flash_bwd_dkv.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                        _STRIDES, ctypes.c_float, _P]
    lib.ldm3d_flash_bwd_dkv.restype = ctypes.c_int
    return lib


@functools.cache
def groupnorm_library() -> ctypes.CDLL:
    """The GroupNorm voxel-sums library (forward and backward), built on first call."""
    lib = ctypes.CDLL(str(build_library("groupnorm_sums.cu")))
    lib.ldm3d_gn_sums.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _STRIDES, _I, _P]
    lib.ldm3d_gn_sums.restype = ctypes.c_int
    lib.ldm3d_gn_bwd_sums.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _STRIDES,
                                      _I, _P]
    lib.ldm3d_gn_bwd_sums.restype = ctypes.c_int
    return lib


@functools.cache
def conv3d_library() -> ctypes.CDLL:
    """The implicit-GEMM 3x3x3 convolution library, built on first call."""
    lib = ctypes.CDLL(str(build_library("conv3d_igemm.cu")))
    lib.ldm3d_conv3d_igemm.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]
    lib.ldm3d_conv3d_igemm.restype = ctypes.c_int
    return lib
