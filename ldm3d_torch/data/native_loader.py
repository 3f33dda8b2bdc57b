"""ctypes bindings for the native NPZ pair loader (``csrc/npz_loader.cpp``).

The port of ``ldm3d_tpu/data/native_loader.py``: the C++ library parses the
zip/npy containers and inflates payloads on a thread pool, in one host
process with no GIL in the decompression path. It is built with ``g++`` at
first use into ``build/ldm3d_torch/`` (named by a hash of its source, written
under a per-process name and renamed into place, so a concurrent process
never loads a half-written file); every caller falls back to the numpy path
when no toolchain is available, and a failed build or load is logged at
WARNING.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

__all__ = ["get_lib", "available", "pair_dims", "load_pair", "load_batch"]

log = logging.getLogger("native_loader")

_SRC_PATH = Path(__file__).resolve().parents[1] / "csrc" / "npz_loader.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ldm3d_torch"

_lib = None
_lib_lock = threading.Lock()
_build_failed = False


def _lib_path() -> Path:
    digest = hashlib.sha256(_SRC_PATH.read_bytes()).hexdigest()[:16]
    return _BUILD_DIR / f"libnpz_loader-{digest}.so"


def _build(path: Path) -> bool:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(_SRC_PATH),
           "-o", str(tmp), "-lz", "-lpthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, path)
        return True
    except Exception as e:
        log.warning("native loader build failed (%s); using the numpy path", e)
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _build_failed
    with _lib_lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        path = _lib_path()
        if not path.exists() and not _build(path):
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            log.warning("native loader failed to load (%s); using the numpy path", e)
            _build_failed = True
            return None
        lib.npz_pair_dims.restype = ctypes.c_int
        lib.npz_pair_dims.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64)]
        lib.npz_load_pair.restype = ctypes.c_int
        lib.npz_load_pair.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                                      ctypes.POINTER(ctypes.c_int64)]
        lib.npz_load_batch.restype = ctypes.c_int
        lib.npz_load_batch.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                                       ctypes.POINTER(ctypes.c_int64),
                                       ctypes.POINTER(ctypes.c_float), ctypes.c_int]
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


# path -> ((mtime_ns, size), dims): the dims probe parses the whole archive,
# and load_pair needs it for every sample of every epoch; a swapped file
# re-probes (and npz_load_pair checks the expected shape before writing)
_dims_cache: dict = {}


def pair_dims(path: str) -> Optional[tuple[int, int, int, int]]:
    lib = get_lib()
    if lib is None:
        return None
    try:
        st = os.stat(path)
        sig = (st.st_mtime_ns, st.st_size)
    except OSError:
        return None
    hit = _dims_cache.get(path)
    if hit is not None and hit[0] == sig:
        return hit[1]
    dims = (ctypes.c_int64 * 4)()
    if lib.npz_pair_dims(path.encode(), dims) != 0:
        return None
    out = tuple(int(d) for d in dims)
    _dims_cache[path] = (sig, out)
    return out


def load_pair(path: str) -> Optional[tuple[np.ndarray, np.ndarray]]:
    """Load (low, high) float32 volumes via the native path; None on failure."""
    lib = get_lib()
    if lib is None:
        return None
    d = pair_dims(path)
    if d is None:
        return None
    out = np.empty(d, dtype=np.float32)
    dims = (ctypes.c_int64 * 4)(*d)
    if lib.npz_load_pair(path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                         dims) != 0:
        return None
    return out[0], out[1]


def load_batch(paths: Sequence[str], shape_dhw: Sequence[int],
               num_threads: int = 0) -> Optional[np.ndarray]:
    """Parallel-load same-shaped pairs -> (N, 2, D, H, W) float32; None on failure."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(paths)
    dims = (ctypes.c_int64 * 4)(2, *shape_dhw)
    out = np.empty((n, 2, *shape_dhw), dtype=np.float32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    rc = lib.npz_load_batch(arr, n, dims, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                            num_threads)
    if rc != 0:
        log.warning("native batch load failed rc=%d", rc)
        return None
    return out
