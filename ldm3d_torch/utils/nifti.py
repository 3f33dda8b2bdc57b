"""Minimal NIfTI-1 I/O: dependency-free volume save/load.

The reference writes generated volumes as NIfTI via nibabel
(``3d_ldm/inference.py:100-102``). nibabel is an optional extra here; this
module implements the small subset of NIfTI-1 the pipeline needs — single
3-D (or 4-D, for multi-channel output) float32/int16 volumes with an affine — so ``.nii``/``.nii.gz`` output
parity holds in minimal images. The port's own copy of
``ldm3d_tpu/utils/nifti.py``.

NIfTI-1: 348-byte little-endian header (+4 pad), magic ``n+1`` for the
single-file variant, data at ``vox_offset=352``. Gzip wrapping gives
``.nii.gz``.
"""

from __future__ import annotations

import gzip
import struct

import numpy as np

__all__ = ["write_nifti", "read_nifti", "nifti_bytes"]

_DTYPE_CODES = {
    np.dtype(np.uint8): 2,
    np.dtype(np.int16): 4,
    np.dtype(np.int32): 8,
    np.dtype(np.float32): 16,
    np.dtype(np.float64): 64,
}
_CODE_DTYPES = {v: k for k, v in _DTYPE_CODES.items()}
_HEADER_SIZE = 348
_VOX_OFFSET = 352.0


def _build_header(shape, dtype: np.dtype, zooms) -> bytes:
    if len(shape) not in (3, 4):
        raise ValueError(f"only 3-D/4-D volumes supported, got shape {shape}")
    code = _DTYPE_CODES.get(np.dtype(dtype))
    if code is None:
        raise ValueError(f"unsupported dtype {dtype}; one of {list(_DTYPE_CODES)}")
    h = bytearray(_HEADER_SIZE)
    struct.pack_into("<i", h, 0, _HEADER_SIZE)                  # sizeof_hdr
    # offset 38 = char 'regular' ('r' by convention); offset 39 = dim_info,
    # which must stay 0 (packing 'r' there would claim bogus MRI
    # frequency/slice-encoding directions to readers like nibabel)
    struct.pack_into("<b", h, 38, 114)                           # regular = 'r'
    dim = (len(shape), *shape) + (1,) * (7 - len(shape))
    struct.pack_into("<8h", h, 40, *dim)                         # dim
    struct.pack_into("<h", h, 70, code)                          # datatype
    struct.pack_into("<h", h, 72, np.dtype(dtype).itemsize * 8)  # bitpix
    pixdim = (1.0, *zooms, 1.0, 1.0, 1.0, 1.0)
    struct.pack_into("<8f", h, 76, *pixdim)                      # pixdim (qfac=1)
    struct.pack_into("<f", h, 108, _VOX_OFFSET)                  # vox_offset
    struct.pack_into("<f", h, 112, 1.0)                          # scl_slope
    struct.pack_into("<f", h, 116, 0.0)                          # scl_inter
    struct.pack_into("<h", h, 252, 1)                            # qform_code
    struct.pack_into("<h", h, 254, 1)                            # sform_code
    # identity quaternion (b=c=d=0) with zero offsets
    struct.pack_into("<6f", h, 256, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0)
    # sform rows: diag(zooms) affine
    struct.pack_into("<4f", h, 280, zooms[0], 0.0, 0.0, 0.0)
    struct.pack_into("<4f", h, 296, 0.0, zooms[1], 0.0, 0.0)
    struct.pack_into("<4f", h, 312, 0.0, 0.0, zooms[2], 0.0)
    h[344:348] = b"n+1\x00"                                      # magic
    return bytes(h) + b"\x00" * 4                                # 4-byte pad to 352


def nifti_bytes(volume: np.ndarray, zooms=(1.0, 1.0, 1.0)) -> bytes:
    """Serialize a 3-D (or 4-D multi-channel) volume as an in-memory NIfTI-1 (.nii) file.

    """
    vol = np.ascontiguousarray(np.asarray(volume))
    return _build_header(vol.shape, vol.dtype, zooms) + vol.tobytes(order="F")


def write_nifti(path: str, volume: np.ndarray, zooms=(1.0, 1.0, 1.0)) -> str:
    """Write a 3-D (or 4-D) volume as .nii or .nii.gz (chosen by extension).

    NIfTI data is Fortran-ordered (x fastest); the volume is stored so that
    ``read_nifti(write_nifti(p, v))`` returns ``v`` exactly.
    """
    payload = nifti_bytes(volume, zooms)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(payload)
    return path


def read_nifti(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Read a (possibly gzipped) NIfTI-1 file → (volume, zooms).

    Supports the single-file little-endian subset this module writes plus
    plain nibabel-written 3-D volumes (scl_slope/inter applied when set).
    """
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        raw = f.read()
    if len(raw) < _HEADER_SIZE or raw[344:347] != b"n+1":
        raise ValueError(f"{path}: not a single-file little-endian NIfTI-1")
    ndim = struct.unpack_from("<h", raw, 40)[0]
    dims = struct.unpack_from("<8h", raw, 40)[1:1 + max(ndim, 3)]
    shape = tuple(int(d) for d in dims[:4 if ndim >= 4 else 3])
    code = struct.unpack_from("<h", raw, 70)[0]
    dtype = _CODE_DTYPES.get(code)
    if dtype is None:
        raise ValueError(f"{path}: unsupported NIfTI datatype code {code}")
    zooms = np.asarray(struct.unpack_from("<8f", raw, 76)[1:4], np.float32)
    vox_offset = int(struct.unpack_from("<f", raw, 108)[0])
    slope, inter = struct.unpack_from("<2f", raw, 112)
    count = int(np.prod(shape))
    data = np.frombuffer(raw, dtype=dtype, count=count, offset=vox_offset)
    vol = np.reshape(data, shape, order="F")
    # NIfTI-1: scl_slope == 0 means "no scaling stored" — ignore both fields
    if slope != 0.0 and (slope != 1.0 or inter != 0.0):
        vol = vol.astype(np.float32) * slope + inter
    return vol, zooms
