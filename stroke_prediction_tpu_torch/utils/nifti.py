"""NIfTI-1 I/O (host layer) and volume layout helpers (port of
utils/nifti.py).

:func:`load_volume`, :func:`load_affine` and :func:`save_nifti` go through
the native C++ codec (``utils/native_io.py``) where it is built, else
through the pure-Python codec here, as the JAX package does: a minimal
format-compatible NIfTI-1 reader/writer (gzip'd ``.nii.gz`` at level 6, as
the native codec writes it, and plain ``.nii``): 348-byte header, sform
affine, float32/uint8/int16/int8 dtypes, Fortran voxel order.
"""

from __future__ import annotations

import gzip
import struct
from typing import Optional, Tuple

import numpy as np

from stroke_prediction_tpu_torch.ops.resize import zoom_inplane_xyz
from stroke_prediction_tpu_torch.utils import native_io

_DTYPES = {2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32,
           64: np.float64, 256: np.int8, 512: np.uint16}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def _open(path: str, mode: str):
    if path.endswith(".gz"):
        return gzip.open(path, mode, compresslevel=native_io.GZIP_LEVEL)
    return open(path, mode)


def write_nifti(path: str, data: np.ndarray,
                affine: Optional[np.ndarray] = None) -> None:
    """Write an (X, Y, Z[, T]) array as NIfTI-1 single-file (.nii[.gz])."""
    data = np.asarray(data)
    if data.dtype == np.bool_:
        data = data.astype(np.uint8)
    if data.dtype not in _CODES:
        data = data.astype(np.float32)
    if affine is None:
        affine = np.eye(4, dtype=np.float32)
    affine = np.asarray(affine, np.float32)

    dims = list(data.shape)
    ndim = len(dims)
    dim = [ndim] + dims + [1] * (7 - ndim)
    pixdim = [0.0] + [float(np.linalg.norm(affine[:3, i]) or 1.0)
                      for i in range(min(3, ndim))] + [1.0] * (7 - min(3, ndim))

    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)                       # sizeof_hdr
    struct.pack_into("<8h", hdr, 40, *dim)                    # dim
    struct.pack_into("<h", hdr, 70, _CODES[data.dtype])       # datatype
    struct.pack_into("<h", hdr, 72, data.dtype.itemsize * 8)  # bitpix
    struct.pack_into("<8f", hdr, 76, *pixdim)                 # pixdim
    struct.pack_into("<f", hdr, 108, 352.0)                   # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)                     # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)                     # scl_inter
    struct.pack_into("<h", hdr, 252, 1)                       # qform_code
    struct.pack_into("<h", hdr, 254, 1)                       # sform_code
    # qform: identity quaternion + affine translation
    struct.pack_into("<6f", hdr, 256, 0.0, 0.0, 0.0,
                     affine[0, 3], affine[1, 3], affine[2, 3])
    struct.pack_into("<4f", hdr, 280, *affine[0])             # srow_x
    struct.pack_into("<4f", hdr, 296, *affine[1])             # srow_y
    struct.pack_into("<4f", hdr, 312, *affine[2])             # srow_z
    hdr[344:348] = b"n+1\x00"                                 # magic

    with _open(path, "wb") as f:
        f.write(bytes(hdr))
        f.write(b"\x00\x00\x00\x00")                          # extensions
        f.write(np.asfortranarray(data).tobytes(order="F"))


def read_nifti(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Read a NIfTI-1 file -> (data in (X, Y, Z[, T]) order, affine)."""
    with _open(path, "rb") as f:
        raw = f.read()
    hdr = raw[:348]
    (sizeof_hdr,) = struct.unpack_from("<i", hdr, 0)
    endian = "<" if sizeof_hdr == 348 else ">"
    dim = struct.unpack_from(endian + "8h", hdr, 40)
    (datatype,) = struct.unpack_from(endian + "h", hdr, 70)
    (vox_offset,) = struct.unpack_from(endian + "f", hdr, 108)
    (scl_slope,) = struct.unpack_from(endian + "f", hdr, 112)
    (scl_inter,) = struct.unpack_from(endian + "f", hdr, 116)
    (sform_code,) = struct.unpack_from(endian + "h", hdr, 254)
    shape = tuple(dim[1:1 + dim[0]])
    dtype = np.dtype(_DTYPES[datatype]).newbyteorder(endian)
    data = np.frombuffer(raw, dtype=dtype, count=int(np.prod(shape)),
                         offset=int(vox_offset)).reshape(shape, order="F")
    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        slope = scl_slope if scl_slope != 0.0 else 1.0
        data = data * slope + scl_inter
    affine = np.eye(4, dtype=np.float32)
    if sform_code > 0:
        affine[0] = struct.unpack_from(endian + "4f", hdr, 280)
        affine[1] = struct.unpack_from(endian + "4f", hdr, 296)
        affine[2] = struct.unpack_from(endian + "4f", hdr, 312)
    return np.ascontiguousarray(data), affine


def _read(path: str) -> Tuple[np.ndarray, np.ndarray]:
    r = native_io.read_nifti(path)
    return r if r is not None else read_nifti(path)


def load_volume(path: str) -> np.ndarray:
    """(X, Y, Z) float32 volume from a NIfTI file."""
    return np.ascontiguousarray(_read(path)[0], dtype=np.float32)


def load_affine(path: str) -> np.ndarray:
    return _read(path)[1]


def save_nifti(path: str, vol_xyz: np.ndarray, affine=None) -> None:
    if not native_io.write_nifti(path, vol_xyz, affine):
        write_nifti(path, vol_xyz, affine)


def dhw_to_xyz(vol_dhw: np.ndarray) -> np.ndarray:
    """(D, H, W) device layout -> (X, Y, Z) NIfTI layout."""
    return np.transpose(np.asarray(vol_dhw), (2, 1, 0))


def zoom2x_inplane_xyz(vol_xyz: np.ndarray, order: int = 1) -> np.ndarray:
    """x2 in-plane zoom of an (X, Y, Z) volume back to native resolution
    (the testers' ``ndi.zoom(image, (2, 2, 1))``), in numpy."""
    return zoom_inplane_xyz(vol_xyz, 2.0, order)
