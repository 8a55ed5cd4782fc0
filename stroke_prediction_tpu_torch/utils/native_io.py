"""ctypes binding of the port's native NIfTI-1 codec (port of
utils/native_io.py; the C++ source is ``utils/csrc/stroke_io.cpp``).

The library is built at first use with ``g++ -O3 -fPIC -shared -std=c++17
... -lz`` into ``build/torch_native/`` beside the package (listed in
``.gitignore``), keyed by a hash of the source and the flags, and written
atomically (a temporary file, then a rename), so processes that build at the
same time do not clash.  Nothing is built at import.

The codec runs on the host.  When it cannot be built or loaded,
:func:`available` is false, :func:`build_error` says why, and the entry
points return None / False, so ``utils/nifti.py`` falls back to its
pure-Python codec, as the JAX package does.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "stroke_io.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-Wall"]
GZIP_LEVEL = 6          # the JAX codec's level for ``.gz``


def library_path(build_dir: Union[str, Path] = BUILD_DIR) -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return Path(build_dir) / f"libstroke_io_{h.hexdigest()[:16]}.so"


def build(build_dir: Union[str, Path] = BUILD_DIR) -> Path:
    """Compile the codec (if needed) and return its path; raises
    ``RuntimeError`` with the compiler's output when it cannot."""
    so = library_path(build_dir)
    if so.exists():
        return so
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH")
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"tmp_{so.stem}_{os.getpid()}.so")
    try:
        run = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE),
                              "-lz"], capture_output=True, text=True,
                             timeout=300)
        if run.returncode:
            raise RuntimeError(f"g++ failed (rc {run.returncode}): "
                               f"{run.stderr.strip()}")
        os.replace(tmp, so)
    finally:
        tmp.unlink(missing_ok=True)
    return so


class NativeCodec:
    """The codec built into (or loaded from) ``build_dir``; ``error`` holds
    the reason when it is not available."""

    def __init__(self, build_dir: Union[str, Path] = BUILD_DIR):
        self.error: Optional[str] = None
        self._lib = None
        try:
            lib = ctypes.CDLL(str(build(build_dir)))
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            self.error = str(e)
            return
        lib.sp_nifti_header.restype = ctypes.c_int
        lib.sp_nifti_header.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64)]
        lib.sp_nifti_read_f32.restype = ctypes.c_int
        lib.sp_nifti_read_f32.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
        lib.sp_nifti_write_f32.restype = ctypes.c_int
        lib.sp_nifti_write_f32.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int]
        self._lib = lib

    @property
    def available(self) -> bool:
        return self._lib is not None

    def read_nifti(self, path: str
                   ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """(data (X, Y, Z[, T]) float32, 4x4 affine), or None where the
        codec is not available or cannot read the file."""
        if self._lib is None:
            return None
        dims = (ctypes.c_int64 * 8)()
        aff = (ctypes.c_float * 12)()
        voxels = ctypes.c_int64()
        if self._lib.sp_nifti_header(path.encode(), dims, aff,
                                     ctypes.byref(voxels)):
            return None
        shape = tuple(int(dims[i + 1]) for i in range(int(dims[0])))
        out = np.empty(int(voxels.value), np.float32)
        if self._lib.sp_nifti_read_f32(
                path.encode(),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), voxels):
            return None
        affine = np.eye(4, dtype=np.float32)
        affine[:3, :] = np.frombuffer(aff, np.float32).reshape(3, 4)
        return out.reshape(shape, order="F"), affine

    def write_nifti(self, path: str, data: np.ndarray,
                    affine: Optional[np.ndarray] = None) -> bool:
        """Write ``data`` as float32 NIfTI-1 (gzip level 6 for ``.gz``);
        False where the codec is not available or the write failed."""
        if self._lib is None:
            return False
        data = np.asarray(data, np.float32)
        if not 1 <= data.ndim <= 7:
            raise ValueError(f"NIfTI holds 1-7 dimensions, got {data.ndim}")
        if affine is None:
            affine = np.eye(4, dtype=np.float32)
        aff12 = np.ascontiguousarray(
            np.asarray(affine, np.float32)[:3, :]).ravel()
        dims = (ctypes.c_int64 * 7)(*data.shape)
        flat = data.ravel(order="F")         # Fortran voxel order
        rc = self._lib.sp_nifti_write_f32(
            path.encode(), flat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            dims, data.ndim,
            aff12.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            GZIP_LEVEL if path.endswith(".gz") else 0)
        return rc == 0


@functools.lru_cache(maxsize=1)
def default_codec() -> NativeCodec:
    """The process's codec in ``build/torch_native/``, built at first use."""
    return NativeCodec()


def available() -> bool:
    return default_codec().available


def build_error() -> Optional[str]:
    """Why the native codec is not in use, or None when it is."""
    return default_codec().error


def read_nifti(path: str) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    return default_codec().read_nifti(path)


def write_nifti(path: str, data: np.ndarray,
                affine: Optional[np.ndarray] = None) -> bool:
    return default_codec().write_nifti(path, data, affine)
