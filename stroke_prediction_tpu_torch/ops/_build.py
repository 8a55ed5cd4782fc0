"""Builds the port's CUDA kernels with ``nvcc`` and binds them via ``ctypes``.

Every ``ops/csrc/*.cu`` file is compiled for Hopper (``sm_90a``) by its own
``nvcc`` process, all started together, and the objects are linked into one
shared library with a plain C interface.  The library lands in
``build/torch_kernels/`` beside the package (listed in ``.gitignore``), keyed
by a hash of the sources, the headers they share (``csrc/*.cuh``) and the
flags, so a process builds at most once and a changed file always
rebuilds.  The first CUDA call of any kernel wrapper
triggers the build; nothing happens at import time.

There is no fallback: when ``nvcc`` is missing or fails, :func:`library`
raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                              "-Xptxas=-v"]

_P, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
_FWD = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P]
_BWD_FUSED = [_P] * 9 + [_I] * 9 + [_F, _I, _P]
_BWD_DX = [_P] * 4 + [_I] * 8 + [_F, _P]
_BWD_DW = [_P] * 7 + [_I] * 9 + [_F, _I, _P]
# C entry points: name -> argtypes (all return a cudaError_t as int)
SIGNATURES = {
    # x, kernel, bias, y, batch, d_in, h, w, c_in, c_out, z_pad,
    # bias_table, act, alpha, stream
    "conv3x3_fwd_f32": _FWD,
    "conv3x3_fwd_bf16": _FWD,
    # with_dx, bf16, batch, d_in, h, w, c_in, c_out, z_pad -> *n_tiles,
    # *n_blocks
    "conv3x3_bwd_plan": [_I] * 9 + [ctypes.POINTER(_LL),
                                    ctypes.POINTER(_I)],
    # x, kernel, y, g, dx, dk, db, partials, db partials, batch, d_in, h, w,
    # c_in, c_out, z_pad, bias_table, act, alpha, n_blocks, stream
    "conv3x3_bwd_fused_f32": _BWD_FUSED,
    "conv3x3_bwd_fused_bf16": _BWD_FUSED,
    # kernel, y, g, dx, batch, d_in, h, w, c_in, c_out, z_pad, act, alpha,
    # stream
    "conv3x3_bwd_dx_f32": _BWD_DX,
    "conv3x3_bwd_dx_bf16": _BWD_DX,
    # x, y, g, dk, db, partials, db partials, batch, d_in, h, w, c_in, c_out,
    # z_pad, bias_table, act, alpha, n_blocks, stream
    "conv3x3_bwd_dw_f32": _BWD_DW,
    "conv3x3_bwd_dw_bf16": _BWD_DW,
    # f, out, n_lines, n, stream
    "edt_parabola_f32": [_P, _P, _LL, _I, _P],
}


def sources() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (neither on PATH nor under CUDA_HOME); "
                       "the port's CUDA kernels cannot be built")


def _key(srcs: List[Path]) -> str:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for src in srcs + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libstroke_kernels_{_key(sources())}.so"


def build() -> Path:
    """Compile (if needed) and return the path of the kernel library.  The
    compiler's output (``-Xptxas=-v`` register / shared-memory report) is
    kept beside it as ``<library>.log``."""
    so = library_path()
    if so.exists():
        return so
    nvcc = _nvcc()
    tmp = BUILD_DIR / f"tmp_{so.stem}_{os.getpid()}"
    tmp.mkdir(parents=True, exist_ok=True)
    try:
        jobs = []
        for src in sources():
            obj = tmp / (src.stem + ".o")
            cmd = [nvcc, *COMPILE_FLAGS, "-c", str(src), "-o", str(obj)]
            jobs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = [], []
        for src, _, proc in jobs:
            out, _ = proc.communicate()
            log.append(f"== nvcc {src.name} (rc {proc.returncode})\n{out}")
            if proc.returncode:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
        tmp_so = tmp / so.name
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_so),
             *(str(obj) for _, obj, _ in jobs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(f"== link (rc {link.returncode})\n{link.stdout}")
        if link.returncode:
            raise RuntimeError("linking the kernel library failed:\n"
                               + "\n".join(log))
        so.with_suffix(".log").write_text("\n".join(log))
        os.replace(tmp_so, so)       # atomic: concurrent builds are safe
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return so


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library with every entry point's argtypes set."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(name: str, err: int) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")
