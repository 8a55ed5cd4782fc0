"""Resize / zoom / crop over channels-last volumes (port of ops/resize.py).

Per-axis linear resizes are small dense (out, n) matrices contracted on the
target axis, as in the JAX package: ``align_corners=True`` matches torch-0.3
trilinear upsampling and scipy zoom's grid.  :func:`zoom_inplane_xyz` is the
numpy form the host-side data and NIfTI code use.

Under a spatial step (H sharded over the ranks, ``parallel/spatial.py``)
:func:`upsample2x_trilinear` and :func:`center_crop` compute this rank's
block of their output along H from the input rows it reads, fetched from
their owners: the upsample with the rows of the global ``(2h, h)`` matrix
that the block owns, the crop at the global offset.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from stroke_prediction_tpu_torch.parallel import spatial


@functools.lru_cache(maxsize=None)
def _linear_matrix(n: int, out_size: int, align_corners: bool) -> np.ndarray:
    """Dense (out_size, n) 1-D linear-interpolation matrix."""
    if align_corners:
        coords = np.linspace(0.0, n - 1.0, out_size)
    else:
        coords = np.clip((np.arange(out_size) + 0.5) * (n / out_size) - 0.5,
                         0.0, n - 1.0)
    i0 = np.clip(np.floor(coords).astype(np.int64), 0, max(n - 2, 0))
    w = coords - i0
    m = np.zeros((out_size, n), np.float32)
    rows = np.arange(out_size)
    m[rows, i0] = 1.0 - w
    if n > 1:
        m[rows, i0 + 1] += w
    return m


@functools.lru_cache(maxsize=None)
def _nearest_matrix(n: int, out_size: int) -> np.ndarray:
    # scipy order-0 zoom convention: index = round(i * (n-1)/(out-1))
    if out_size == 1:
        idx = np.array([0], np.int64)
    else:
        idx = np.round(np.linspace(0.0, n - 1.0, out_size)).astype(np.int64)
    m = np.zeros((out_size, n), np.float32)
    m[np.arange(out_size), idx] = 1.0
    return m


@functools.lru_cache(maxsize=None)
def _device_matrix(n: int, out_size: int, order: int, align_corners: bool,
                   dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The (out_size, n) resize matrix (``order`` 0: nearest, 1: linear)
    in ``dtype`` on ``device``, made and copied there once.  Kept for the
    process's life, without a bound: a CUDA graph that captured a step goes
    on reading this tensor at every replay, so it must never be freed, and
    a step copies nothing from the host.  A normal tensor even when first
    made under ``torch.inference_mode`` (a tester), so that autograd may
    use it later."""
    m = (_nearest_matrix(n, out_size) if order == 0
         else _linear_matrix(n, out_size, align_corners))
    with torch.inference_mode(False):
        return torch.as_tensor(m, dtype=dtype, device=device)


def _apply_axis_matrix(x: torch.Tensor, w: torch.Tensor,
                       axis: int) -> torch.Tensor:
    return torch.movedim(torch.tensordot(x, w, dims=([axis], [1])), -1, axis)


def _axis_linear(x: torch.Tensor, axis: int, out_size: int,
                 align_corners: bool = True) -> torch.Tensor:
    n = x.shape[axis]
    if out_size == n:
        return x
    return _apply_axis_matrix(
        x, _device_matrix(n, out_size, 1, align_corners, x.dtype, x.device),
        axis)


def resize_linear(x: torch.Tensor, out_sizes: Sequence[int],
                  axes: Sequence[int],
                  align_corners: bool = True) -> torch.Tensor:
    """Separable multilinear resize of the given axes to ``out_sizes``."""
    for ax, s in zip(axes, out_sizes):
        x = _axis_linear(x, ax, s, align_corners)
    return x


def resize_nearest(x: torch.Tensor, out_sizes: Sequence[int],
                   axes: Sequence[int]) -> torch.Tensor:
    for ax, s in zip(axes, out_sizes):
        if s != x.shape[ax]:
            x = _apply_axis_matrix(x, _device_matrix(
                x.shape[ax], s, 0, True, x.dtype, x.device), ax)
    return x


def zoom_inplane(x: torch.Tensor, factor: float, order: int = 1,
                 hw_axes: Tuple[int, int] = None) -> torch.Tensor:
    """In-plane (H, W) zoom of a ``(..., D, H, W, C)`` volume; output sizes
    follow scipy's ``round(size * factor)``."""
    if hw_axes is None:
        hw_axes = (x.ndim - 3, x.ndim - 2)
    out = tuple(int(round(x.shape[a] * factor)) for a in hw_axes)
    if order == 0:
        return resize_nearest(x, out, hw_axes)
    return resize_linear(x, out, hw_axes, align_corners=True)


def zoom_inplane_xyz(vol_xyz: np.ndarray, factor: float,
                     order: int) -> np.ndarray:
    """numpy in-plane (X, Y) zoom of an (X, Y, Z) volume with the same
    matrices (the data layer's resample and the testers' x2 zoom back)."""
    x, y, _ = vol_xyz.shape
    ox, oy = int(round(x * factor)), int(round(y * factor))
    if order == 0:
        mx, my = _nearest_matrix(x, ox), _nearest_matrix(y, oy)
    else:
        mx, my = _linear_matrix(x, ox, True), _linear_matrix(y, oy, True)
    v = vol_xyz.astype(np.float32, copy=False)
    v = np.tensordot(mx, v, axes=([1], [0]))
    v = np.tensordot(my, v, axes=([1], [1])).transpose(1, 0, 2)
    return np.ascontiguousarray(v)


def _input_span(m: np.ndarray, lo: int, hi: int) -> Tuple[int, int]:
    """The input rows ``[a, b)`` that output rows ``[lo, hi)`` of the
    resize matrix ``m`` read."""
    cols = np.flatnonzero(m[lo:hi].any(axis=0))
    return int(cols[0]), int(cols[-1]) + 1


def upsample2x_trilinear(x: torch.Tensor) -> torch.Tensor:
    """x2 trilinear upsample of ``(B, D, H, W, C)`` (align_corners=True)."""
    d, h, w = x.shape[-4:-1]
    axes = (x.ndim - 4, x.ndim - 3, x.ndim - 2)
    if not spatial.active():
        return resize_linear(x, (2 * d, 2 * h, 2 * w), axes,
                             align_corners=True)
    h = spatial.height(x)
    m = _linear_matrix(h, 2 * h, True)
    x = spatial.rows(x, h, 2 * h, lambda lo, hi: _input_span(m, lo, hi))
    lo, hi = spatial.own_block(2 * h)
    a, b = _input_span(m, lo, hi) if hi > lo else (0, 0)
    x = _axis_linear(x, axes[0], 2 * d)
    mat = _device_matrix(h, 2 * h, 1, True, x.dtype, x.device)
    x = _apply_axis_matrix(x, mat[lo:hi, a:b], axes[1])
    return spatial.record(_axis_linear(x, axes[2], 2 * w), 2 * h)


def center_crop(x: torch.Tensor,
                target_spatial: Sequence[int]) -> torch.Tensor:
    """Center-crop the spatial (D, H, W) axes of ``(B, D, H, W, C)`` (H
    global under a spatial step, where each rank keeps its block of the
    cropped H)."""
    axes = (x.ndim - 4, x.ndim - 3, x.ndim - 2)
    target = list(target_spatial)
    if spatial.active():
        h, t = spatial.height(x), target[1]
        x = spatial.crop_rows(x, h, t, (h - t) // 2)
        target[1] = x.shape[axes[1]]
    slices = [slice(None)] * x.ndim
    for ax, t in zip(axes, target):
        start = (x.shape[ax] - t) // 2
        slices[ax] = slice(start, start + t)
    y = x[tuple(slices)]
    return spatial.record(y, target_spatial[1]) if spatial.active() else y
