"""Exact separable Euclidean distance transforms (port of ops/edt.py).

Algorithm, as in the JAX package: axis 0 is an O(n) two-sided nearest-site
scan (``torch.cummax``, plain PyTorch); every further axis is one
lower-envelope-of-parabolas pass ``out(i) = min_j f(j) + (i-j)^2``, which
runs in the hand-written kernel K5 (:func:`edt_parabola`, CUDA C++ in
``csrc/edt_parabola.cu``) on the card and in :func:`edt_parabola_plain` on
the CPU.  Squared distances are integers below 2^24 (or the ``_BIG`` clamp),
so float32 is exact and the kernel equals the plain version bit for bit.
"""

from __future__ import annotations

from typing import Sequence

import torch

from stroke_prediction_tpu_torch.ops import _build

_BIG = 1e12  # effectively-infinite squared distance (ops/edt.py _BIG)


def _nearest_site_dist1d(sites: torch.Tensor, axis: int) -> torch.Tensor:
    """Per-voxel distance (in voxels) along ``axis`` to the nearest True in
    ``sites``; lines without a site get ~_BIG (squared above the clamp)."""
    n = sites.shape[axis]
    shape = [1] * sites.ndim
    shape[axis] = n
    idx = torch.arange(n, dtype=torch.float32,
                       device=sites.device).reshape(shape).expand(sites.shape)
    neg = torch.full_like(idx, -_BIG)
    # nearest site to the left: cummax carries the largest site index <= i
    left = torch.cummax(torch.where(sites, idx, neg), dim=axis).values
    # nearest site to the right: carry -(smallest site index >= i)
    right_neg = torch.flip(torch.cummax(
        torch.flip(torch.where(sites, -idx, neg), (axis,)), dim=axis).values,
        (axis,))
    return torch.minimum(idx - left, -right_neg - idx)


def edt_parabola_plain(lines: torch.Tensor, chunk: int = 64) -> torch.Tensor:
    """Plain version of :func:`edt_parabola`: the chunked broadcast-min of
    ``_parabola_pass_xla`` over (n_lines, n) lines."""
    n = lines.shape[1]
    i = torch.arange(n, dtype=lines.dtype, device=lines.device)
    d2 = (i[:, None] - i[None, :]) ** 2                  # (n_out, n_in)
    out = torch.empty_like(lines)
    for s in range(0, lines.shape[0], chunk):
        c = lines[s:s + chunk]
        out[s:s + chunk] = torch.amin(c[:, None, :] + d2[None], dim=-1)
    return out


def edt_parabola(lines: torch.Tensor) -> torch.Tensor:
    """``out[l, i] = min_j lines[l, j] + (i - j)^2`` over (n_lines, n)
    float32 lines.  CUDA tensors launch the kernel (or raise); CPU tensors
    run :func:`edt_parabola_plain`."""
    if lines.ndim != 2:
        raise ValueError(f"lines must be (n_lines, n), got "
                         f"{tuple(lines.shape)}")
    if lines.device.type == "cpu":
        return edt_parabola_plain(lines)
    if lines.device.type != "cuda":
        raise ValueError(f"edt_parabola runs on cuda or cpu, not "
                         f"{lines.device}")
    if lines.dtype != torch.float32:
        raise TypeError(f"edt_parabola kernel takes float32, got "
                        f"{lines.dtype}")
    if not lines.is_contiguous():
        raise ValueError("edt_parabola kernel needs contiguous lines")
    n_lines, n = lines.shape
    if not 1 <= n <= 1024:
        raise ValueError(f"edt_parabola kernel takes 1 <= n <= 1024, got {n}")
    out = torch.empty_like(lines)
    if n_lines == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(lines.device):
        stream = torch.cuda.current_stream(lines.device).cuda_stream
        err = lib.edt_parabola_f32(lines.data_ptr(), out.data_ptr(), n_lines,
                                   n, stream)
    _build.check("edt_parabola_f32", err)
    edt_parabola.launches += 1
    return out


edt_parabola.launches = 0   # kernel launches since the caller last reset it


def parabola_pass(f2: torch.Tensor, axis: int) -> torch.Tensor:
    """One separable squared-EDT pass along ``axis`` (one kernel launch)."""
    moved = torch.movedim(f2, axis, -1)
    lead = moved.shape[:-1]
    out = edt_parabola(moved.reshape(-1, moved.shape[-1]).contiguous())
    return torch.movedim(out.reshape(lead + (moved.shape[-1],)), -1, axis)


def _edt_from_sites(sites: torch.Tensor,
                    axes: Sequence[int] = (0, 1, 2)) -> torch.Tensor:
    first, *rest = axes
    d = _nearest_site_dist1d(sites, first)
    f2 = torch.clamp(d * d, max=_BIG)
    for ax in rest:
        f2 = parabola_pass(f2, ax)
    return torch.sqrt(f2)


def edt_to_sites(sites: torch.Tensor,
                 axes: Sequence[int] = (0, 1, 2)) -> torch.Tensor:
    """Distance of every voxel to the nearest True voxel in ``sites``, over
    the given (by default the first three) axes; further axes batch."""
    return _edt_from_sites(sites.to(torch.bool), axes)


def distance_transform_edt(x: torch.Tensor) -> torch.Tensor:
    """Distance from each non-zero voxel of a 3-D volume to the nearest zero
    voxel; zero elsewhere (scipy ``distance_transform_edt`` semantics, with
    the JAX package's _BIG-scale values for a volume without zeros)."""
    sites = torch.logical_not(x.to(torch.bool))
    dist = _edt_from_sites(sites)
    return torch.where(sites, torch.zeros_like(dist), dist)


def signed_edt(mask: torch.Tensor, threshold: float = 0.5) -> torch.Tensor:
    """Signed distance map: positive inside ``mask > threshold``, negative
    outside."""
    inside = mask > threshold
    return distance_transform_edt(inside) - distance_transform_edt(
        torch.logical_not(inside))
