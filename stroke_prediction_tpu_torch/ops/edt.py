"""Exact separable Euclidean distance transforms (port of ops/edt.py).

Algorithm, as in the JAX package: along the first EDT axis the squared
distance to the nearest site of the voxel's line (``_BIG`` where the line
has none); along every further axis one lower-envelope-of-parabolas pass
``out(i) = min_j f(j) + (i-j)^2`` (K5); then the square root.  Squared
distances are integers below 2^24 (or the ``_BIG`` clamp), so float32 is
exact and the kernels equal the plain version bit for bit.

On the card :func:`edt_sites` runs the whole transform over the last three
axes in two hand-written kernels (``csrc/edt_sites.cu``): the scan along D
fused with the pass along H, and the pass along W fused with the sqrt; they
read the (contiguous) mask in place.  :func:`edt_sites_plain` is the same transform in
plain PyTorch (a two-sided ``torch.cummax`` scan and broadcast-min passes);
CPU tensors run it.  :func:`edt_parabola` is one pass along a contiguous
last axis (the W kernel without the sqrt).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from stroke_prediction_tpu_torch.ops import _build

_BIG = 1e12  # effectively-infinite squared distance (ops/edt.py _BIG)
_MAX_EXTENT = 1024   # the kernels' largest D, H, W (and pass length)


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


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


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
    if not 1 <= n <= _MAX_EXTENT:
        raise ValueError(f"edt_parabola kernel takes 1 <= n <= "
                         f"{_MAX_EXTENT}, got {n}")
    out = torch.empty_like(lines)
    if n_lines == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(lines.device):
        err = lib.edt_parabola_f32(lines.data_ptr(), out.data_ptr(), n_lines,
                                   n, _stream(lines))
    _build.check("edt_parabola_f32", err)
    edt_parabola.launches += 1
    return out


edt_parabola.launches = 0   # kernel launches since the caller last reset it


def parabola_pass(f2: torch.Tensor, axis: int,
                  line_pass: Callable[[torch.Tensor], torch.Tensor]
                  = edt_parabola) -> torch.Tensor:
    """One separable squared-EDT pass along ``axis``: ``line_pass`` over
    the lines moved to the last axis and made contiguous."""
    moved = torch.movedim(f2, axis, -1)
    lead = moved.shape[:-1]
    out = line_pass(moved.reshape(-1, moved.shape[-1]).contiguous())
    return torch.movedim(out.reshape(lead + (moved.shape[-1],)), -1, axis)


def _squared_edt(sites: torch.Tensor, axes: Sequence[int],
                 line_pass: Callable[[torch.Tensor], torch.Tensor]
                 ) -> torch.Tensor:
    first, *rest = axes
    d = _nearest_site_dist1d(sites, first)
    f2 = torch.clamp(d * d, max=_BIG)
    for ax in rest:
        f2 = parabola_pass(f2, ax, line_pass)
    return f2


def separable_edt(sites: torch.Tensor, axes: Sequence[int],
                  line_pass: Callable[[torch.Tensor], torch.Tensor]
                  ) -> torch.Tensor:
    """The transform as a composition: the nearest-site scan along
    ``axes[0]``, the clamp, one :func:`parabola_pass` with ``line_pass``
    along each further axis, the sqrt."""
    return torch.sqrt(_squared_edt(sites, axes, line_pass))


def edt_sites_plain(sites: torch.Tensor,
                    axes: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Plain version of :func:`edt_sites` (any ``axes``; by default the
    last three) on any device.  The square root is taken in float64 and
    rounded once to float32, so it is correctly rounded on every device,
    as the kernels' ``sqrtf`` and XLA's are (a CPU build of torch rounds
    its float32 sqrt one ulp off for some integers, e.g. 267)."""
    if axes is None:
        axes = tuple(range(sites.ndim - 3, sites.ndim))
    f2 = _squared_edt(sites, axes, edt_parabola_plain)
    return torch.sqrt(f2.double()).to(f2.dtype)


def edt_sites(sites: torch.Tensor) -> torch.Tensor:
    """Distance of every voxel to the nearest True voxel of the bool mask
    ``sites`` over its last three axes (D, H, W, each 1 to 1024); leading
    axes batch.  A CUDA tensor launches the two kernels of
    ``csrc/edt_sites.cu`` (or raises), reading the mask in place (a
    non-contiguous one is copied first); a CPU tensor runs
    :func:`edt_sites_plain`."""
    if sites.ndim < 3:
        raise ValueError(f"sites must have at least 3 axes, got "
                         f"{tuple(sites.shape)}")
    if sites.device.type == "cpu":
        return edt_sites_plain(sites)
    if sites.device.type != "cuda":
        raise ValueError(f"edt_sites runs on cuda or cpu, not "
                         f"{sites.device}")
    if sites.dtype != torch.bool:
        raise TypeError(f"edt_sites kernel takes a bool mask, got "
                        f"{sites.dtype}")
    dhw = tuple(sites.shape[-3:])
    if not all(1 <= v <= _MAX_EXTENT for v in dhw):
        raise ValueError(f"edt_sites kernel takes 1 <= D, H, W <= "
                         f"{_MAX_EXTENT}, got {dhw}")
    s4 = sites.reshape((-1,) + dhw).contiguous()
    out = torch.empty(s4.shape, dtype=torch.float32, device=sites.device)
    n = s4.shape[0]
    if n == 0:
        return out.reshape(sites.shape)
    if n > 65535:
        raise ValueError(f"edt_sites kernel takes at most 65535 volumes, "
                         f"got {n}")
    tmp = torch.empty_like(out)
    lib = _build.library()
    with torch.cuda.device(sites.device):
        err = lib.edt_sites_f32(s4.data_ptr(), out.data_ptr(),
                                tmp.data_ptr(), n, *dhw, _stream(sites))
    _build.check("edt_sites_f32", err)
    edt_sites.launches += 1
    return out.reshape(sites.shape)


edt_sites.launches = 0      # calls (two kernels each) since the last reset


def _edt_from_sites(sites: torch.Tensor,
                    axes: Sequence[int] = (0, 1, 2)) -> torch.Tensor:
    if sites.device.type == "cpu":
        return edt_sites_plain(sites, axes)
    nd = sites.ndim
    if tuple(a % nd for a in axes) != tuple(range(nd - 3, nd)):
        raise ValueError(f"on {sites.device} the EDT axes must be the last "
                         f"three axes of the mask, got axes {tuple(axes)} "
                         f"of a {nd}-axis mask")
    return edt_sites(sites)


def edt_to_sites(sites: torch.Tensor,
                 axes: Sequence[int] = (0, 1, 2)) -> torch.Tensor:
    """Distance of every voxel to the nearest True voxel in ``sites``, over
    the given (by default the first three) axes; further axes batch.  On
    the card the axes must be the last three (leading axes batch)."""
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
