"""Gaussian smoothing, trilinear sampling and elastic displacement fields
(port of ops/warp.py).

The CAE's training augmentation (the reference's Simard-2003 elastic
deformation): three uniform[-1, 1] noise fields, Gaussian-blurred with a
zero boundary (sigma 4), scaled by alpha (100), the depth field scaled by a
further 0.22, and applied with a trilinear warp whose points outside the
volume read a constant.  The JAX package draws the noise inside
``elastic_fields`` from a key; here the two halves are apart:
:func:`elastic_noise` is the sampler (an explicit ``torch.Generator``) and
:func:`elastic_fields` the deterministic core, which the tests feed the JAX
package's noise.  All of it is plain PyTorch: the JAX package leaves it to
XLA, outside any Pallas kernel.  The blur is one banded matmul an axis, in
the input's type (float32 matmuls without TF32 on the card).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from stroke_prediction_tpu_torch.parallel import spatial


def gaussian_kernel1d(sigma: float, truncate: float = 4.0,
                      device=None) -> torch.Tensor:
    """scipy's 1-D Gaussian kernel (radius ``int(truncate * sigma + 0.5)``),
    float32, summing to 1."""
    radius = int(truncate * float(sigma) + 0.5)
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / torch.sum(k)


def _band(kernel: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """(n, n) matrix M with ``(v @ M)[j] = sum_i v[i] k[r + j - i]``: the
    correlation with the zero-padded kernel along one axis of length n."""
    r = kernel.shape[0] // 2
    i = torch.arange(n, device=kernel.device)
    off = i[None, :] - i[:, None] + r                # j - i + r at [i, j]
    inside = (off >= 0) & (off <= 2 * r)
    return torch.where(inside, kernel[off.clamp(0, 2 * r)],
                       torch.zeros((), dtype=kernel.dtype,
                                   device=kernel.device)).to(dtype)


def gaussian_filter3d(x: torch.Tensor, sigma: float, truncate: float = 4.0,
                      axes: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Separable 3-D Gaussian blur with a zero ('constant') boundary, over
    ``axes`` (default the last three): scipy's
    ``gaussian_filter(mode='constant')``."""
    if axes is None:
        axes = (x.ndim - 3, x.ndim - 2, x.ndim - 1)
    k = gaussian_kernel1d(sigma, truncate, x.device)
    for ax in axes:
        moved = torch.movedim(x, ax, -1)
        moved = torch.matmul(moved, _band(k, moved.shape[-1], x.dtype))
        x = torch.movedim(moved, -1, ax)
    return x


def map_coordinates_batch(volume: torch.Tensor, coords: torch.Tensor,
                          cval: float = 0.0) -> torch.Tensor:
    """:func:`map_coordinates_linear` of a batch: (B, D, H, W, C) volumes at
    (B, 3, *S) points -> (B, *S, C); a sample's channels share its
    points.

    Under a spatial step ``volume`` is this rank's block of H and the
    points' H coordinates are global: "outside" is tested against the
    global extent, and the rows that the points' cells span are fetched
    from their owners (``parallel.spatial.rows_spanning``), so that each
    point reads what it reads in one process."""
    b, d, h, w, c = volume.shape
    if spatial.active():
        h = spatial.height(volume)
    cz, cy, cx = coords[:, 0], coords[:, 1], coords[:, 2]
    # scipy 'constant': a point outside the volume reads cval outright
    inside = ((cz >= 0) & (cz <= d - 1) & (cy >= 0) & (cy <= h - 1)
              & (cx >= 0) & (cx <= w - 1))
    czc, cyc, cxc = (torch.clamp(v, 0, n - 1)
                     for v, n in ((cz, d), (cy, h), (cx, w)))
    z0 = torch.clamp(torch.floor(czc), 0, d - 2)
    y0 = torch.clamp(torch.floor(cyc), 0, h - 2)
    x0 = torch.clamp(torch.floor(cxc), 0, w - 2)
    wz = (czc - z0).to(volume.dtype)[..., None]
    wy = (cyc - y0).to(volume.dtype)[..., None]
    wx = (cxc - x0).to(volume.dtype)[..., None]
    if spatial.active():
        a = int(y0.min()) if y0.numel() else 0
        b_ = int(y0.max()) + 2 if y0.numel() else 0
        volume = spatial.rows_spanning(volume, h, a, b_)
        y0, h = y0 - a, b_ - a
    shape = cz.shape                                       # (B, *S)
    first = torch.arange(b, device=volume.device).reshape(
        (b,) + (1,) * (len(shape) - 1)) * (d * h * w)
    base = (first + ((z0 * h + y0) * w + x0).long()).reshape(-1)
    flat = volume.reshape(b * d * h * w, c)

    def gather(off):
        return flat.index_select(0, base + off).reshape(shape + (c,))

    hw = h * w
    out = (gather(0) * (1 - wz) * (1 - wy) * (1 - wx)
           + gather(1) * (1 - wz) * (1 - wy) * wx
           + gather(w) * (1 - wz) * wy * (1 - wx)
           + gather(w + 1) * (1 - wz) * wy * wx
           + gather(hw) * wz * (1 - wy) * (1 - wx)
           + gather(hw + 1) * wz * (1 - wy) * wx
           + gather(hw + w) * wz * wy * (1 - wx)
           + gather(hw + w + 1) * wz * wy * wx)
    return torch.where(inside[..., None], out,
                       torch.full((), cval, dtype=volume.dtype,
                                  device=volume.device))


def map_coordinates_linear(volume: torch.Tensor, coords: torch.Tensor,
                           cval: float = 0.0) -> torch.Tensor:
    """Trilinear sampling of a (D, H, W) ``volume`` at ``coords`` (3, *S),
    ``coords[k]`` the axis-k positions: scipy's ``map_coordinates(order=1,
    mode='constant')``; points outside the volume read ``cval``."""
    return map_coordinates_batch(volume[None, ..., None], coords[None],
                                 cval)[0, ..., 0]


def elastic_noise(generator: torch.Generator, batch: int,
                  shape: Tuple[int, int, int],
                  dtype=torch.float32) -> torch.Tensor:
    """The sampler: (B, 3, D, H, W) uniform[-1, 1) noise on the generator's
    device."""
    u = torch.rand((batch, 3) + tuple(shape), generator=generator,
                   device=generator.device, dtype=dtype)
    return u * 2.0 - 1.0


def elastic_fields(noise: torch.Tensor, alpha: float = 100.0,
                   sigma: float = 4.0, z_scale: float = 0.22
                   ) -> torch.Tensor:
    """The deterministic core: (..., 3, D, H, W) noise -> displacement
    fields of the same shape, ``blur(noise) * alpha`` with the depth (z)
    field further scaled by ``z_scale`` (0.22, about 28 / 128, the voxel
    spacing's ratio)."""
    blurred = gaussian_filter3d(noise, sigma) * alpha
    # made on the device (no host copy, so a captured step replays it)
    scale = torch.ones((3, 1, 1, 1), dtype=noise.dtype, device=noise.device)
    scale[0] = z_scale
    return blurred * scale
