"""The signed-distance-map (SDM) shape-interpolation baseline (port of
eval/sdm.py): signed EDTs of the penumbra and core masks, an optional 1/12
in-plane "latent" downsample, the linear interpolation of the SDMs by the
normalized time to treatment, the zoom back, and the thresholds at 0.  When
the core mask is empty, an artificial core is placed at the penumbra's
centre of mass and dilated.

Plain functions on the masks' device.  The case's four EDTs run as one
:func:`~stroke_prediction_tpu_torch.ops.edt.edt_to_sites` call over the four
stacked masks (K5's kernels on the card, its plain version on the CPU);
the zooms are the resize matrices of :mod:`..ops.resize`.  A mask with no
zero voxel (an empty penumbra's ``penu < threshold``) has no site and
gives the ``_BIG``-scale distances of
:func:`~stroke_prediction_tpu_torch.ops.edt.distance_transform_edt`.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.nn.functional as F

from stroke_prediction_tpu_torch.ops.edt import edt_to_sites
from stroke_prediction_tpu_torch.ops.resize import resize_linear


def _binary_dilation_cross(mask: torch.Tensor,
                           iterations: int) -> torch.Tensor:
    """6-connectivity binary dilation of a (D, H, W) bool mask (scipy
    ``binary_dilation``'s default structure), zero boundary."""
    m = mask
    for _ in range(iterations):
        p = F.pad(m, (1, 1, 1, 1, 1, 1), value=False)
        m = (p[1:-1, 1:-1, 1:-1]
             | p[:-2, 1:-1, 1:-1] | p[2:, 1:-1, 1:-1]
             | p[1:-1, :-2, 1:-1] | p[1:-1, 2:, 1:-1]
             | p[1:-1, 1:-1, :-2] | p[1:-1, 1:-1, 2:])
    return m


def _artificial_core(penu_bin: torch.Tensor, dilate: int) -> torch.Tensor:
    """A single voxel at the penumbra's centre of mass, dilated.  The
    coordinate sums are exact (int64, whatever the order of the sums); each
    centre coordinate is their float32 quotient truncated, as the JAX
    package computes it from its float32 sums, which are exact while they
    stay below 2^24."""
    dev = penu_bin.device
    wsum = torch.clamp(penu_bin.sum(), min=1).to(torch.float32)
    axes = [torch.arange(n, dtype=torch.int64, device=dev) for n in
            penu_bin.shape]
    seed = torch.ones_like(penu_bin)
    for ax, idx in enumerate(axes):
        shape = [1, 1, 1]
        shape[ax] = -1
        coord = idx.reshape(shape)
        total = (coord * penu_bin).sum().to(torch.float32)
        centre = (total / wsum).to(torch.int64)
        seed = seed & (coord == centre)
    return _binary_dilation_cross(seed, dilate)


def _zoom_latent(vol: torch.Tensor, factor: float) -> torch.Tensor:
    """In-plane (H, W) zoom of a (D, H, W) volume, scipy's size
    convention."""
    out_h = int(round(vol.shape[1] * factor))
    out_w = int(round(vol.shape[2] * factor))
    return resize_linear(vol[..., None], (out_h, out_w), (1, 2))[..., 0]


def _fit_plane(up: torch.Tensor, target: Tuple[int, int]) -> torch.Tensor:
    """(D, H, W) centre-cropped where a plane axis overshoots ``target``
    (the reference's fixed ``[2:130]`` crop of 132-wide planes) and
    edge-padded where it undershoots."""
    for ax, want in zip((1, 2), target):
        cur = up.shape[ax]
        if cur > want:
            up = up.narrow(ax, (cur - want) // 2, want)
        elif cur < want:
            lo = (want - cur) // 2
            idx = torch.clamp(torch.arange(want, device=up.device) - lo, 0,
                              cur - 1)
            up = up.index_select(ax, idx)
    return up


def sdm_interpolate(core: torch.Tensor, penu: torch.Tensor,
                    interpolation: Union[float, torch.Tensor],
                    threshold: float = 0.5, zoom: int = 12, dilate: int = 3,
                    resample: bool = True) -> Tuple[torch.Tensor, ...]:
    """SDM interpolation of one (D, H, W) case at step ``interpolation``
    (rounded to float32).

    Returns (recon_core, recon_intp, recon_penu, latent_core, latent_intp,
    latent_penu), float32 on the masks' device.  The reconstructions
    threshold as ``recon_intp > 0`` (lesion), ``recon_core < 0`` (core) and
    ``recon_penu > 0`` (penumbra): the penumbra SDM is ``edt(penu > thr) -
    edt(penu < thr)``, positive inside, and the core SDM ``edt(not core') -
    edt(core > thr)``, positive outside, where core' is the thresholded
    core or, when that is empty, the artificial core (the second term then
    reads the empty original)."""
    d, h, w = core.shape
    t = torch.as_tensor(interpolation, dtype=torch.float32,
                        device=core.device)
    penu_bin = penu > threshold
    core_bin = core > threshold
    art = _artificial_core(penu_bin, dilate)
    core_in = torch.where(core_bin.any(), core_bin, art)
    # distance_transform_edt of each: the distance to its nearest zero
    masks = torch.stack([penu_bin, penu < threshold,
                         torch.logical_not(core_in), core_bin])
    sites = torch.logical_not(masks)
    dist = torch.where(sites, 0.0, edt_to_sites(sites, axes=(1, 2, 3)))
    penu_sdm = dist[0] - dist[1]
    core_sdm = dist[2] - dist[3]

    latent_penu = _zoom_latent(penu_sdm, 1.0 / zoom)
    latent_core = _zoom_latent(core_sdm, 1.0 / zoom)
    latent_intp = latent_penu * t - latent_core * (1.0 - t)

    if resample:
        def back(lat):
            return _fit_plane(_zoom_latent(lat, float(zoom)), (h, w))

        recon_core = back(latent_core)
        recon_penu = back(latent_penu)
        recon_intp = back(latent_intp)
    else:
        recon_core = core_sdm
        recon_penu = penu_sdm
        recon_intp = penu_sdm * t - core_sdm * (1.0 - t)
    return (recon_core, recon_intp, recon_penu,
            latent_core, latent_intp, latent_penu)
