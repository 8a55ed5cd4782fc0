"""Augmentation on the device (port of data/augment.py): the U-Net's random
patch crop, and the CAE's random hemispheric flip and elastic deformation.

The JAX function draws per-sample offsets and crops with one-hot selection
matmuls, a form chosen for the TPU's matrix unit.  Here the two halves are
apart: :func:`crop_patch` is the deterministic core, an exact per-sample
gather at explicit offsets, and :func:`random_offsets` the sampler, which
draws the offsets from a ``torch.Generator`` with the same bounds
(``randint(0, S - s + 1)`` per axis).  The two packages' generators give
different numbers for the same seed, so the tests feed both the same
offsets.  The flip and the elastic deformation are split the same way:
:func:`hemispheric_flip` and :func:`elastic_deform_batch` are the cores,
which take explicit flip masks and displacement fields;
:func:`random_flip_mask` and :func:`ops.warp.elastic_noise` the samplers.
The CAE learners' draws: :func:`random_cae_augment` (phase 1 and step
learning: the labels alone), :func:`random_cae_augment_ctp` (the CTP
learner: the images flipped with the labels by the same mask, the labels
alone deformed) and :func:`random_cae_augment_images` (phase 2: the images
flipped and deformed with the labels, by the same mask and fields).

In a sharded data-parallel step (``parallel.mesh.current()``) the CAE
learners' draws are those of the global batch: every rank draws the flip
mask and the noise for all its rows, takes its own rows of them and blurs
only those, so N ranks deform what one process deforms and every rank's
generator stays in step (as ``train/unet_learner.py`` draws its crops).
Under a spatial step (H sharded) the noise is that of the global volume;
each rank blurs its samples' fields over the whole H and keeps its block,
and the warp fetches the rows its points read (``ops/warp.py``).  The
flip is along W and stays local.

Layouts: batch volumes ``(B, D, H, W, C)``; patch and pad are given in the
reference's (x, y, z) = (W, H, D) order.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from stroke_prediction_tpu_torch.ops.warp import (
    elastic_fields, elastic_noise, map_coordinates_batch)
from stroke_prediction_tpu_torch.parallel import spatial
from stroke_prediction_tpu_torch.parallel.mesh import current


def random_offsets(generator: torch.Generator, batch: int,
                   volume_dhw: Tuple[int, int, int],
                   patch_whd: Tuple[int, int, int]) -> torch.Tensor:
    """(B, 3) int64 (d, h, w) offsets, each uniform in ``[0, S - s]``, on
    the generator's device."""
    w, h, d = patch_whd
    cols = [torch.randint(0, size - patch + 1, (batch,), generator=generator,
                          device=generator.device)
            for size, patch in zip(volume_dhw, (d, h, w))]
    return torch.stack(cols, dim=1)


def _crop(v: torch.Tensor, offsets: torch.Tensor,
          size_dhw: Tuple[int, int, int]) -> torch.Tensor:
    b = v.shape[0]
    idx = [torch.arange(b, device=v.device).reshape(b, 1, 1, 1)]
    for ax, n in enumerate(size_dhw):
        shape = [b, 1, 1, 1]
        shape[ax + 1] = n
        rng = torch.arange(n, device=v.device)
        idx.append((offsets[:, ax, None] + rng[None]).reshape(shape))
    return v[tuple(idx)]


def crop_patch(images: torch.Tensor, labels: Optional[torch.Tensor],
               offsets_dhw: torch.Tensor, patch_whd: Tuple[int, int, int],
               pad_xyz: Tuple[int, int, int]):
    """Per-sample crop at explicit ``(B, 3)`` (d, h, w) offsets: images to
    the (w, h, d) patch, labels to (w-2px, h-2py, d-2pz) at the same offset
    (the valid-conv output region of the image patch).  Exact, one gather
    per tensor, no host synchronisation."""
    w, h, d = patch_whd
    px, py, pz = pad_xyz
    offsets = offsets_dhw.to(device=images.device, dtype=torch.int64)
    imgs = _crop(images, offsets, (d, h, w))
    labs = None
    if labels is not None:
        labs = _crop(labels, offsets, (d - 2 * pz, h - 2 * py, w - 2 * px))
    return imgs, labs


def random_flip_mask(generator: torch.Generator, batch: int) -> torch.Tensor:
    """(B,) bool, each True with probability 0.5, on the generator's
    device."""
    return torch.rand((batch,), generator=generator,
                      device=generator.device) < 0.5


def hemispheric_flip(volumes: torch.Tensor,
                     flip: torch.Tensor) -> torch.Tensor:
    """(B, D, H, W, C) volumes with the samples where ``flip`` holds
    mirrored along the hemispheric (X = W) axis."""
    cond = flip.reshape((-1,) + (1,) * (volumes.ndim - 1))
    return spatial.like(torch.where(cond, torch.flip(volumes, dims=(-2,)),
                                    volumes), volumes)


def elastic_deform_batch(labels: torch.Tensor,
                         fields: torch.Tensor) -> torch.Tensor:
    """(B, D, H, W, C) labels warped by the (B, 3, D, H, W) displacement
    fields of :func:`ops.warp.elastic_fields`, one field shared by a
    sample's channels: each voxel p reads ``labels(p + field(p))``
    trilinearly, zero outside.  Phase 2 warps its images by the same call
    on the same fields (the JAX ``apply_to_images=True``).  Under a
    spatial step ``labels`` and ``fields`` are this rank's block of H, p
    is global, and the rows the points read come from their owners."""
    _, d, h, w, _ = labels.shape
    lo, hi = (0, h)
    if spatial.active():
        lo, hi = spatial.own_block(spatial.height(labels))
    grid = torch.meshgrid(*(torch.arange(a, n, dtype=fields.dtype,
                                         device=fields.device)
                            for a, n in ((0, d), (lo, hi), (0, w))),
                          indexing="ij")
    return spatial.like(map_coordinates_batch(
        labels, torch.stack(grid)[None] + fields), labels)


def _cae_draws(generator: torch.Generator, labels: torch.Tensor):
    """One flip mask and one displacement field per sample of ``labels``:
    drawn for the running step's global batch, this rank's rows of them.
    The blur runs a sample at a time, so that a sample's field is the same
    bits however many rows a rank holds.  Under a spatial step the noise
    is drawn, and a sample's field blurred, over the global H, and this
    rank keeps its block of H of the fields."""
    sharding = current()
    n = sharding.global_size(labels.shape[0])
    flip = random_flip_mask(generator, n)
    noise = elastic_noise(generator, n, spatial.spatial_shape(labels),
                          labels.dtype)
    fields = torch.stack([elastic_fields(x) for x in sharding.take(noise)])
    if sharding.spatial:
        lo, hi = spatial.own_block(noise.shape[3])
        fields = fields[:, :, :, lo:hi].contiguous()
    return sharding.take(flip), fields


def random_cae_augment(generator: torch.Generator,
                       labels: torch.Tensor) -> torch.Tensor:
    """The CAE learner's training augmentation of its labels: a random
    hemispheric flip, then an elastic deformation (alpha 100, sigma 4,
    depth scaled by 0.22).  (The JAX learner flips its images too, which
    phase-1 training never reads.)"""
    flip, fields = _cae_draws(generator, labels)
    return elastic_deform_batch(hemispheric_flip(labels, flip), fields)


def random_cae_augment_images(generator: torch.Generator,
                              images: torch.Tensor, labels: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Phase 2's training augmentation: the same draws as
    :func:`random_cae_augment`, the images flipped and deformed with the
    labels by the same mask and per-sample fields -> (images, labels)."""
    flip, fields = _cae_draws(generator, labels)
    return (elastic_deform_batch(hemispheric_flip(images, flip), fields),
            elastic_deform_batch(hemispheric_flip(labels, flip), fields))


def random_cae_augment_ctp(generator: torch.Generator, images: torch.Tensor,
                           labels: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CTP learner's training augmentation: the same draws as
    :func:`random_cae_augment`; the (padded) images flipped with the labels
    by the same mask, the labels alone deformed (the JAX learner's
    ``AUGMENT_IMAGES = False``) -> (images, labels)."""
    flip, fields = _cae_draws(generator, labels)
    return (hemispheric_flip(images, flip),
            elastic_deform_batch(hemispheric_flip(labels, flip), fields))
