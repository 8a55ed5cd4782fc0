"""Random patch cropping on the device (port of data/augment.py
``random_patch``).

The JAX function draws per-sample offsets and crops with one-hot selection
matmuls, a form chosen for the TPU's matrix unit.  Here the two halves are
apart: :func:`crop_patch` is the deterministic core, an exact per-sample
gather at explicit offsets, and :func:`random_offsets` the sampler, which
draws the offsets from a ``torch.Generator`` with the same bounds
(``randint(0, S - s + 1)`` per axis).  The two packages' generators give
different numbers for the same seed, so the tests feed both the same
offsets.

Layouts: batch volumes ``(B, D, H, W, C)``; patch and pad are given in the
reference's (x, y, z) = (W, H, D) order.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


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
