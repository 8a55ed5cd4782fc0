"""3-D U-Nets for core/penumbra segmentation (port of models/unet3d.py).

``Unet3D``: a 3-scale valid-convolution U-Net over (B, D, H, W, C)
volumes: double BN -> 3^3 valid conv -> LeakyReLU(0.01) blocks, 2x max
pool, trilinear x2 upsampling, center-crop skip concatenation
``[upsampled, cropped skip]``, and a 1^3 conv -> LeakyReLU(0.01) -> 1^3
conv -> sigmoid head.  The channel list ``[in, b1, b2, b3, b4, b5, bC,
out]`` is the reference ``--channels``.  ``LargeUnet3D``: the same at four
scales, channels ``[in, b1, ..., b7, bC, out]``.

Their 3^3 convs run in kernel K1 forward and K2-K4 backward
(ops/conv3x3.py); everything else is plain PyTorch.  ``train()`` uses BN
batch statistics (models/layers.py), ``eval()`` the running ones.  The
input is cast to ``compute_dtype`` (float32 or bfloat16) at entry, the
convs, pools, upsamples and the 1^3 head run in it, and the sigmoid runs in
float32 (unet3d.py:112, 140-143).

Under a spatial step (``parallel.mesh.batch_sharding(mesh, spatial=True)``)
the forward is the same code on this rank's block of H: each conv, pool,
upsample and skip crop fetches the rows it reads from their owners
(``parallel/spatial.py``), and the output is this rank's block of the
one-process output.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from stroke_prediction_tpu_torch.models.layers import (
    BnConvActBlock, Conv3d, check_compute_dtype)
from stroke_prediction_tpu_torch.ops.pooling import max_pool3d
from stroke_prediction_tpu_torch.ops.resize import (
    center_crop, upsample2x_trilinear)
from stroke_prediction_tpu_torch.parallel import spatial


def unet_output_spatial(spatial: Sequence[int],
                        n_scales: int = 3) -> Tuple[int, ...]:
    """Output (D, H, W) of the valid-conv U-Net for a given input shape:
    per scale down two valid convs (-4) then pool (//2); bottom block -4;
    per scale up x2 upsample then two valid convs (-4).  ``n_scales`` 3 is
    ``Unet3D`` (the input less 40 where the pools divide evenly), 4
    ``LargeUnet3D`` (less 88)."""
    sizes = list(spatial)
    for _ in range(n_scales - 1):
        sizes = [(v - 4) // 2 for v in sizes]
    sizes = [v - 4 for v in sizes]
    for _ in range(n_scales - 1):
        sizes = [2 * v - 4 for v in sizes]
    return tuple(sizes)


class UnetBlock(nn.Module):
    """Two BN -> 3^3 valid conv -> LeakyReLU(0.01) layers."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.layers = nn.ModuleList([BnConvActBlock(in_features, features),
                                     BnConvActBlock(features, features)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x


def _init_convs(model: nn.Module, generator: Optional[torch.Generator]):
    for m in model.modules():
        if isinstance(m, Conv3d):
            m.reset_parameters(generator)


def _up_block(block: UnetBlock, low: torch.Tensor,
              skip: torch.Tensor) -> torch.Tensor:
    """A decoder stage: upsample, concatenate ``[upsampled, cropped skip]``,
    then the block."""
    u = upsample2x_trilinear(low)
    skip = center_crop(skip, spatial.spatial_shape(u))
    return block(spatial.like(torch.cat([u, skip], dim=-1), u))


def _head(head: nn.ModuleList, x: torch.Tensor) -> torch.Tensor:
    """1^3 conv -> LeakyReLU(0.01) -> 1^3 conv -> sigmoid, the sigmoid in
    float32 (float64 for a float64 compute type)."""
    h = head[1](head[0](x, act="leaky_relu", alpha=0.01))
    return torch.sigmoid(h.to(torch.promote_types(h.dtype, torch.float32)))


class Unet3D(nn.Module):
    def __init__(self, channels: Sequence[int] = (2, 32, 64, 128, 64, 32,
                                                  32, 2),
                 generator: Optional[torch.Generator] = None,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        check_compute_dtype(compute_dtype)
        c_in, b1, b2, b3, b4, b5, b_c, n_classes = channels
        self.channels = tuple(channels)
        self.compute_dtype = compute_dtype
        self.blocks = nn.ModuleList([
            UnetBlock(c_in, b1), UnetBlock(b1, b2), UnetBlock(b2, b3),
            UnetBlock(b3 + b2, b4), UnetBlock(b4 + b1, b5)])
        self.head = nn.ModuleList([Conv3d(b5, b_c, (1, 1, 1)),
                                   Conv3d(b_c, n_classes, (1, 1, 1))])
        _init_convs(self, generator)

    @property
    def config(self) -> dict:
        """The ``.model`` header of this model, as the JAX learner writes
        it."""
        return {"kind": "unet3d", "channels": list(self.channels)}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, D, H, W, n_in) -> segmentation (B, D', H', W', n_classes)
        in [0, 1], float32 (float64 for a float64 compute type)."""
        r1 = self.blocks[0](x.to(self.compute_dtype))
        r2 = self.blocks[1](max_pool3d(r1))
        r3 = self.blocks[2](max_pool3d(r2))
        r4 = _up_block(self.blocks[3], r3, r2)
        return _head(self.head, _up_block(self.blocks[4], r4, r1))


class LargeUnet3D(nn.Module):
    """The 4-scale U-Net (unet3d.py ``LargeUnet3D``): seven blocks, three
    max pools, three decoder stages, the head of :class:`Unet3D`.  Its
    output is the input less 88 where the pools divide evenly."""

    def __init__(self, channels: Sequence[int] = (2, 32, 64, 128, 256, 128,
                                                  64, 32, 32, 2),
                 generator: Optional[torch.Generator] = None,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        check_compute_dtype(compute_dtype)
        c_in, b1, b2, b3, b4, b5, b6, b7, b_c, n_classes = channels
        self.channels = tuple(channels)
        self.compute_dtype = compute_dtype
        self.blocks = nn.ModuleList([
            UnetBlock(c_in, b1), UnetBlock(b1, b2), UnetBlock(b2, b3),
            UnetBlock(b3, b4), UnetBlock(b4 + b3, b5), UnetBlock(b5 + b2, b6),
            UnetBlock(b6 + b1, b7)])
        self.head = nn.ModuleList([Conv3d(b7, b_c, (1, 1, 1)),
                                   Conv3d(b_c, n_classes, (1, 1, 1))])
        _init_convs(self, generator)

    @property
    def config(self) -> dict:
        """The ``.model`` header of this model."""
        return {"kind": "large_unet3d", "channels": list(self.channels)}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, D, H, W, n_in) -> segmentation (B, D', H', W', n_classes)
        in [0, 1], float32 (float64 for a float64 compute type)."""
        r1 = self.blocks[0](x.to(self.compute_dtype))
        r2 = self.blocks[1](max_pool3d(r1))
        r3 = self.blocks[2](max_pool3d(r2))
        r4 = self.blocks[3](max_pool3d(r3))
        r5 = _up_block(self.blocks[4], r4, r3)
        r6 = _up_block(self.blocks[5], r5, r2)
        return _head(self.head, _up_block(self.blocks[6], r6, r1))
