"""3-D U-Net for core/penumbra segmentation (port of models/unet3d.py).

A 3-scale valid-convolution U-Net over (B, D, H, W, C) volumes: double
BN -> 3^3 valid conv -> LeakyReLU(0.01) blocks, 2x max pool, trilinear x2
upsampling, center-crop skip concatenation ``[upsampled, cropped skip]``,
and a 1^3 conv -> LeakyReLU(0.01) -> 1^3 conv -> sigmoid head.  The channel
list ``[in, b1, b2, b3, b4, b5, bC, out]`` is the reference ``--channels``.

Its ten 3^3 convs run in kernel K1 forward and K2-K4 backward
(ops/conv3x3.py); everything else is plain PyTorch.  ``train()`` uses BN
batch statistics (models/layers.py), ``eval()`` the running ones.  The
input is cast to ``compute_dtype`` (float32 or bfloat16) at entry, the
convs, pools, upsamples and the 1^3 head run in it, and the sigmoid runs in
float32 (unet3d.py:112, 140-143).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from stroke_prediction_tpu_torch.models.layers import BnConvActBlock, Conv3d
from stroke_prediction_tpu_torch.ops.pooling import max_pool3d
from stroke_prediction_tpu_torch.ops.resize import (
    center_crop, upsample2x_trilinear)


def unet_output_spatial(spatial: Sequence[int],
                        n_scales: int = 3) -> Tuple[int, ...]:
    """Output (D, H, W) of the valid-conv U-Net for a given input shape:
    per scale down two valid convs (-4) then pool (//2); bottom block -4;
    per scale up x2 upsample then two valid convs (-4)."""
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


class Unet3D(nn.Module):
    def __init__(self, channels: Sequence[int] = (2, 32, 64, 128, 64, 32,
                                                  32, 2),
                 generator: Optional[torch.Generator] = None,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        if compute_dtype not in (torch.float32, torch.bfloat16,
                                 torch.float64):
            raise ValueError(f"compute_dtype must be float32 or bfloat16 "
                             f"(float64 on the CPU), got {compute_dtype}")
        c_in, b1, b2, b3, b4, b5, b_c, n_classes = channels
        self.channels = tuple(channels)
        self.compute_dtype = compute_dtype
        self.blocks = nn.ModuleList([
            UnetBlock(c_in, b1), UnetBlock(b1, b2), UnetBlock(b2, b3),
            UnetBlock(b3 + b2, b4), UnetBlock(b4 + b1, b5)])
        self.head = nn.ModuleList([Conv3d(b5, b_c, (1, 1, 1)),
                                   Conv3d(b_c, n_classes, (1, 1, 1))])
        for m in self.modules():
            if isinstance(m, Conv3d):
                m.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, D, H, W, n_in) -> segmentation (B, D', H', W', n_classes)
        in [0, 1], float32 (float64 for a float64 compute type)."""
        r1 = self.blocks[0](x.to(self.compute_dtype))
        r2 = self.blocks[1](max_pool3d(r1))
        r3 = self.blocks[2](max_pool3d(r2))
        u3 = upsample2x_trilinear(r3)
        r4 = self.blocks[3](torch.cat([u3, center_crop(r2, u3.shape[1:4])],
                                      dim=-1))
        u4 = upsample2x_trilinear(r4)
        r5 = self.blocks[4](torch.cat([u4, center_crop(r1, u4.shape[1:4])],
                                      dim=-1))
        h = self.head[1](self.head[0](r5, act="leaky_relu", alpha=0.01))
        return torch.sigmoid(h.to(torch.promote_types(h.dtype,
                                                      torch.float32)))
