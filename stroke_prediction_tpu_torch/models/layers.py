"""Model layers (port of models/layers.py), evaluation mode.

Parameters keep the JAX package's layout — conv kernels ``(kD, kH, kW,
C_in, C_out)``, BN ``scale``/``bias`` with ``mean``/``var`` running stats —
so a flax checkpoint maps onto them by name only (models/convert.py).

In evaluation the BN running statistics fold exactly into the following
VALID conv (``fold_bn``) and the activation runs in the conv kernel's
epilogue, as on the JAX package's s2d path.  Training (BN batch statistics
and their running update, and the backward kernels) belongs to the training
slice; the modules raise in ``train()`` mode.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from stroke_prediction_tpu_torch.ops.conv3x3 import activation, conv3x3, fold_bn


def _eval_only(module: nn.Module) -> None:
    if module.training:
        raise NotImplementedError(
            f"{type(module).__name__} is ported for evaluation only; call "
            ".eval() (training is not ported yet)")


class Conv3d(nn.Module):
    """Stride-1 VALID 3-D conv over (B, D, H, W, C) with the torch-0.3 init
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)), fan_in = C_in * prod(kernel)."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: Tuple[int, int, int] = (3, 3, 3)):
        super().__init__()
        if tuple(kernel_size) not in ((3, 3, 3), (1, 1, 1)):
            raise NotImplementedError(f"kernel {kernel_size} not ported yet")
        self.kernel = nn.Parameter(
            torch.empty(*kernel_size, in_features, features))
        self.bias = nn.Parameter(torch.empty(features))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        bound = 1.0 / math.sqrt(self.kernel[..., 0].numel())
        with torch.no_grad():
            self.kernel.uniform_(-bound, bound, generator=generator)
            self.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor, act: str = "none",
                alpha: float = 0.01) -> torch.Tensor:
        if self.kernel.shape[0] != 1:
            raise NotImplementedError(
                "a bare 3^3 Conv3d is not ported yet; BnConvActBlock runs "
                "its folded 3^3 conv through conv3x3")
        return activation(x @ self.kernel[0, 0, 0] + self.bias, act, alpha)


class BatchNorm(nn.Module):
    """BatchNorm3d parameters and running statistics over (B, D, H, W, C).
    In evaluation :meth:`affine` gives the per-channel ``bn(x) = x*s + t``
    with ``s = scale * rsqrt(var + eps)``, ``t = bias - mean * s``, which
    the following conv folds in."""

    def __init__(self, features: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def affine(self) -> Tuple[torch.Tensor, torch.Tensor]:
        _eval_only(self)
        s = self.scale * torch.rsqrt(self.var + self.epsilon)
        return s, self.bias - self.mean * s


class BnConvActBlock(nn.Module):
    """BN -> 3^3 VALID conv -> activation, with BN folded into the conv and
    the activation fused into its kernel."""

    def __init__(self, in_features: int, features: int,
                 act: str = "leaky_relu", act_param: float = 0.01):
        super().__init__()
        self.bn = BatchNorm(in_features)
        self.conv = Conv3d(in_features, features)
        self.act, self.act_param = act, act_param

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s, t = self.bn.affine()
        kernel, bias = fold_bn(self.conv.kernel, self.conv.bias, s, t)
        return conv3x3(x.contiguous(), kernel.contiguous(), bias, self.act,
                       self.act_param)
