"""Model layers (port of models/layers.py).

Parameters keep the JAX package's layout — conv kernels ``(kD, kH, kW,
C_in, C_out)``, BN ``scale``/``bias`` with ``mean``/``var`` running stats —
so a flax checkpoint maps onto them by name only (models/convert.py).
Parameters, BN statistics and their gradients stay float32; the convs run
in the input's type (float32 or bfloat16), as ``compute_dtype`` does in the
JAX package.

BN is folded into the following VALID conv (``fold_bn``) and the activation
runs in the conv kernel's epilogue, as on the JAX package's s2d path.  In
training the fold uses the batch statistics, so the conv's kernel and bias
gradients flow back through the fold to BN's ``scale`` / ``bias`` and,
through the batch mean and variance, to the input.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from stroke_prediction_tpu_torch.ops.conv3x3 import (
    Conv3x3Fn, activation, fold_bn)


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
        """1^3 conv: ``act(x @ kernel + bias)`` with the kernel in x's type,
        the product summed and the bias and activation applied in float32
        (float64 for a float64 x), rounded once to x's type, as s2d.py
        ``s2d_conv1x1`` does."""
        if self.kernel.shape[0] != 1:
            raise NotImplementedError(
                "a bare 3^3 Conv3d is not ported yet; BnConvActBlock runs "
                "its folded 3^3 conv through conv3x3")
        acc = torch.promote_types(x.dtype, torch.float32)
        k = self.kernel[0, 0, 0].to(x.dtype).to(acc)
        y = torch.matmul(x.to(acc), k) + self.bias.to(acc)
        return activation(y, act, alpha).to(x.dtype)


class BatchNorm(nn.Module):
    """BatchNorm3d over (B, D, H, W, C) with flax's semantics
    (layers.py ``BatchNorm`` / ``_BNCore``).

    :meth:`affine` gives the per-channel ``bn(x) = x*s + t`` with
    ``s = scale * rsqrt(var + eps)`` and ``t = bias - mean * s``, which the
    following conv folds in.  In training, mean and var are the batch's
    moments ``E[x]`` and ``max(E[x^2] - E[x]^2, 0)`` (the biased
    variance), in float32 (float64 for a float64 input) and kept in the
    autograd graph, and the running statistics take
    ``ra = 0.9 * ra + 0.1 * batch`` (flax momentum 0.9); in evaluation the
    running statistics are used."""

    def __init__(self, features: int, epsilon: float = 1e-5,
                 momentum: float = 0.9):
        super().__init__()
        self.epsilon = epsilon
        self.momentum = momentum
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def affine(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.training:
            xf = x.to(torch.promote_types(x.dtype, torch.float32))
            axes = tuple(range(x.ndim - 1))
            mean = xf.mean(axes)
            var = torch.clamp((xf * xf).mean(axes) - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        s = self.scale * torch.rsqrt(var + self.epsilon)
        return s, self.bias - mean * s


class BnConvActBlock(nn.Module):
    """BN -> 3^3 VALID conv -> activation, with BN folded into the conv and
    the activation fused into its kernel (:class:`Conv3x3Fn`)."""

    def __init__(self, in_features: int, features: int,
                 act: str = "leaky_relu", act_param: float = 0.01):
        super().__init__()
        self.bn = BatchNorm(in_features)
        self.conv = Conv3d(in_features, features)
        self.act, self.act_param = act, act_param

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s, t = self.bn.affine(x)
        kernel, bias = fold_bn(self.conv.kernel, self.conv.bias, s, t)
        return Conv3x3Fn.apply(x.contiguous(), kernel, bias, self.act,
                               self.act_param, "v")
