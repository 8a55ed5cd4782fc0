"""Model layers (port of models/layers.py).

Parameters keep the JAX package's layout — conv kernels ``(kD, kH, kW,
C_in, C_out)``, BN ``scale``/``bias`` with ``mean``/``var`` running stats —
so a flax checkpoint maps onto them by name only (models/convert.py).
Parameters, BN statistics and their gradients stay float32; the convs run
in the input's type (float32 or bfloat16), as ``compute_dtype`` does in the
JAX package.

BN is folded into the following stride-1 VALID or z-SAME 3^3 conv
(``fold_bn``, ``fold_bn_zsame``) and the activation runs in the conv
kernel's epilogue, as on the JAX package's s2d path.  Where the conv's
padding holds BN outputs in H or W, or the conv has stride 2, or BN is
grouped (per-structure statistics of a stacked batch, in training), BN is
applied to its input instead.  The stride-2 and transposed convs are
cuDNN's, with its deterministic algorithms.  Under H sharding every layer
runs on this rank's block of H (``parallel/spatial.py``).  In training the
fold uses the batch statistics, so the conv's kernel and bias
gradients flow back through the fold to BN's ``scale`` / ``bias`` and,
through the batch mean and variance, to the input.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from stroke_prediction_tpu_torch.ops.conv3x3 import (
    Conv3x3Fn, activation, fold_bn, fold_bn_zsame)
from stroke_prediction_tpu_torch.parallel import spatial
from stroke_prediction_tpu_torch.parallel.collectives import reduce_sums


def check_compute_dtype(compute_dtype: torch.dtype) -> None:
    """A model's compute type: float32 or bfloat16, or float64 for the CPU
    tests."""
    if compute_dtype not in (torch.float32, torch.bfloat16, torch.float64):
        raise ValueError(f"compute_dtype must be float32 or bfloat16 "
                         f"(float64 on the CPU), got {compute_dtype}")


class _ConvParams(nn.Module):
    """A conv kernel ``(*kernel_size, C_in, C_out)`` and bias with the
    torch-0.3 init U(-1/sqrt(fan_in), 1/sqrt(fan_in)), fan_in = C_in *
    prod(kernel_size)."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: Tuple[int, int, int]):
        super().__init__()
        self.kernel = nn.Parameter(
            torch.empty(*kernel_size, in_features, features))
        self.bias = nn.Parameter(torch.empty(features))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        bound = 1.0 / math.sqrt(self.kernel[..., 0].numel())
        with torch.no_grad():
            self.kernel.uniform_(-bound, bound, generator=generator)
            self.bias.uniform_(-bound, bound, generator=generator)


class Conv3d(_ConvParams):
    """3-D conv over (B, D, H, W, C): a 1^3 conv, a stride-1 3^3 conv with
    padding ``(pd, ph, pw)`` (pd 0 or 1) or ``"VALID"``, or a stride-2 3^3
    conv with padding 1 or ``"VALID"`` (layers.py ``Conv3d``)."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: Tuple[int, int, int] = (3, 3, 3),
                 strides: Tuple[int, int, int] = (1, 1, 1),
                 padding="VALID"):
        super().__init__(in_features, features, kernel_size)
        pads = (0, 0, 0) if padding == "VALID" else tuple(padding)
        kernel_size, strides = tuple(kernel_size), tuple(strides)
        if kernel_size == (1, 1, 1):
            ok = strides == (1, 1, 1) and pads == (0, 0, 0)
        elif kernel_size == (3, 3, 3) and strides == (1, 1, 1):
            ok = pads[0] in (0, 1)
        else:
            ok = (kernel_size == (3, 3, 3) and strides == (2, 2, 2)
                  and pads in ((0, 0, 0), (1, 1, 1)))
        if not ok:
            raise NotImplementedError(f"conv {kernel_size} stride {strides} "
                                      f"padding {padding} not ported")
        self.strides, self.pads = strides, pads

    def forward(self, x: torch.Tensor, act: str = "none",
                alpha: float = 0.01) -> torch.Tensor:
        """``act(conv(x) + bias)`` in x's type.

        * 1^3: ``x @ kernel`` with the kernel in x's type, the product
          summed and the bias and activation applied in float32 (float64
          for a float64 x), rounded once to x's type, as s2d.py
          ``s2d_conv1x1`` does.
        * stride 1: H and W zero-padded here, D by the kernel's z-SAME mode
          (``'s'``), then K1 (:class:`Conv3x3Fn`) with the activation in
          its epilogue.
        * stride 2: cuDNN's conv in float32 (the JAX package runs it as
          XLA convs, a stride-1 conv sliced), then bias and activation.

        Under H sharding a 3^3 conv runs on the rows its block of the
        output reads, fetched from their owners with the H padding added
        at the volume's edges alone (``parallel.spatial.conv_rows``), and
        with no H padding of its own; a 1^3 conv on the block as it is.
        """
        if self.kernel.shape[0] == 1:
            acc = torch.promote_types(x.dtype, torch.float32)
            k = self.kernel[0, 0, 0].to(x.dtype).to(acc)
            y = torch.matmul(x.to(acc), k) + self.bias.to(acc)
            return spatial.like(activation(y, act, alpha).to(x.dtype), x)
        pd, ph, pw = self.pads
        h = None
        if spatial.active():
            x, h = spatial.conv_rows(x, spatial.height(x), self.strides[1],
                                     ph)
            ph = 0
        if self.strides == (1, 1, 1):
            if ph or pw:
                x = F.pad(x, (0, 0, pw, pw, ph, ph))
            y = Conv3x3Fn.apply(x.contiguous(), self.kernel, self.bias,
                                act, alpha, "s" if pd else "v")
        else:
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=False,
                                            deterministic=True):
                y = F.conv3d(x.permute(0, 4, 1, 2, 3),
                             self.kernel.to(x.dtype).permute(4, 3, 0, 1, 2),
                             stride=self.strides, padding=(pd, ph, pw))
            y = activation(y.permute(0, 2, 3, 4, 1) + self.bias.to(x.dtype),
                           act, alpha)
        return y if h is None else spatial.record(y, h)


class ConvTranspose3d(_ConvParams):
    """3-D transposed conv over (B, D, H, W, C), padding 0: out = (in - 1)
    * stride + k (layers.py ``ConvTranspose3d``).

    The kernel keeps the JAX layout ``(kD, kH, kW, C_in, C_out)``.  JAX's
    ``lax.conv_transpose`` (``transpose_kernel=False``) does not flip it and
    torch's ``conv_transpose3d`` does, so cuDNN gets it flipped on its
    three spatial axes and laid out ``(C_in, C_out, kD, kH, kW)``.

    Under H sharding it runs on the input rows that its block of the output
    sums (``parallel.spatial.transposed_rows``) and keeps its block's rows
    of the result."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: Tuple[int, int, int] = (3, 3, 3),
                 strides: Tuple[int, int, int] = (1, 1, 1)):
        super().__init__(in_features, features, kernel_size)
        self.strides = tuple(strides)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = None
        if spatial.active():
            x, h, offset = spatial.transposed_rows(
                x, spatial.height(x), self.kernel.shape[1], self.strides[1])
        w = self.kernel.to(x.dtype).flip(0, 1, 2).permute(3, 4, 0, 1, 2)
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False,
                                        deterministic=True):
            y = F.conv_transpose3d(x.permute(0, 4, 1, 2, 3), w,
                                   stride=self.strides)
        y = y.permute(0, 2, 3, 4, 1) + self.bias.to(x.dtype)
        if h is None:
            return y
        lo, hi = spatial.own_block(h)
        return spatial.record(y[:, :, offset:offset + hi - lo], h)


class Dense(nn.Module):
    """``x @ kernel + bias`` with flax ``nn.Dense``'s layout: kernel
    ``(C_in, C_out)``, init N(0, 1/C_in) (flax's default draws a truncated
    normal of that variance) and zero bias, or the given normal inits."""

    def __init__(self, in_features: int, features: int,
                 kernel_init: Optional[Tuple[float, float]] = None,
                 bias_init: Tuple[float, float] = (0.0, 0.0)):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_features, features))
        self.bias = nn.Parameter(torch.empty(features))
        self._inits = (kernel_init or (0.0, in_features ** -0.5), bias_init)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        (km, ks), (bm, bs) = self._inits
        with torch.no_grad():
            self.kernel.normal_(km, ks, generator=generator)
            self.bias.normal_(bm, bs, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.kernel + self.bias


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
    running statistics are used.  Under H sharding the sums of x and x^2
    accumulate in float64 (``parallel.spatial.sum_dtype``).

    The moments are global in a sharded data-parallel step: the
    per-channel sums of x and x^2 go through
    ``parallel.collectives.reduce_sums`` before they are divided by the
    global count (the pmean of E[x] and E[x^2] of ``layers.py:324-330``; a
    mean of per-rank variances would drop the between-rank term), so every
    rank normalises and updates its running statistics alike.  The count
    is the global batch's, exact as an integer
    (``parallel.spatial.global_count``): this rank's times the data
    ranks, or under H sharding, where a rank sums its own rows of H alone,
    ``B · D · H · W`` with the global B and H.

    ``groups`` > 1 (structure batching, ``models/cae3d.py``): the batch
    axis holds ``groups`` equal blocks of rows, group-major, and in
    training each block takes its own moments, ``(G, C)``, whose sums all
    go through one ``reduce_sums`` call (one collective a layer whatever
    G is).  The running statistics then take one update per group, chained
    in stacking order, ``m^G * ra + sum_g (1 - m) * m^(G-1-g) * batch_g``
    (``_BNCore``), as G calls of one group each would chain them, and the
    affine is ``(G, C)`` (:func:`apply_affine`).  In evaluation the
    running statistics serve every group.  Under H sharding a group's
    count is the global count over ``groups``."""

    def __init__(self, features: int, epsilon: float = 1e-5,
                 momentum: float = 0.9):
        super().__init__()
        self.epsilon = epsilon
        self.momentum = momentum
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def affine(self, x: torch.Tensor, groups: int = 1
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.training:
            xf = x.to(torch.promote_types(x.dtype, torch.float32))
            acc = spatial.sum_dtype(xf)
            if groups == 1:
                axes = tuple(range(x.ndim - 1))
                sums = xf.sum(axes, dtype=acc), (xf * xf).sum(axes, dtype=acc)
            else:
                if x.shape[0] % groups:
                    raise ValueError(f"a batch of {x.shape[0]} rows does "
                                     f"not split into {groups} groups")
                xg = xf.reshape(groups, -1, x.shape[-1])
                sums = xg.sum(1, dtype=acc), (xg * xg).sum(1, dtype=acc)
            s1, s2 = (s.to(xf.dtype) for s in reduce_sums(*sums))
            n = spatial.global_count(x) // groups
            mean = s1 / n
            var = torch.clamp(s2 / n - mean * mean, min=0.0)
            with torch.no_grad():
                self._update_running(mean, var)
        else:
            mean, var = self.mean, self.var
        s = self.scale * torch.rsqrt(var + self.epsilon)
        return s, self.bias - mean * s

    def _update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        m = self.momentum
        if mean.ndim == 1:
            self.mean.copy_(m * self.mean + (1 - m) * mean)
            self.var.copy_(m * self.var + (1 - m) * var)
            return
        g = mean.shape[0]
        w = (1 - m) * m ** torch.arange(g - 1, -1, -1, dtype=mean.dtype,
                                        device=mean.device)
        self.mean.copy_(m ** g * self.mean + w @ mean)
        self.var.copy_(m ** g * self.var + w @ var)

    def forward(self, x: torch.Tensor, groups: int = 1) -> torch.Tensor:
        """``bn(x) = x*s + t`` in x's type (layers.py ``BatchNorm`` on a
        logical tensor), per group for ``groups`` > 1."""
        return spatial.like(apply_affine(x, *self.affine(x, groups)), x)


def apply_affine(x: torch.Tensor, s: torch.Tensor,
                 t: torch.Tensor) -> torch.Tensor:
    """``x*s + t`` over the channel axis in x's type (``s`` and ``t`` cast
    to it): a ``(C,)`` affine for every row, or a ``(G, C)`` one broadcast
    over each of the G equal blocks of rows (layers.py:338-344)."""
    s, t = s.to(x.dtype), t.to(x.dtype)
    if s.ndim == 1:
        return x * s + t
    view = (s.shape[0],) + (1,) * (x.ndim - 1) + (s.shape[1],)
    xg = x.reshape(s.shape[0], -1, *x.shape[1:])
    return (xg * s.reshape(view) + t.reshape(view)).reshape(x.shape)


class BnConvActBlock(nn.Module):
    """BN -> 3^3 conv -> activation (layers.py ``BnConvActBlock``).

    Stride 1 ('VALID', or z-SAME ``padding=(1, 0, 0)``): BN folded into the
    conv (``fold_bn``, or ``fold_bn_zsame`` with a per-output-plane bias
    table, which is exact at the planes whose taps read the z padding) and
    the activation fused into K1 (:class:`Conv3x3Fn`).  Stride 2: BN applied
    to the input, whose zero padding then holds BN outputs, so it cannot
    fold; then :class:`Conv3d`.  ``conv_dtype``, where set, is the type the
    conv runs in: BN's moments are taken of the input as given and the
    input is cast after them (the JAX ``BatchNorm`` of an encoder's entry,
    ``x.astype(float32)`` for the moments, ``x.astype(compute_dtype)`` for
    the output).

    ``groups`` > 1 in training: a per-group affine cannot fold into the one
    kernel that the stacked groups share, so it is applied to the (cast)
    input and K1 runs with the layer's own kernel and bias, as the JAX lax
    path does.  The affined input then needs a gradient (through BN's
    ``scale`` and ``bias``), so the entry conv's backward computes dx too
    (K2 at C_in 1 or 3) where the folded entry conv on data takes K4 alone.
    (The JAX s2d path puts the grouped affine in front of its dW-only entry
    conv and so gives the entry BN a zero gradient.)

    Under H sharding BN's moments are those of the rows this rank owns,
    summed over the ranks, and the conv runs on the rows its block of the
    output reads, fetched from their owners (``parallel/spatial.py``; for
    stride 1 two more than it owns, for stride 2 through :class:`Conv3d`);
    the conv's input gradient of a fetched row goes back to its owner."""

    def __init__(self, in_features: int, features: int,
                 strides: Tuple[int, int, int] = (1, 1, 1), padding="VALID",
                 act: str = "leaky_relu", act_param: float = 0.01):
        super().__init__()
        self.bn = BatchNorm(in_features)
        self.conv = Conv3d(in_features, features, strides=strides,
                           padding=padding)
        if self.conv.strides == (1, 1, 1) and self.conv.pads[1:] != (0, 0):
            raise NotImplementedError(f"padding {padding}: BN folds into "
                                      f"z-SAME or VALID convs only")
        self.act, self.act_param = act, act_param
        self.conv_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor, groups: int = 1) -> torch.Tensor:
        s, t = self.bn.affine(x, groups)
        h = spatial.height(x) if spatial.active() else None
        if self.conv_dtype is not None:
            x = x.to(self.conv_dtype)
        if self.conv.strides != (1, 1, 1) or s.ndim == 2:
            x = apply_affine(x, s, t)
            if h is not None:
                x = spatial.record(x, h)
            return self.conv(x, self.act, self.act_param)
        if h is not None:
            x, h = spatial.conv_rows(x, h)
        if self.conv.pads[0]:
            kernel, bias = fold_bn_zsame(self.conv.kernel, self.conv.bias,
                                         s, t, x.shape[1])
            mode = "s"
        else:
            kernel, bias = fold_bn(self.conv.kernel, self.conv.bias, s, t)
            mode = "v"
        y = Conv3x3Fn.apply(x.contiguous(), kernel, bias, self.act,
                            self.act_param, mode)
        return y if h is None else spatial.record(y, h)
