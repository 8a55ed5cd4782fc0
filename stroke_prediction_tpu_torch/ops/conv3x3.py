"""Fused 3x3x3 stride-1 conv + bias + activation (kernel K1 of the port).

Counterpart of ``stroke_prediction_tpu/ops/pallas/s2d.py``: ``s2d_conv``
(whose Pallas kernel is ``_conv_kernel``), ``fold_bn`` and ``fold_bn_zsame``.
The s2d cell layout is not ported; the op takes logical channels-last
volumes.

* :func:`conv3x3` — the wrapper.  On a CUDA tensor it launches the CUDA C++
  kernel ``csrc/conv3x3_fwd.cu`` (or raises); on a CPU tensor it runs
  :func:`conv3x3_plain`.
* :func:`conv3x3_plain` — the plain PyTorch version (``F.conv3d``), used by
  the CPU path, the tests and the on-card comparison.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from stroke_prediction_tpu_torch.ops import _build

ACTS = {"none": 0, "leaky_relu": 1, "elu": 2}
MODES = {"v": 0, "s": 1}   # z valid, or z zero-padded by one plane


def activation(y: torch.Tensor, act: str, alpha: float) -> torch.Tensor:
    """s2d.py ``_act``: LeakyReLU(alpha), or ELU(alpha) with the exp taken
    of the clamped value, or identity."""
    if act == "leaky_relu":
        return torch.where(y > 0, y, alpha * y)
    if act == "elu":
        return torch.where(y > 0, y,
                           alpha * (torch.exp(torch.clamp(y, max=0.0)) - 1.0))
    if act == "none":
        return y
    raise ValueError(f"unknown activation {act!r}")


def _out_depth(d_in: int, mode: str) -> int:
    return d_in - 2 if mode == "v" else d_in


def conv3x3_plain(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                  act: str = "none", alpha: float = 0.01,
                  mode: str = "v") -> torch.Tensor:
    """Plain version of :func:`conv3x3`: ``F.conv3d`` on a permuted view,
    then bias and activation."""
    zpad = MODES[mode]
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), kernel.permute(4, 3, 0, 1, 2),
                 padding=(zpad, 0, 0)).permute(0, 2, 3, 4, 1)
    y = y + (bias[None, :, None, None, :] if bias.ndim == 2 else bias)
    return activation(y, act, alpha).contiguous()


def _check(x, kernel, bias, act, mode):
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}")
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}: use 'v' or 's'")
    if x.ndim != 5:
        raise ValueError(f"x must be (B, D, H, W, C), got {tuple(x.shape)}")
    b, d, h, w, ci = x.shape
    if kernel.shape[:4] != (3, 3, 3, ci) or kernel.ndim != 5:
        raise ValueError(f"kernel must be (3, 3, 3, {ci}, C_out), got "
                         f"{tuple(kernel.shape)}")
    co = kernel.shape[4]
    d_out = _out_depth(d, mode)
    if d_out < 1 or h < 3 or w < 3:
        raise ValueError(f"input {tuple(x.shape)} too small for a 3^3 "
                         f"'{mode}' conv")
    if bias.shape not in ((co,), (d_out, co)):
        raise ValueError(f"bias must be ({co},) or ({d_out}, {co}), got "
                         f"{tuple(bias.shape)}")
    for name, t in (("x", x), ("kernel", kernel), ("bias", bias)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def conv3x3(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
            act: str = "none", alpha: float = 0.01,
            mode: str = "v") -> torch.Tensor:
    """``act(conv3d(x, kernel) + bias)``, stride 1, H/W valid, D valid
    (``mode='v'``) or zero-padded by one plane (``mode='s'``).

    x: (B, D, H, W, C_in); kernel: (3, 3, 3, C_in, C_out); bias: (C_out,) or
    a per-output-plane (D_out, C_out) table (:func:`fold_bn_zsame`).
    Returns (B, D_out, H-2, W-2, C_out).  float32 only.
    """
    _check(x, kernel, bias, act, mode)
    if x.device.type == "cpu":
        return conv3x3_plain(x, kernel, bias, act, alpha, mode)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3 runs on cuda or cpu, not {x.device}")
    for name, t in (("x", x), ("kernel", kernel), ("bias", bias)):
        if t.dtype != torch.float32:
            raise TypeError(f"conv3x3 kernel takes float32 {name}, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"conv3x3 kernel needs a contiguous {name}")
    b, d, h, w, ci = x.shape
    co = kernel.shape[4]
    y = torch.empty((b, _out_depth(d, mode), h - 2, w - 2, co),
                    dtype=torch.float32, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.conv3x3_fwd_f32(
            x.data_ptr(), kernel.data_ptr(), bias.data_ptr(), y.data_ptr(),
            b, d, h, w, ci, co, MODES[mode], int(bias.ndim == 2), ACTS[act],
            float(alpha), stream)
    _build.check("conv3x3_fwd_f32", err)
    conv3x3.launches += 1
    return y


conv3x3.launches = 0   # kernel launches since the caller last reset it


def fold_bn(kernel: torch.Tensor, bias: torch.Tensor, scale: torch.Tensor,
            shift: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold a per-input-channel affine (x*scale + shift) into a VALID conv:
    ``conv(x*s + t) = conv_{k*s}(x) + t @ sum_taps(k)`` (s2d.py fold_bn)."""
    k2 = kernel * scale[None, None, None, :, None]
    b2 = bias + torch.einsum("zyxio,i->o", kernel, shift)
    return k2, b2


def fold_bn_zsame(kernel: torch.Tensor, bias: torch.Tensor,
                  scale: torch.Tensor, shift: torch.Tensor,
                  d_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold a per-input-channel affine into a z-SAME (pad 1), H/W-VALID conv
    (s2d.py fold_bn_zsame): the bias becomes a (d_out, C_out) table whose
    first and last planes drop the tap that reads the zero z-padding."""
    k2 = kernel * scale[None, None, None, :, None]
    per_tap = torch.einsum("zyxio,i->zo", kernel, shift)      # (3, C_out)
    bz = (bias + per_tap.sum(0)).repeat(d_out, 1)
    bz[0] -= per_tap[0]             # z_in = -1 is padding, not t
    bz[d_out - 1] -= per_tap[2]     # z_in = D is padding, not t
    return k2, bz
