"""Fused 3x3x3 stride-1 conv + bias + activation and its backward (kernels
K1-K4 of the port).

Counterpart of ``stroke_prediction_tpu/ops/pallas/s2d.py``: ``s2d_conv``
(forward Pallas kernel ``_conv_kernel``, backward ``_bwd_kernel`` /
``_dx_kernel`` / ``_dw_kernel`` behind ``jax.custom_vjp``), ``fold_bn`` and
``fold_bn_zsame``.  The s2d cell layout is not ported; the ops take logical
channels-last volumes, float32 or bfloat16 (float32 accumulation).

* :func:`conv3x3` — the forward wrapper (K1, on the tensor cores:
  ``csrc/conv3x3_fwd_f32_tc.cu`` for float32, in 3xTF32, which keeps
  float32 accuracy; ``csrc/conv3x3_fwd_tc.cu`` for bfloat16).
* :func:`conv3x3_bwd_fused` (K2), :func:`conv3x3_bwd_dx` (K3),
  :func:`conv3x3_bwd_dw` (K4) — the backward wrappers, all on the tensor
  cores.  The float32 K2, K3 and K4 are ``csrc/conv3x3_bwd_f32_tc.cu``,
  ``csrc/conv3x3_bwd_dx_f32_tc.cu`` and ``csrc/conv3x3_bwd_dw_f32_tc.cu``,
  in 3xTF32; the bfloat16 K2, K3 and K4 are ``csrc/conv3x3_bwd_tc.cu``,
  ``csrc/conv3x3_bwd_dx_tc.cu`` and ``csrc/conv3x3_bwd_dw_tc.cu``.  On the
  card K2 takes only the channel counts that :func:`bwd_route` sends to
  it, in both types.
* :class:`Conv3x3Fn` — the autograd function: K1 forward; K2, or K3 + K4,
  backward (:func:`bwd_route`); K4 alone when the input needs no gradient
  (the entry conv on data, s2d.py ``input_grad=False``); K3 alone when the
  kernel and bias need none (a frozen conv, which JAX closes over as a
  constant, so XLA drops the split route's ``_dw_kernel``).

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU tensor
it runs its plain PyTorch version (``*_plain``), which the tests and the
on-card comparison also call.  Each wrapper counts its launches in a plain
integer attribute ``.launches``.
"""

from __future__ import annotations

import ctypes
import struct
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from stroke_prediction_tpu_torch.ops import _build

ACTS = {"none": 0, "leaky_relu": 1, "elu": 2}
MODES = {"v": 0, "s": 1}   # z valid, or z zero-padded by one plane
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}

# Route rule for the backward (the counterpart of _BWD_FUSED_VMEM_BUDGET,
# s2d.py:676-681): the fused K2 pass when the layer's float32 dW block, with
# channels padded to 16 as both K2 kernels keep it in registers,
# 27 * C_in' * C_out' * 4 bytes, is at most 64 KB, else K3 + K4.  On the
# U-Net at the reference width that fuses L2, L3 and L10.  The threshold
# stands in for the TPU's VMEM budget and is the K2 kernels' bound; it is
# not set from H100 times.
FUSED_DW_BYTES = 64 * 1024


def _pad16(c: int) -> int:
    return -(-c // 16) * 16


def _fused_fits(c_in: int, c_out: int) -> bool:
    return 27 * _pad16(c_in) * _pad16(c_out) * 4 <= FUSED_DW_BYTES


def bwd_route(c_in: int, c_out: int, input_grad: bool = True,
              weight_grad: bool = True) -> str:
    """'fused' (K2), 'split' (K3 + K4), 'dw' (K4 alone: the input needs no
    gradient) or 'dx' (K3 alone: neither the kernel nor the bias needs
    one)."""
    if not weight_grad:
        return "dx"
    if not input_grad:
        return "dw"
    return "fused" if _fused_fits(c_in, c_out) else "split"


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


def activation_grad(y: torch.Tensor, act: str, alpha: float) -> torch.Tensor:
    """d act / d pre-activation from the saved OUTPUT ``y`` (s2d.py
    ``_s2d_conv_bwd``): LeakyReLU 1 or alpha (alpha at y == 0), ELU 1 or
    ``y + alpha``, none 1."""
    if act == "leaky_relu":
        return torch.where(y > 0, 1.0, alpha)
    if act == "elu":
        return torch.where(y > 0, 1.0, y + alpha)
    if act == "none":
        return torch.ones_like(y)
    raise ValueError(f"unknown activation {act!r}")


def _out_depth(d_in: int, mode: str) -> int:
    return d_in - 2 if mode == "v" else d_in


def _acc(t: torch.Tensor) -> torch.Tensor:
    """The plain versions' working type: float32 for bfloat16 storage (the
    kernels' accumulation type), else the tensor's own (float64 stays
    float64 for gradcheck)."""
    return t.float() if t.dtype == torch.bfloat16 else t


def _ncdhw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 4, 1, 2, 3)


def _ndhwc(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 3, 4, 1)


def conv3x3_plain(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                  act: str = "none", alpha: float = 0.01,
                  mode: str = "v") -> torch.Tensor:
    """Plain version of :func:`conv3x3`: ``F.conv3d`` on a permuted view
    (bfloat16 computed in float32), then bias and activation, then x's
    type."""
    zpad = MODES[mode]
    y = _ndhwc(F.conv3d(_ncdhw(_acc(x)),
                        _acc(kernel).permute(4, 3, 0, 1, 2),
                        padding=(zpad, 0, 0)))
    y = y + (bias[None, :, None, None, :] if bias.ndim == 2 else bias)
    return activation(y, act, alpha).to(x.dtype).contiguous()


def _check_conf(act, mode):
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}")
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}: use 'v' or 's'")


def _check(x, kernel, bias, act, mode):
    _check_conf(act, mode)
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


def _on_card(name: str, dev: torch.device) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU one (run
    the plain version); raises for any other device."""
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {dev}")
    return True


def _kernel_args(name: str, storage, tensors, f32=()):
    """Check the card's operands: ``tensors`` in one storage type (float32
    or bfloat16), ``f32`` in float32, all contiguous.  Returns the entry
    point's dtype suffix."""
    if storage not in _SUFFIX:
        raise TypeError(f"{name} kernel takes float32 or bfloat16, got "
                        f"{storage}")
    for what, t, want in ([(n, t, storage) for n, t in tensors]
                          + [(n, t, torch.float32) for n, t in f32]):
        if t.dtype != want:
            raise TypeError(f"{name} kernel takes {want} {what}, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} kernel needs a contiguous {what}")
    return _SUFFIX[storage]


def _launch(entry: str, dev: torch.device, *args) -> None:
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, entry)(*args, stream)
    _build.check(entry, err)


def conv3x3(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
            act: str = "none", alpha: float = 0.01,
            mode: str = "v") -> torch.Tensor:
    """``act(conv3d(x, kernel) + bias)``, stride 1, H/W valid, D valid
    (``mode='v'``) or zero-padded by one plane (``mode='s'``).

    x: (B, D, H, W, C_in) float32 or bfloat16; kernel: (3, 3, 3, C_in,
    C_out) in x's type; bias: float32 (C_out,) or a per-output-plane
    (D_out, C_out) table (:func:`fold_bn_zsame`).  Returns (B, D_out, H-2,
    W-2, C_out) in x's type, accumulated in float32 (on the card, float32
    products in 3xTF32 on the tensor cores).
    """
    _check(x, kernel, bias, act, mode)
    if not _on_card("conv3x3", x.device):
        return conv3x3_plain(x, kernel, bias, act, alpha, mode)
    sfx = _kernel_args("conv3x3", x.dtype,
                       [("x", x), ("kernel", kernel)], [("bias", bias)])
    b, d, h, w, ci = x.shape
    co = kernel.shape[4]
    y = torch.empty((b, _out_depth(d, mode), h - 2, w - 2, co),
                    dtype=x.dtype, device=x.device)
    _launch(f"conv3x3_fwd_{sfx}", x.device,
            x.data_ptr(), kernel.data_ptr(), bias.data_ptr(), y.data_ptr(),
            b, d, h, w, ci, co, MODES[mode], int(bias.ndim == 2), ACTS[act],
            float(alpha))
    conv3x3.launches += 1
    return y


conv3x3.launches = 0   # kernel launches since the caller last reset it


# ---------------------------------------------------------------------------
# Backward: plain versions
# ---------------------------------------------------------------------------

def _round_bf16(x: float) -> float:
    """``x`` rounded to bfloat16 as torch rounds it (to float32, then to
    nearest, ties to even), computed without a tensor."""
    bits = struct.unpack("<I", struct.pack("<f", x))[0]
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return struct.unpack("<f", struct.pack("<I", bits))[0]


def _masked_cotangent(g: torch.Tensor, y: torch.Tensor, act: str,
                      alpha: float) -> torch.Tensor:
    """g' = g * act'(y) in the storage type, as s2d.py:879-889 forms it:
    for bfloat16 storage alpha, ELU's ``y + alpha`` and the product are each
    rounded to bfloat16 (the kernels round at the same places); returned in
    the working type."""
    if y.dtype != torch.bfloat16:
        return g * activation_grad(y, act, alpha)
    bf = torch.bfloat16
    alpha = _round_bf16(alpha)
    y = y.float()
    if act == "elu":
        dact = torch.where(y > 0, 1.0, (y + alpha).to(bf).float())
    else:
        dact = activation_grad(y, act, alpha)
    return (g.float() * dact).to(bf).float()


def conv3x3_bwd_dx_plain(g: torch.Tensor, y: torch.Tensor,
                         kernel: torch.Tensor, x_shape, act: str = "none",
                         alpha: float = 0.01, mode: str = "v"
                         ) -> torch.Tensor:
    """Plain version of :func:`conv3x3_bwd_dx`: the transposed conv of g'
    (``torch.nn.grad.conv3d_input``), bfloat16 computed in float32, then
    y's type."""
    gp = _masked_cotangent(g, y, act, alpha)
    b, d, h, w, ci = x_shape
    dx = torch.nn.grad.conv3d_input(
        (b, ci, d, h, w), _acc(kernel).permute(4, 3, 0, 1, 2), _ncdhw(gp),
        padding=(MODES[mode], 0, 0))
    return _ndhwc(dx).to(y.dtype).contiguous()


def conv3x3_bwd_dw_plain(x: torch.Tensor, g: torch.Tensor, y: torch.Tensor,
                         act: str = "none", alpha: float = 0.01,
                         mode: str = "v", bias_table: bool = False
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`conv3x3_bwd_dw`: ``dk`` from
    ``torch.nn.grad.conv3d_weight`` and ``db`` a sum of g', in the working
    type (float32 for bfloat16 storage)."""
    gp = _masked_cotangent(g, y, act, alpha)
    co = gp.shape[-1]
    dk = torch.nn.grad.conv3d_weight(
        _ncdhw(_acc(x)), (co, x.shape[-1], 3, 3, 3), _ncdhw(gp),
        padding=(MODES[mode], 0, 0))
    db = gp.sum(dim=(0, 2, 3)) if bias_table else gp.sum(dim=(0, 1, 2, 3))
    return dk.permute(2, 3, 4, 1, 0).contiguous(), db


def conv3x3_bwd_fused_plain(x, g, y, kernel, act="none", alpha=0.01,
                            mode="v", bias_table=False):
    """Plain version of :func:`conv3x3_bwd_fused`."""
    dx = conv3x3_bwd_dx_plain(g, y, kernel, x.shape, act, alpha, mode)
    return (dx,) + conv3x3_bwd_dw_plain(x, g, y, act, alpha, mode,
                                        bias_table)


# ---------------------------------------------------------------------------
# Backward: wrappers
# ---------------------------------------------------------------------------

def _check_bwd(x_shape, g, y, act, mode, kernel=None, x=None):
    _check_conf(act, mode)
    b, d, h, w, ci = x_shape
    if kernel is not None:
        co = kernel.shape[-1]
        if tuple(kernel.shape) != (3, 3, 3, ci, co):
            raise ValueError(f"kernel must be (3, 3, 3, {ci}, C_out), got "
                             f"{tuple(kernel.shape)}")
    else:
        co = g.shape[-1]
    want = (b, _out_depth(d, mode), h - 2, w - 2, co)
    for name, t in (("g", g), ("y", y)):
        if tuple(t.shape) != want:
            raise ValueError(f"{name} must be {want}, got {tuple(t.shape)}")
    for name, t in (("g", g), ("y", y), ("kernel", kernel), ("x", x)):
        if t is not None and t.device != y.device:
            raise ValueError(f"{name} is on {t.device}, y on {y.device}")


def _plan(with_dx: bool, sfx: str, x_shape, co: int,
          mode: str) -> Tuple[int, int]:
    """(n_tiles, n_part) of a fused or dW-only pass on this card: its db
    partial rows and its dW partial rows (one per persistent block of a
    fused pass, or per chunk of tiles of a dW-only pass)."""
    b, d, h, w, ci = x_shape
    n_tiles, n_blocks = ctypes.c_longlong(0), ctypes.c_int(0)
    err = _build.library().conv3x3_bwd_plan(
        int(with_dx), int(sfx == "bf16"), b, d, h, w, ci, co, MODES[mode],
        ctypes.byref(n_tiles), ctypes.byref(n_blocks))
    _build.check("conv3x3_bwd_plan", err)
    return n_tiles.value, n_blocks.value


def _dw_buffers(with_dx: bool, sfx: str, x_shape, co: int, mode: str,
                bias_table: bool, dev):
    """dk, db and the scratch of a fused or dW-only pass: the plan's rows
    of dW partials and per-tile db partials (float32), and the row count."""
    n_tiles, n_blocks = _plan(with_dx, sfx, x_shape, co, mode)
    ci = x_shape[-1]
    f32 = dict(dtype=torch.float32, device=dev)
    db_shape = (_out_depth(x_shape[1], mode), co) if bias_table else (co,)
    return (torch.empty((3, 3, 3, ci, co), **f32),
            torch.empty(db_shape, **f32),
            torch.empty((n_blocks, 27 * ci * co), **f32),
            torch.empty((n_tiles, co), **f32), n_blocks)


def conv3x3_bwd_dx(g: torch.Tensor, y: torch.Tensor, kernel: torch.Tensor,
                   x_shape, act: str = "none", alpha: float = 0.01,
                   mode: str = "v") -> torch.Tensor:
    """dx of :func:`conv3x3` (K3): the input gradient alone, in y's type.

    g, y: (B, D_out, H-2, W-2, C_out) cotangent and saved output; kernel:
    the (3, 3, 3, C_in, C_out) kernel of the forward, in y's type.  Sums
    are float32 (on the card, float32 products in 3xTF32 on the tensor
    cores)."""
    _check_bwd(x_shape, g, y, act, mode, kernel=kernel)
    if not _on_card("conv3x3_bwd_dx", y.device):
        return conv3x3_bwd_dx_plain(g, y, kernel, x_shape, act, alpha, mode)
    sfx = _kernel_args("conv3x3_bwd_dx", y.dtype,
                       [("g", g), ("y", y), ("kernel", kernel)])
    b, d, h, w, ci = x_shape
    dx = torch.empty(tuple(x_shape), dtype=y.dtype, device=y.device)
    _launch(f"conv3x3_bwd_dx_{sfx}", y.device,
            kernel.data_ptr(), y.data_ptr(), g.data_ptr(), dx.data_ptr(),
            b, d, h, w, ci, kernel.shape[-1], MODES[mode], ACTS[act],
            float(alpha))
    conv3x3_bwd_dx.launches += 1
    return dx


conv3x3_bwd_dx.launches = 0


def conv3x3_bwd_dw(x: torch.Tensor, g: torch.Tensor, y: torch.Tensor,
                   act: str = "none", alpha: float = 0.01, mode: str = "v",
                   bias_table: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, db) of :func:`conv3x3` (K4): the weight and bias gradients
    alone, float32 and deterministic (on the card, float32 products in
    3xTF32 on the tensor cores).  db is (C_out,), or (D_out, C_out) for a
    plane-table bias."""
    _check_bwd(x.shape, g, y, act, mode, x=x)
    if not _on_card("conv3x3_bwd_dw", y.device):
        return conv3x3_bwd_dw_plain(x, g, y, act, alpha, mode, bias_table)
    sfx = _kernel_args("conv3x3_bwd_dw", y.dtype,
                       [("x", x), ("g", g), ("y", y)])
    b, d, h, w, ci = x.shape
    co = g.shape[-1]
    dk, db, part, dbp, n_blocks = _dw_buffers(False, sfx, x.shape, co, mode,
                                              bias_table, y.device)
    _launch(f"conv3x3_bwd_dw_{sfx}", y.device,
            x.data_ptr(), y.data_ptr(), g.data_ptr(), dk.data_ptr(),
            db.data_ptr(), part.data_ptr(), dbp.data_ptr(),
            b, d, h, w, ci, co, MODES[mode], int(bias_table), ACTS[act],
            float(alpha), n_blocks)
    conv3x3_bwd_dw.launches += 1
    return dk, db


conv3x3_bwd_dw.launches = 0


def conv3x3_bwd_fused(x: torch.Tensor, g: torch.Tensor, y: torch.Tensor,
                      kernel: torch.Tensor, act: str = "none",
                      alpha: float = 0.01, mode: str = "v",
                      bias_table: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, dk, db) of :func:`conv3x3` in one pass (K2).  On the card, both
    types take only the channel counts that :func:`bwd_route` sends here
    (the tensor-core kernels keep the padded dW block in registers; float32
    products in 3xTF32)."""
    _check_bwd(x.shape, g, y, act, mode, kernel=kernel, x=x)
    if not _on_card("conv3x3_bwd_fused", y.device):
        return conv3x3_bwd_fused_plain(x, g, y, kernel, act, alpha, mode,
                                       bias_table)
    sfx = _kernel_args("conv3x3_bwd_fused", y.dtype,
                       [("x", x), ("g", g), ("y", y), ("kernel", kernel)])
    b, d, h, w, ci = x.shape
    co = kernel.shape[-1]
    if not _fused_fits(ci, co):
        raise ValueError(f"conv3x3_bwd_fused: {ci} -> {co} channels is "
                         f"outside the fused kernel's bound; bwd_route "
                         f"sends it to K3 + K4")
    dx = torch.empty_like(x)
    dk, db, part, dbp, n_blocks = _dw_buffers(True, sfx, x.shape, co, mode,
                                              bias_table, y.device)
    _launch(f"conv3x3_bwd_fused_{sfx}", y.device,
            x.data_ptr(), kernel.data_ptr(), y.data_ptr(), g.data_ptr(),
            dx.data_ptr(), dk.data_ptr(), db.data_ptr(), part.data_ptr(),
            dbp.data_ptr(), b, d, h, w, ci, co, MODES[mode],
            int(bias_table), ACTS[act], float(alpha), n_blocks)
    conv3x3_bwd_fused.launches += 1
    return dx, dk, db


conv3x3_bwd_fused.launches = 0

KERNEL_WRAPPERS = (conv3x3, conv3x3_bwd_fused, conv3x3_bwd_dx, conv3x3_bwd_dw)


class Conv3x3Fn(torch.autograd.Function):
    """Differentiable :func:`conv3x3`: ``apply(x, kernel, bias, act, alpha,
    mode)``.

    The kernel is cast to x's type for the forward (float32 parameters,
    bfloat16 compute, s2d.py ``_prep``); the gradients come back as x's
    type for x and float32 for kernel and bias.  The backward takes the
    route of :func:`bwd_route`: K2, or K3 + K4, when x needs a gradient; K4
    alone when it does not (data input); K3 alone, with no kernel and bias
    gradients, when they need none (frozen parameters)."""

    @staticmethod
    def forward(ctx, x, kernel, bias, act="none", alpha=0.01, mode="v"):
        kc = kernel.to(x.dtype).contiguous()
        y = conv3x3(x, kc, bias, act, alpha, mode)
        ctx.save_for_backward(x, kc, y)
        ctx.conf = (act, float(alpha), mode, bias.ndim == 2)
        return y

    @staticmethod
    def backward(ctx, g):
        x, kc, y = ctx.saved_tensors
        act, alpha, mode, table = ctx.conf
        g = g.to(y.dtype).contiguous()
        route = bwd_route(x.shape[-1], kc.shape[-1], ctx.needs_input_grad[0],
                          any(ctx.needs_input_grad[1:3]))
        dx: Optional[torch.Tensor] = None
        if route == "dx":
            return (conv3x3_bwd_dx(g, y, kc, x.shape, act, alpha, mode),
                    None, None, None, None, None)
        if route == "fused":
            dx, dk, db = conv3x3_bwd_fused(x, g, y, kc, act, alpha, mode,
                                           table)
        else:
            if route == "split":
                dx = conv3x3_bwd_dx(g, y, kc, x.shape, act, alpha, mode)
            dk, db = conv3x3_bwd_dw(x, g, y, act, alpha, mode, table)
        return dx, dk, db, None, None, None


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
