#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / CUDA port (stroke_prediction_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and exits
non-zero without one.  Phases:

1. card name and power limit (nvidia-smi), torch / CUDA versions, kernel
   build (nvcc, from ops/csrc in this checkout) and its seconds;
2. kernel phase, tester shapes: the float32 K1 (conv forward, 3xTF32 on
   the tensor cores) against its plain PyTorch version and against a
   float64 conv at the ten U-Net 3^3 convs on a 68x168x168 volume plus one
   z-SAME / ELU / plane-table case, with its TFLOP/s, tile efficiency and
   the replaced CUDA-core kernel's recorded time per layer; K5 (EDT
   parabola pass) at the tester's and the validation step's line shapes;
   kernel, plain and library times (CUDA events) and the least time the
   card could take (bound; for K1 both on the CUDA cores and in 3xTF32);
3. kernel phase, training shapes: at the ten convs of one training step
   (batch 6, 68x104x104 patch), in float32 and in bfloat16, K1 (on the
   tensor cores: bfloat16, and float32 in 3xTF32) and the backward
   kernels K2 (fused dx + dW; on the tensor cores, float32 in 3xTF32, at
   the layers its channel bound takes: L1, L2, L3, L10), K3 (dx) and K4
   (dW + db), both on the tensor cores, float32 in 3xTF32,
   against their plain versions, each at every layer whichever route the
   step takes there, K2 and K4 twice for bit-identical dW and db and K3
   twice for a bit-identical dx, the float32 K2 and K3 also against a
   float64 dgrad (and the float32 K2's dW and db, and the float32 K4's at
   the layers of its route, L1 and L4-L9, against a float64 wgrad); K2
   vs K3 + K4 per fused layer; K1 (both
   types) vs cuDNN's forward at every layer, K2 (both types) vs cuDNN's
   dgrad + wgrad per fused layer, K3 (both types) vs cuDNN's
   dgrad and K4 (both types) vs cuDNN's wgrad per layer of their route,
   each with its TFLOP/s and tile efficiency; a small 's' + ELU +
   plane-table case and an odd-channel (3 -> 4) one, forward (K1) and
   backward (the float32 K2, K3 and K4 against float64 there too), and
   K1, K3 and K4 at a wide 192 -> 64 layer (the Unet3D class default's
   L7), K3 there too twice and, in float32, K3 and K4 against float64;
   times as above, with cuDNN's forward and backward as the library
   yardsticks;
4. tester phase: the port's full-volume U-Net tester CLI on three
   synthetic 256x256x28 cases (resampled to 128x128x28, padded by 20 to
   68x168x168), channels 2 16 32 64 32 16 32 2 with seeded random weights
   and BN statistics; the launch counts of K1 and K5 in that run; finite
   outputs; one case re-run on the CPU (plain versions) and compared; a
   torch.profiler trace of three more cases;
5. training phase: the port's training CLI at the reference width and
   patch in its default bfloat16 on eight full-size synthetic cases (six
   train, two validate, batch 6, three epochs); the launch counts of K1-K5
   per step against the fused / split rule; finite losses, the artifacts,
   the best-valid model loaded and run; then 30 more training steps back
   to back (mean and spread of ms per step) and a torch.profiler trace of
   one step;
6. one float32 training step (batch 2, full width and patch) on the card
   and on the CPU from the same weights and crop: loss, every parameter
   gradient and the running statistics compared; the same step in float64
   on the CPU as a third witness of which side is further off.

Prints a ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
line.  Any failure raises and exits non-zero.
"""

import copy
import json
import os
import subprocess
import sys
import tempfile
import time

CHANNELS = (2, 16, 32, 64, 32, 16, 32, 2)
VOLUME_DHW = (68, 168, 168)          # 28 x 128 x 128 resampled, padded 20
PATCH_DHW = (68, 104, 104)           # the training patch, (W, H, D) reversed
TRAIN_BATCH = 6
FOLD = (0, 1, 2)
TRAIN_FOLD = tuple(range(8))         # 6 training + 2 validation cases
TIMED_STEPS = 30                     # training steps timed back to back
K1_TILE = (8, 16)                    # K1's tile (output plane), both types
K2_TILE = (9, 16)                    # K2's tile (input plane), both types
K3_TILE = (8, 16)                    # K3's tile (input plane), both types
K4_TILE = (9, 16)                    # K4's tile (output plane), both types
K1_TOL = dict(atol=1e-4, rtol=1e-4)  # sums of up to 27 * 96 terms, reordered
SLICE_ATOL = 1e-4                    # card vs CPU probabilities
# backward vs plain: float32 dx as K1; float32 dW / db sum up to 6 * 64 *
# 100 * 100 terms, so relative to the largest entry
DW_REL = 1e-4
# bfloat16 outputs (y, dx) vs the plain version on the same bfloat16
# inputs: both accumulate in float32 and round once to bfloat16, which may
# land one bfloat16 step (2^-8 of the value) apart
BF16_REL = 1e-2
# one float32 step, card vs CPU
STEP_LOSS_REL, STEP_GRAD_REL, STEP_STATS_ATOL = 1e-5, 1e-3, 1e-5

# the float32 K1, K2 and K3 vs a float64 conv / dgrad on the card, relative
# to max|ref|
F64_REL = 1e-5

# H100 SXM data-sheet peaks (dense): float32 outside the tensor cores, bf16
# on the tensor cores (the peak for bfloat16 inputs), float32 products as
# 3xTF32 on the tensor cores (three TF32 products each: a third of the 495
# TFLOP/s TF32 rate), HBM3
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "tf32x3": 495e12 / 3}
PEAK_BYTES = 3.35e12
# the float32 kernels on the tensor cores in 3xTF32
TF32X3_KERNELS = ("K1", "K2", "K3", "K4")

# the replaced CUDA-core float32 K1 (conv3x3_fwd.cu) per tester layer, ms on
# an NVIDIA H100 80GB HBM3 at 700 W, as PERF.md records it
CUDA_CORE_K1_MS = (0.2999, 1.2408, 0.3213, 0.6674, 0.1473, 0.2092, 1.2190,
                   0.3116, 1.4042, 0.3530)


def bound_ms(ops, nbytes, dtype="float32"):
    t_ops = ops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def peak_key(key, dname):
    """The PEAK_FLOPS entry of kernel ``key`` in storage type ``dname``."""
    return "tf32x3" if dname == "float32" and key in TF32X3_KERNELS else dname


def rel_err(got, ref):
    """max |got - ref| / max |ref|, in float32."""
    ref = ref.float()
    return float((got.float() - ref).abs().max() / ref.abs().max())


def tile_efficiency(plane, tile):
    """The real share of a (rows, columns) plane cut into ``tile``s."""
    (ph, pw), (th, tw) = plane, tile
    return ph * pw / (-(-ph // th) * th * -(-pw // tw) * tw)


def all_wrappers():
    from stroke_prediction_tpu_torch.ops.conv3x3 import KERNEL_WRAPPERS
    from stroke_prediction_tpu_torch.ops.edt import edt_parabola
    return KERNEL_WRAPPERS + (edt_parabola,)


def reset_launches():
    for fn in all_wrappers():
        fn.launches = 0


def read_launches():
    return {fn.__name__: fn.launches for fn in all_wrappers()}


def cuda_ms(torch, fn, iters):
    """Mean ms per call over ``iters`` calls, timed with CUDA events after a
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def unet_conv_shapes(dhw, channels):
    """(input D, H, W, C_in, C_out) of the U-Net's ten 3^3 convs."""
    c_in, b1, b2, b3, b4, b5, _, _ = channels
    shapes = []

    def block(s, ci, co):
        shapes.append((*s, ci, co))
        s = tuple(v - 2 for v in s)
        shapes.append((*s, co, co))
        return tuple(v - 2 for v in s)

    r1 = block(dhw, c_in, b1)
    r2 = block(tuple(v // 2 for v in r1), b1, b2)
    r3 = block(tuple(v // 2 for v in r2), b2, b3)
    r4 = block(tuple(2 * v for v in r3), b3 + b2, b4)
    block(tuple(2 * v for v in r4), b4 + b1, b5)
    return shapes


def kernel_phase(torch):
    import torch.nn.functional as F

    from stroke_prediction_tpu_torch.ops.conv3x3 import (
        conv3x3, conv3x3_plain, fold_bn_zsame)
    from stroke_prediction_tpu_torch.ops.edt import (
        _BIG, edt_parabola, edt_parabola_plain)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo

    k1 = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
              bound_ms_cuda_cores=0.0, max_abs_err=0.0, max_rel_err_f64=0.0,
              ops=0.0, bytes=0.0)
    print("K1 conv3x3_fwd per layer (batch 1, float32, 'v', LeakyReLU 0.01; "
          "3xTF32 on the tensor cores; err vs plain max|y - plain|, vs f64 "
          "max|y - ref64| / max|ref64|; bound CUDA cores / 3xTF32):")
    for i, (d, h, w, ci, co) in enumerate(
            unet_conv_shapes(VOLUME_DHW, CHANNELS), 1):
        x = uniform((1, d, h, w, ci), -1.0, 1.0)
        bnd = (27 * ci) ** -0.5
        k = uniform((3, 3, 3, ci, co), -bnd, bnd)
        b = uniform((co,), -bnd, bnd)
        y = conv3x3(x, k, b, "leaky_relu", 0.01)
        ref = conv3x3_plain(x, k, b, "leaky_relu", 0.01)
        ref64 = conv3x3_plain(x.double(), k.double(), b.double(),
                              "leaky_relu", 0.01)
        torch.cuda.synchronize()
        err = float((y - ref).abs().max())
        torch.testing.assert_close(y, ref, **K1_TOL)
        f64 = rel_err(y.double(), ref64)
        plain_f64 = rel_err(ref.double(), ref64)
        if f64 > F64_REL:
            raise AssertionError(f"K1 L{i} float32: {f64:.3e} of max|ref| "
                                 f"off the float64 conv")
        del ref64
        w_lib = k.permute(4, 3, 0, 1, 2).contiguous()
        x_lib = x.permute(0, 4, 1, 2, 3)                 # channels-last view
        iters = 10
        ms = cuda_ms(torch, lambda: conv3x3(x, k, b, "leaky_relu", 0.01),
                     iters)
        plain = cuda_ms(torch, lambda: conv3x3_plain(x, k, b, "leaky_relu",
                                                     0.01), iters)
        lib = cuda_ms(torch, lambda: F.conv3d(x_lib, w_lib, b), iters)
        ops = 2.0 * 27 * ci * co * (d - 2) * (h - 2) * (w - 2)
        nbytes = 4.0 * (x.numel() + k.numel() + b.numel() + y.numel())
        b_cc, by_cc = bound_ms(ops, nbytes)
        bms, by = bound_ms(ops, nbytes, "tf32x3")
        print(f"  L{i:<2} in {d}x{h}x{w} {ci:>2}->{co:<2} {ops / 1e9:6.2f} "
              f"GFLOP  kernel {ms:.4f} ms ({ops / ms / 1e9:.1f} TFLOP/s, "
              f"tile eff. {tile_efficiency((h - 2, w - 2), K1_TILE):.3f})  "
              f"CUDA-core K1 {CUDA_CORE_K1_MS[i - 1]:.4f} ms (recorded)  "
              f"plain {plain:.4f} ms  cuDNN {lib:.4f} ms  bound "
              f"{b_cc:.4f} ({by_cc[0]}) / {bms:.4f} ({by[0]}) ms  err vs "
              f"plain {err:.3e}, vs f64 {f64:.3e} (plain f32 vs f64 "
              f"{plain_f64:.3e})")
        for key, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                       ("bound_ms", bms), ("bound_ms_cuda_cores", b_cc),
                       ("ops", ops), ("bytes", nbytes)):
            k1[key] += v
        k1["max_abs_err"] = max(k1["max_abs_err"], err)
        k1["max_rel_err_f64"] = max(k1["max_rel_err_f64"], f64)
        del x, k, b, y, ref, x_lib, w_lib
    k1["bound_by"] = bound_ms(k1["ops"], k1["bytes"], "tf32x3")[1]
    print(f"  sum of the 10 layers: {k1['ops'] / 1e9:.2f} GFLOP  kernel "
          f"{k1['ms']:.4f} ms ({k1['ops'] / k1['ms'] / 1e9:.1f} TFLOP/s)  "
          f"CUDA-core K1 {sum(CUDA_CORE_K1_MS):.4f} ms (recorded)  plain "
          f"{k1['plain_ms']:.4f} ms  cuDNN {k1['library_ms']:.4f} ms  bound "
          f"CUDA cores {k1['bound_ms_cuda_cores']:.4f} ms / 3xTF32 "
          f"{k1['bound_ms']:.4f} ms  max err vs f64 "
          f"{k1['max_rel_err_f64']:.3e} of max|ref|")

    # z-SAME + ELU + per-plane bias table (the CAE encoder's form)
    x = uniform((1, 12, 20, 22, 8), -1.0, 1.0)
    k = uniform((3, 3, 3, 8, 16), -0.1, 0.1)
    k2, table = fold_bn_zsame(k, uniform((16,), -0.1, 0.1),
                              uniform((8,), 0.5, 1.5),
                              uniform((8,), -0.5, 0.5), 12)
    y = conv3x3(x, k2.contiguous(), table, "elu", 1.0, "s")
    ref = conv3x3_plain(x, k2, table, "elu", 1.0, "s")
    torch.cuda.synchronize()
    err_s = float((y - ref).abs().max())
    torch.testing.assert_close(y, ref, **K1_TOL)
    print(f"K1 's' + ELU + plane table (1, 12, 20, 22, 8->16): max|err| "
          f"{err_s:.3e}")
    k1["max_abs_err"] = max(k1["max_abs_err"], err_s)

    # K5: exact against the plain version; some lines without a site.
    # (3584, 128): a tester case's pass; (11424, 168): one at n = 168;
    # (3584, 64): a validation step's pass (2 x 28 x 64 lines of a 64^2
    # plane)
    k5 = {}
    for n_lines, n in ((28 * 128, 128), (68 * 168, 168), (2 * 28 * 64, 64)):
        f2 = torch.randint(0, n, (n_lines, n), generator=gen,
                           device=dev).float() ** 2
        f2[::8] = _BIG
        out = edt_parabola(f2)
        ref = edt_parabola_plain(f2)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        if not torch.equal(out, ref):
            raise AssertionError(f"K5 differs from its plain version at "
                                 f"({n_lines}, {n}): max|err| {err}")
        ms = cuda_ms(torch, lambda: edt_parabola(f2), 20)
        plain = cuda_ms(torch, lambda: edt_parabola_plain(f2), 5)
        ops = 2.0 * n_lines * n * n                      # add + min
        bms, by = bound_ms(ops, 8.0 * n_lines * n)
        print(f"K5 edt_parabola ({n_lines}, {n}): max|err| {err} (exact); "
              f"kernel {ms:.4f} ms  plain {plain:.4f} ms  bound {bms:.5f} ms "
              f"({by})")
        k5[(n_lines, n)] = dict(ms=ms, plain_ms=plain, bound_ms=bms,
                                bound_by=by)
        k5["max_abs_err"] = max(k5.get("max_abs_err", 0.0), err)
    print("K5 has no single PyTorch library call that computes it "
          "(library_ms null)")
    return k1, k5


def train_kernel_phase(torch):
    """K1 and K2-K4 at the ten convs of one training step, float32 and
    bfloat16.  Returns {dtype: [per-layer dict]} and the 's'-case errors."""
    from stroke_prediction_tpu_torch.ops.conv3x3 import (
        bwd_route, conv3x3, conv3x3_bwd_dw, conv3x3_bwd_dw_plain,
        conv3x3_bwd_dx, conv3x3_bwd_dx_plain, conv3x3_bwd_fused,
        conv3x3_plain, fold_bn_zsame)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)

    def uniform(shape, lo, hi, dtype=torch.float32):
        t = torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo
        return t.to(dtype)

    rel = {}     # (kernel, dtype) -> largest max|err| / max|ref| seen

    def note(key, got, ref):
        rel[key] = max(rel.get(key, 0.0), rel_err(got, ref))
        return float((got.float() - ref.float()).abs().max())

    def check_out(name, got, ref, dtype):
        """y / dx: float32 as K1; bfloat16 within one rounding step."""
        if dtype == torch.float32:
            torch.testing.assert_close(got, ref, **K1_TOL)
        elif rel_err(got, ref) > BF16_REL:
            raise AssertionError(f"{name}: rel err {rel_err(got, ref)}")
        return note((name.split()[0] + " y/dx", str(dtype)[6:]), got, ref)

    def check_sum(name, got, ref, dtype):
        """dW / db, float32 in both types."""
        if rel_err(got, ref) > DW_REL:
            raise AssertionError(f"{name}: rel err {rel_err(got, ref)}")
        return note((name.split()[0] + " dW/db", str(dtype)[6:]), got, ref)

    def check_f64(name, dx, g, y, k, x_shape, act, alpha, mode):
        """A float32 dx (K2, K3) vs a float64 dgrad on the card."""
        ref64 = conv3x3_bwd_dx_plain(g.double(), y.double(), k.double(),
                                     x_shape, act, alpha, mode)
        err = rel_err(dx.double(), ref64)
        if err > F64_REL:
            raise AssertionError(f"{name}: {err:.3e} of max|ref| off the "
                                 f"float64 dgrad")
        return err

    def check_f64_dw(name, dk, db, x, g, y, act, alpha, mode, table=False):
        """A float32 dW and db (K2, K4) vs a float64 wgrad on the card,
        held to the float32 dW limit."""
        rdk64, rdb64 = conv3x3_bwd_dw_plain(x.double(), g.double(),
                                            y.double(), act, alpha, mode,
                                            table)
        err = max(rel_err(dk.double(), rdk64), rel_err(db.double(), rdb64))
        if err > DW_REL:
            raise AssertionError(f"{name}: {err:.3e} of max|ref| off the "
                                 f"float64 wgrad")
        return err

    shapes = unet_conv_shapes(PATCH_DHW, CHANNELS)
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        nb = 2 if dtype == torch.bfloat16 else 4
        rows = []
        print(f"K1-K4 per layer of one training step (batch {TRAIN_BATCH}, "
              f"{dname}, 'v', LeakyReLU 0.01; ms kernel / plain / cuDNN / "
              f"bound):")
        for i, (d, h, w, ci, co) in enumerate(shapes, 1):
            route = bwd_route(ci, co, i > 1)
            # K2 takes only the channels its route allows (both types)
            k2 = bwd_route(ci, co) == "fused"
            x = uniform((TRAIN_BATCH, d, h, w, ci), -1.0, 1.0, dtype)
            bnd = (27 * ci) ** -0.5
            k = uniform((3, 3, 3, ci, co), -bnd, bnd, dtype)
            b = uniform((co,), -bnd, bnd)
            y = conv3x3(x, k, b, "leaky_relu", 0.01)
            err = {"K1": check_out(f"K1 L{i} {dname}", y,
                                   conv3x3_plain(x, k, b, "leaky_relu", 0.01),
                                   dtype)}
            g = uniform(y.shape, -1.0, 1.0, dtype)
            a = (g, y, "leaky_relu", 0.01)
            rdx = conv3x3_bwd_dx_plain(g, y, k, x.shape, "leaky_relu", 0.01)
            rdk, rdb = conv3x3_bwd_dw_plain(x, *a)
            dx3 = conv3x3_bwd_dx(g, y, k, x.shape, "leaky_relu", 0.01)
            dx3b = conv3x3_bwd_dx(g, y, k, x.shape, "leaky_relu", 0.01)
            dk4, db4 = conv3x3_bwd_dw(x, *a)
            dk4b, db4b = conv3x3_bwd_dw(x, *a)
            runs = [("K4", (dk4, db4), (dk4b, db4b))]
            if k2:
                dx2, dk2, db2 = conv3x3_bwd_fused(x, g, y, k, "leaky_relu",
                                                  0.01)
                dk2b, db2b = conv3x3_bwd_fused(x, g, y, k, "leaky_relu",
                                               0.01)[1:]
                runs.append(("K2", (dk2, db2), (dk2b, db2b)))
            torch.cuda.synchronize()
            if not torch.equal(dx3, dx3b):
                raise AssertionError(f"K3 L{i} {dname}: dx differs between "
                                     f"two runs")
            for name, p, q in runs:
                if not (torch.equal(p[0], q[0]) and torch.equal(p[1], q[1])):
                    raise AssertionError(f"{name} L{i} {dname}: dW or db "
                                         f"differs between two runs")
            tag = f"L{i} {dname}"
            f64 = {}
            if dtype == torch.float32:
                f64["K3"] = check_f64(f"K3 dx {tag}", dx3, g, y, k, x.shape,
                                      "leaky_relu", 0.01, "v")
                if k2:
                    f64["K2"] = check_f64(f"K2 dx {tag}", dx2, g, y, k,
                                          x.shape, "leaky_relu", 0.01, "v")
                    f64["K2 dW"] = check_f64_dw(f"K2 dk, db {tag}", dk2,
                                                db2, x, *a, "v")
                if route in ("dw", "split"):
                    f64["K4 dW"] = check_f64_dw(f"K4 dk, db {tag}", dk4,
                                                db4, x, *a, "v")
            if k2:
                err["K2"] = max(check_out(f"K2 dx {tag}", dx2, rdx, dtype),
                                check_sum(f"K2 dk {tag}", dk2, rdk, dtype),
                                check_sum(f"K2 db {tag}", db2, rdb, dtype))
                del dx2, dk2, db2, dk2b, db2b
            err["K3"] = check_out(f"K3 dx {tag}", dx3, rdx, dtype)
            err["K4"] = max(check_sum(f"K4 dk {tag}", dk4, rdk, dtype),
                            check_sum(f"K4 db {tag}", db4, rdb, dtype))
            del rdx, rdk, rdb, dx3, dx3b, dk4, db4, dk4b, db4b, runs

            # times; the library yardstick is cuDNN's dgrad / wgrad on the
            # masked cotangent (TF32 off), which the port never calls
            iters = 5
            gp = (g.float() * torch.where(y > 0, 1.0, 0.01)).to(dtype)
            x_l, g_l = x.permute(0, 4, 1, 2, 3), gp.permute(0, 4, 1, 2, 3)
            w_l = k.permute(4, 3, 0, 1, 2).contiguous()
            in_size = tuple(x_l.shape)
            w_size = tuple(w_l.shape)
            ms = {
                "K1": cuda_ms(torch, lambda: conv3x3(
                    x, k, b, "leaky_relu", 0.01), iters),
                "K3": cuda_ms(torch, lambda: conv3x3_bwd_dx(
                    g, y, k, x.shape, "leaky_relu", 0.01), iters),
                "K4": cuda_ms(torch, lambda: conv3x3_bwd_dw(x, *a), iters)}
            if k2:
                ms["K2"] = cuda_ms(torch, lambda: conv3x3_bwd_fused(
                    x, g, y, k, "leaky_relu", 0.01), iters)
            plain = {
                "K1": cuda_ms(torch, lambda: conv3x3_plain(
                    x, k, b, "leaky_relu", 0.01), iters),
                "K3": cuda_ms(torch, lambda: conv3x3_bwd_dx_plain(
                    g, y, k, x.shape, "leaky_relu", 0.01), iters),
                "K4": cuda_ms(torch, lambda: conv3x3_bwd_dw_plain(x, *a),
                              iters)}
            plain["K2"] = plain["K3"] + plain["K4"]
            lib = {
                "K1": cuda_ms(torch, lambda: torch.nn.functional.conv3d(
                    x_l, w_l, b.to(dtype)), iters),
                "K3": cuda_ms(torch, lambda: torch.nn.grad.conv3d_input(
                    in_size, w_l, g_l), iters),
                "K4": cuda_ms(torch, lambda: torch.nn.grad.conv3d_weight(
                    x_l, w_size, g_l), iters)}
            lib["K2"] = lib["K3"] + lib["K4"]
            flops = 2.0 * 27 * ci * co * y[..., 0].numel()
            nx, ny, nk = x.numel(), y.numel(), k.numel()
            ops = {"K1": flops, "K2": 2 * flops, "K3": flops, "K4": flops}
            nbytes = {                      # each input once, each output once
                "K1": nb * (nx + nk + ny) + 4 * co,
                "K2": nb * (nx + 2 * ny + nk + nx) + 4 * (nk + co),
                "K3": nb * (2 * ny + nk + nx),
                "K4": nb * (nx + 2 * ny) + 4 * (nk + co)}
            bnd_ms = {key: bound_ms(ops[key], nbytes[key],
                                    peak_key(key, dname))
                      for key in ops}
            rows.append(dict(layer=i, route=route, shape=(d, h, w, ci, co),
                             err=err, f64=f64, ms=ms, plain=plain, lib=lib,
                             bound=bnd_ms, ops=ops, bytes=nbytes))
            print(f"  L{i:<2} in {d}x{h}x{w} {ci:>2}->{co:<2} route "
                  f"{route:5s} "
                  + "  ".join(f"{key} {ms[key]:.4f}/{plain[key]:.4f}/"
                              f"{lib[key]:.4f}/{bnd_ms[key][0]:.4f}"
                              f"({bnd_ms[key][1][0]})" for key in ms)
                  + "  max|err| " + " ".join(f"{key} {v:.3e}"
                                             for key, v in err.items())
                  + "".join(f"  {key} vs f64 {v:.3e} of max|ref|"
                            for key, v in f64.items()))

            def vs_library(key, call, tile, plane):
                """A kernel against cuDNN at this layer; its tile
                efficiency is the real share of the tiled plane (K1 and K4
                tile the output plane, K2 and K3 the input plane)."""
                print(f"      L{i} {key} {ms[key]:.4f} ms vs cuDNN {call} "
                      f"{lib[key]:.4f} ms ({ms[key] / lib[key]:.2f}x); {key} "
                      f"at {ops[key] / ms[key] / 1e9:.1f} TFLOP/s; tile "
                      f"efficiency {tile_efficiency(plane, tile):.3f} "
                      f"({tile[0]}x{tile[1]} tiles over "
                      f"{plane[0]}x{plane[1]}); bound "
                      f"{bnd_ms[key][0]:.4f} ms ({peak_key(key, dname)})")

            vs_library("K1", "forward", K1_TILE, (h - 2, w - 2))
            if route == "fused":
                split = ms["K3"] + ms["K4"]
                print(f"      L{i} K2 {ms['K2']:.4f} ms vs K3 + K4 "
                      f"{split:.4f} ms ({split / ms['K2']:.2f}x)")
                vs_library("K2", "dgrad + wgrad", K2_TILE, (h, w))
            if route == "split":
                vs_library("K3", "dgrad", K3_TILE, (h, w))
            if route in ("dw", "split"):
                vs_library("K4", "wgrad", K4_TILE, (h - 2, w - 2))
            del x, k, b, y, g, gp, x_l, g_l, w_l
        results[dname] = rows

    # z-SAME + ELU + per-plane bias table, forward and backward (the CAE
    # encoder's form), and an odd channel count (3 -> 4: padded channels,
    # scalar staging) in 'v' + LeakyReLU
    s_err = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        for case, (shape, co, act, alpha, mode) in (
                ("'s' + ELU + plane table", ((2, 12, 20, 22, 8), 16, "elu",
                                             1.0, "s")),
                ("3 -> 4", ((2, 9, 23, 37, 3), 4, "leaky_relu", 0.01,
                            "v"))):
            x = uniform(shape, -1.0, 1.0, dtype)
            ci, d_out = shape[-1], shape[1] - 2 * (mode == "v")
            k, bias = fold_bn_zsame(uniform((3, 3, 3, ci, co), -0.1, 0.1),
                                    uniform((co,), -0.1, 0.1),
                                    uniform((ci,), 0.5, 1.5),
                                    uniform((ci,), -0.5, 0.5), d_out)
            table = mode == "s"
            if not table:
                bias = bias[0].contiguous()
            k = k.to(dtype).contiguous()
            y = conv3x3(x, k, bias, act, alpha, mode)
            ry = conv3x3_plain(x, k, bias, act, alpha, mode)
            g = uniform(y.shape, -1.0, 1.0, dtype)
            a = (g, y, act, alpha, mode)
            rdx = conv3x3_bwd_dx_plain(g, y, k, x.shape, act, alpha, mode)
            rdk, rdb = conv3x3_bwd_dw_plain(x, *a, table)
            dx2, dk2, db2 = conv3x3_bwd_fused(x, *a[:2], k, *a[2:], table)
            dk2b, db2b = conv3x3_bwd_fused(x, *a[:2], k, *a[2:], table)[1:]
            dx3 = conv3x3_bwd_dx(g, y, k, x.shape, act, alpha, mode)
            dx3b = conv3x3_bwd_dx(g, y, k, x.shape, act, alpha, mode)
            dk4, db4 = conv3x3_bwd_dw(x, *a, table)
            dk4b, db4b = conv3x3_bwd_dw(x, *a, table)
            torch.cuda.synchronize()
            for name, p, q in (("K2", (dk2, db2), (dk2b, db2b)),
                               ("K4", (dk4, db4), (dk4b, db4b))):
                if not (torch.equal(p[0], q[0]) and torch.equal(p[1], q[1])):
                    raise AssertionError(f"{name} {case} {dname}: dW or db "
                                         f"differs between two runs")
            if not torch.equal(dx3, dx3b):
                raise AssertionError(f"K3 {case} {dname}: dx differs "
                                     f"between two runs")
            if dtype == torch.float32:
                s_err[f"K3 {case} float32 vs f64"] = check_f64(
                    f"K3 {case} dx", dx3, g, y, k, x.shape, act, alpha, mode)
                s_err[f"K2 {case} float32 vs f64"] = check_f64(
                    f"K2 {case} dx", dx2, g, y, k, x.shape, act, alpha, mode)
                s_err[f"K2 {case} float32 dW, db vs f64"] = check_f64_dw(
                    f"K2 {case} dk, db", dk2, db2, x, *a, table)
                s_err[f"K4 {case} float32 dW, db vs f64"] = check_f64_dw(
                    f"K4 {case} dk, db", dk4, db4, x, *a, table)
            s_err[f"{case} {dname}"] = max(
                check_out(f"K1 {case} y", y, ry, dtype),
                check_out(f"K2 {case} dx", dx2, rdx, dtype),
                check_out(f"K3 {case} dx", dx3, rdx, dtype),
                *(check_sum(n, p, q, dtype) for n, p, q in (
                    (f"K2 {case} dk", dk2, rdk), (f"K2 {case} db", db2, rdb),
                    (f"K4 {case} dk", dk4, rdk),
                    (f"K4 {case} db", db4, rdb))))
    print(f"K1-K4 's' + ELU + plane table (2, 12, 20, 22, 8->16) and 3 -> 4 "
          f"(2, 9, 23, 37): max|err| {s_err}")

    # K1, K3 and K4 at a wide layer: the Unet3D class default (2, 32, 64,
    # 128, 64, 32, 32, 2) has a 192 -> 64 conv (L7), which the bfloat16 K1
    # takes as 12 chunks of 16 input channels, K3 as two N slices of 96
    # input channels and K4 as 12 x 4 slice pairs (12 x 2 of 16 x 32
    # channels in float32)
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        shape, co = (2, 10, 20, 22, 192), 64
        x = uniform(shape, -1.0, 1.0, dtype)
        k = uniform((3, 3, 3, 192, co), -192 ** -0.5, 192 ** -0.5, dtype)
        bias = uniform((co,), -0.1, 0.1)
        y = conv3x3(x, k, bias, "leaky_relu", 0.01)
        ry = conv3x3_plain(x, k, bias, "leaky_relu", 0.01)
        g = uniform(y.shape, -1.0, 1.0, dtype)
        a = (g, y, "leaky_relu", 0.01)
        dx3 = conv3x3_bwd_dx(g, y, k, shape, "leaky_relu", 0.01)
        dx3b = conv3x3_bwd_dx(g, y, k, shape, "leaky_relu", 0.01)
        rdx = conv3x3_bwd_dx_plain(g, y, k, shape, "leaky_relu", 0.01)
        dk4, db4 = conv3x3_bwd_dw(x, *a)
        dk4b, db4b = conv3x3_bwd_dw(x, *a)
        rdk, rdb = conv3x3_bwd_dw_plain(x, *a)
        torch.cuda.synchronize()
        if not (torch.equal(dk4, dk4b) and torch.equal(db4, db4b)):
            raise AssertionError(f"K4 192 -> 64 {dname}: dW or db differs "
                                 f"between two runs")
        if not torch.equal(dx3, dx3b):
            raise AssertionError(f"K3 192 -> 64 {dname}: dx differs between "
                                 f"two runs")
        if dtype == torch.float32:
            s_err["K3 192 -> 64 float32 vs f64"] = check_f64(
                "K3 192->64 dx", dx3, g, y, k, shape, "leaky_relu", 0.01,
                "v")
            s_err["K4 192 -> 64 float32 dW, db vs f64"] = check_f64_dw(
                "K4 192->64 dk, db", dk4, db4, x, *a, "v")
        s_err[f"K1 192 -> 64 {dname}"] = check_out(
            f"K1 192->64 y {dname}", y, ry, dtype)
        s_err[f"K3 192 -> 64 {dname}"] = check_out(
            f"K3 192->64 dx {dname}", dx3, rdx, dtype)
        s_err[f"K4 192 -> 64 {dname}"] = max(
            check_sum(f"K4 192->64 dk {dname}", dk4, rdk, dtype),
            check_sum(f"K4 192->64 db {dname}", db4, rdb, dtype))
    print(f"K1, K3, K4 192 -> 64 {shape}: max|err| " + "; ".join(
        f"{dname} " + ", ".join(f"{s_err[f'{kn} 192 -> 64 {dname}']:.3e}"
                                for kn in ("K1", "K3", "K4"))
        for dname in ("float32", "bfloat16")))
    print("largest max|err| / max|ref| over the layers (y, dx in the "
          "storage type; dW, db float32 in both): " + "; ".join(
              f"{k} {d} {v:.3e}" for (k, d), v in sorted(rel.items())))
    return results, s_err


def slice_phase(torch, work):
    from stroke_prediction_tpu_torch.cli import test_unet_segmentation as cli
    from stroke_prediction_tpu_torch.eval.unet_tester import (
        UnetSegmentationTester)
    from stroke_prediction_tpu_torch.models.convert import save_unet_checkpoint
    from stroke_prediction_tpu_torch.models.unet3d import Unet3D
    from stroke_prediction_tpu_torch.utils.args import get_args_unet_training
    from stroke_prediction_tpu_torch.utils.nifti import read_nifti

    gen = torch.Generator().manual_seed(0)
    model = Unet3D(CHANNELS, generator=gen)
    with torch.no_grad():
        for m in model.modules():
            if hasattr(m, "var"):                    # BatchNorm
                m.scale.uniform_(0.8, 1.2, generator=gen)
                m.bias.uniform_(-0.1, 0.1, generator=gen)
                m.mean.uniform_(-0.5, 0.5, generator=gen)
                m.var.uniform_(0.5, 2.0, generator=gen)
    ckpt = os.path.join(work, "unet.model")
    save_unet_checkpoint(ckpt, model)

    out_base = os.path.join(work, "unet")
    args = get_args_unet_training(
        [ckpt, "--synthetic", "--fold", *map(str, FOLD), "--outbasepath",
         out_base, "--device", "cuda", "--channels", *map(str, CHANNELS)])

    reset_launches()
    t0 = time.perf_counter()
    tester = cli.test(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    print(f"slice: tester CLI on {len(FOLD)} cases in {wall:.2f} s; "
          f"launches {launches}")
    if any(launches[k] for k in ("conv3x3_bwd_fused", "conv3x3_bwd_dx",
                                 "conv3x3_bwd_dw")):
        raise AssertionError("the tester launched a backward kernel")
    n = len(tester.case_seconds)
    if n != len(FOLD):
        raise AssertionError(f"tester ran {n} cases, expected {len(FOLD)}")
    if launches["conv3x3"] != 10 * n:
        raise AssertionError(f"K1 launched {launches['conv3x3']} times, "
                             f"expected 10 per case")
    if launches["edt_parabola"] != 8 * n:
        raise AssertionError(f"K5 launched {launches['edt_parabola']} times, "
                             f"expected 8 per case")
    steady = tester.case_seconds[1:]
    infer_ms = 1e3 * sum(s[1] for s in steady) / len(steady)
    total_ms = 1e3 * sum(s[2] for s in steady) / len(steady)
    print(f"slice: ms per case after the first: {infer_ms:.2f} to metrics on "
          f"the host (forward + Dice/HD/ASSD), {total_ms:.2f} incl. the "
          f"NIfTI dumps; per case (id, s, s): {tester.case_seconds}")

    for cid, _, _ in tester.case_seconds:
        for part in ("_core", "_penu"):
            vol, _ = read_nifti(f"{out_base}_{cid}{part}.nii.gz")
            if vol.shape != (256, 256, 28) or not vol.size:
                raise AssertionError(f"case {cid}{part}: shape {vol.shape}")
            if not (vol.min() >= 0.0 and vol.max() <= 1.0):
                raise AssertionError(f"case {cid}{part}: values outside "
                                     f"[0, 1] or not finite")

    # one case again on the card and on the CPU (plain versions)
    loader = tester._dataloader
    batch = loader.dataset.stack([loader.indices[0]])
    with torch.inference_mode():
        m_gpu, seg_gpu = tester.infer_batch(batch)
        cpu = UnetSegmentationTester(loader, ckpt, out_base + "_cpu", None,
                                     "cpu")
        t0 = time.perf_counter()
        m_cpu, seg_cpu = cpu.infer_batch(batch)
        cpu_s = time.perf_counter() - t0
    seg_gpu = seg_gpu.cpu()
    if tuple(seg_gpu.shape) != (1, 28, 128, 128, 2):
        raise AssertionError(f"output shape {tuple(seg_gpu.shape)}")
    if not torch.isfinite(seg_gpu).all():
        raise AssertionError("non-finite probabilities on the card")
    err = float((seg_gpu - seg_cpu).abs().max())
    print(f"slice: case {int(batch['case_id'][0])} card vs CPU max|prob err| "
          f"{err:.3e} (CPU plain path {cpu_s:.1f} s); Dice core "
          f"{m_gpu['core'].dc:.6f} / {m_cpu['core'].dc:.6f}, penumbra "
          f"{m_gpu['penu'].dc:.6f} / {m_cpu['penu'].dc:.6f}; HD core "
          f"{m_gpu['core'].hd:.4f} / {m_cpu['core'].hd:.4f}")
    if err > SLICE_ATOL:
        raise AssertionError(f"card and CPU probabilities differ by {err}")
    for part in ("core", "penu"):
        for f in ("dc", "hd", "assd"):
            a, b = getattr(m_gpu[part], f), getattr(m_cpu[part], f)
            if abs(a - b) > 1e-3 * max(1.0, abs(b)):
                raise AssertionError(f"{part} {f}: card {a} vs CPU {b}")
    profile_cases(torch, tester, batch, infer_ms)
    return launches, infer_ms


def train_phase(torch, work):
    """The port's training CLI at the reference configuration on the card:
    launch counts per step, finite losses, artifacts, the best-valid model
    loaded and run, ms per step, a profile of one step."""
    from stroke_prediction_tpu_torch.cli import train_unet_segmentation as cli
    from stroke_prediction_tpu_torch.models.factory import load_model
    from stroke_prediction_tpu_torch.ops.conv3x3 import bwd_route
    from stroke_prediction_tpu_torch.utils.args import get_args_unet_training

    base = os.path.join(work, "train")
    args = get_args_unet_training(
        [os.path.join(work, "unused.model"), "--synthetic",
         "--fold", *map(str, TRAIN_FOLD), "--validsetsize", "0.25",
         "--batchsize", str(TRAIN_BATCH), "--epochs", "3",
         "--outbasepath", base, "--device", "cuda",
         "--channels", *map(str, CHANNELS)])
    if args.dtype != "bfloat16":
        raise AssertionError(f"the CLI's default dtype is {args.dtype}")

    reset_launches()
    t0 = time.perf_counter()
    learner = cli.train(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    steps = dict(learner.step_counts)
    print(f"\ntrain: CLI, 3 epochs in {wall:.2f} s; steps {steps}; "
          f"launches {launches}")

    # launches per step from the fused / split rule
    routes = [bwd_route(ci, co, i > 0) for i, (*_, ci, co) in
              enumerate(unet_conv_shapes(PATCH_DHW, CHANNELS))]
    n_train, n_eval = steps["train"], steps["eval"]
    want = {
        "conv3x3": 10 * (n_train + n_eval + steps["visual"]),
        "conv3x3_bwd_fused": routes.count("fused") * n_train,
        "conv3x3_bwd_dx": routes.count("split") * n_train,
        "conv3x3_bwd_dw": (routes.count("split") + routes.count("dw"))
        * n_train,
        "edt_parabola": 8 * n_eval}
    print(f"train: routes per layer {routes}; expected launches {want}")
    if n_train != 3 or n_eval != 3:
        raise AssertionError(f"expected 3 train and 3 eval steps: {steps}")
    for name, n in want.items():
        if launches[name] != n or n < 1:
            raise AssertionError(f"{name} launched {launches[name]} times, "
                                 f"expected {n} (>= 1)")

    curves = learner._metric_dtos
    for phase in ("training", "validate"):
        losses = [m["loss"] for m in curves[phase]]
        print(f"train: {phase} losses {losses}")
        if len(losses) != 3 or not all(0.0 <= v <= 1.0 for v in losses):
            raise AssertionError(f"{phase} losses {losses}")
    names = ["_unet.model", "_unet.optim", "_unet.json", "_unet_final.model"]
    try:
        import matplotlib  # noqa: F401
        names += ["_visual_1.png", "_visual_plots.png"]
    except ImportError:
        print("train: no matplotlib here, so no PNGs are expected")
    for suffix in names:
        if not os.path.getsize(base + suffix):
            raise AssertionError(f"empty {base + suffix}")
    model, config = load_model(base + "_unet.model", "cuda")
    with torch.no_grad():
        seg = model(torch.zeros((1,) + PATCH_DHW + (2,), device="cuda"))
    torch.cuda.synchronize()
    if tuple(seg.shape) != (1, 28, 64, 64, 2) or not torch.isfinite(
            seg).all():
        raise AssertionError(f"best-valid model: output {tuple(seg.shape)}")
    print(f"train: best-valid model {config} runs: output "
          f"{tuple(seg.shape)}")

    print(f"train: CLI training passes (s, steps): "
          f"{learner.train_pass_seconds}")
    step_ms = time_steps(torch, learner)
    profile_step(torch, learner)
    return launches, step_ms, learner


def time_steps(torch, learner, n=TIMED_STEPS):
    """``n`` of the learner's training steps back to back on the stacked
    training cases, as its training pass runs them (gather, crop, forward,
    loss, backward, Adam, metrics on the device), after one warm-up step.
    Host ms per step between two synchronizes, and the spread of the device
    ms between CUDA events recorded after each step.  Returns the mean of
    the events' ms per step."""
    data, _ = learner.device_data(learner._dataloader_training)
    rows = torch.arange(TRAIN_BATCH, device="cuda")

    def step():
        learner.train_step({k: None if v is None else v.index_select(0, rows)
                            for k, v in data.items()})

    step()
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    marks[0].record()
    for i in range(n):
        step()
        marks[i + 1].record()
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0) / n
    per = sorted(marks[i].elapsed_time(marks[i + 1]) for i in range(n))
    mean = sum(per) / n
    std = (sum((v - mean) ** 2 for v in per) / n) ** 0.5
    print(f"train: {n} steps back to back (bfloat16, batch {TRAIN_BATCH}): "
          f"host {host_ms:.3f} ms per step; CUDA events per step mean "
          f"{mean:.3f} ms, std {std:.3f}, min {per[0]:.3f}, median "
          f"{per[n // 2]:.3f}, max {per[-1]:.3f}")
    return mean


def profile_step(torch, learner):
    """One training step: device time by phase (CUDA events around the
    parts of ``UnetSegmentationLearner.train_step``) and by kernel
    (torch.profiler), and the device's busy share of the step's wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    data, _ = learner.device_data(learner._dataloader_training)
    rows = torch.arange(TRAIN_BATCH, device="cuda")
    batch = {k: None if v is None else v.index_select(0, rows)
             for k, v in data.items()}
    model, opt = learner._model.train(), learner._optimizer

    def step(marks):
        marks[0].record()
        images, labels = learner.crop(batch)
        loss, outs = learner.forward_loss(images, labels)
        marks[1].record()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        marks[2].record()
        opt.step()
        marks[3].record()
        with torch.no_grad():
            learner._metrics(loss, *(o.detach() for o in outs),
                             training=True)
        marks[4].record()

    marks = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    step(marks)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(marks)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    phases = ["crop + forward + loss", "backward", "Adam", "metrics"]
    print(f"train profile: one step {wall_ms:.2f} ms (host clock); by phase "
          f"(CUDA events): " + "; ".join(
              f"{name} {marks[i].elapsed_time(marks[i + 1]):.3f} ms"
              for i, name in enumerate(phases)))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(marks)
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if not busy_ms:
        print("train profile: no device time in the trace (not measured)")
        return
    print(f"train profile: device busy {busy_ms:.3f} ms of {wall_ms:.2f} ms "
          f"({100 * busy_ms / wall_ms:.1f}% busy); "
          f"{sum(e.count for e in kernels)} kernels")
    rules = [("conv3x3_fwd", "K1 conv forward"),
             ("conv3x3_bwd_dx_tc_kernel", "K3 dx"),
             ("conv3x3_bwd_dw_tc_kernel", "K4 dW"),
             ("conv3x3_bwd_tc_kernel", "K2 fused"),
             ("conv3x3_bwd_dx_f32_tc_kernel", "K3 dx (float32)"),
             ("conv3x3_bwd_f32_tc_kernel", "K2 fused (float32)"),
             ("conv3x3_bwd_dw_f32_tc_kernel", "K4 dW (float32)"),
             ("finalize", "K2/K4 dW, db reductions"),
             ("MeanOps", "BN moments (means)"), ("MaxOps", "max reductions"),
             ("multi_tensor_apply", "Adam (foreach)"),
             ("gemm", "matmuls (upsample, 1^3 head)"),
             ("xmma", "matmuls (upsample, 1^3 head)"),
             ("Memcpy", "copies"), ("copy", "copies / casts")]
    groups = {}
    for e in kernels:
        g = next((name for frag, name in rules if frag in e.key),
                 "other elementwise / reductions")
        groups[g] = groups.get(g, 0.0) + e.self_device_time_total / 1e3
    print("  by kernel: " + "; ".join(
        f"{g} {ms:.3f} ms ({100 * ms / busy_ms:.1f}%)"
        for g, ms in sorted(groups.items(), key=lambda kv: -kv[1])))
    for e in kernels[:15]:
        ms = e.self_device_time_total / 1e3
        print(f"  {ms:8.4f} ms {100 * ms / busy_ms:5.1f}%  x{e.count}"
              f"  {e.key[:100]}")


def step_vs_cpu(torch, learner):
    """One float32 training step (forward, loss, backward; no optimizer
    step) at full width and patch, batch 2, on the card and on the CPU from
    the same weights and crop; the same step in float64 on the CPU says
    which float32 side is further off, and by which gradient."""
    from stroke_prediction_tpu_torch.data.augment import (
        crop_patch, random_offsets)
    from stroke_prediction_tpu_torch.data.dataset import (
        KEY_IMAGES, KEY_LABELS)
    from stroke_prediction_tpu_torch.models.unet3d import Unet3D

    data, _ = learner.device_data(learner._dataloader_training)
    images = data[KEY_IMAGES][:2].cpu()
    labels = data[KEY_LABELS][:2].cpu()
    offsets = random_offsets(torch.Generator().manual_seed(2), 2,
                             tuple(images.shape[1:4]), PATCH_DHW[::-1])
    imgs, labs = crop_patch(images, labels, offsets, PATCH_DHW[::-1],
                            (20, 20, 20))
    model = Unet3D(CHANNELS, generator=torch.Generator().manual_seed(3))
    out = {}
    for side, dev, dtype in (("card", "cuda", torch.float32),
                             ("CPU", "cpu", torch.float32),
                             ("CPU float64", "cpu", torch.float64)):
        m = copy.deepcopy(model).to(dev, dtype).train()
        m.compute_dtype = dtype
        t0 = time.perf_counter()
        seg = m(imgs.to(dev))
        labs_d = labs.to(dev, dtype)
        loss = learner.loss(seg[..., 0:1], seg[..., 1:2], labs_d[..., 0:1],
                            labs_d[..., 1:2])
        loss.backward()
        if dev == "cuda":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        out[side] = (float(loss.detach()),
                     {k: p.grad.cpu().double()
                      for k, p in m.named_parameters()},
                     {k: b.cpu().double() for k, b in m.named_buffers()},
                     secs)

    def compare(a, b):
        """(loss rel, (worst grad err / max|grad|, its name), stats err)."""
        (l_a, g_a, b_a, _), (l_b, g_b, b_b, _) = out[a], out[b]
        grad = max((rel_err(g_a[k], g_b[k]), k) for k in g_b)
        stats = max(float((b_a[k] - b_b[k]).abs().max()) for k in b_b)
        print(f"step {a} vs {b} (batch 2, {len(g_b)} gradients): loss "
              f"{l_a:.9f} / {l_b:.9f} (rel {abs(l_a - l_b) / abs(l_b):.2e}); "
              f"max grad err {grad[0]:.2e} of max|grad| at {grad[1]}; "
              f"running stats max|err| {stats:.2e}")
        return abs(l_a - l_b) / abs(l_b), grad, stats

    print("\nstep seconds: " + ", ".join(f"{side} {v[3]:.2f} s"
                                         for side, v in out.items()))
    loss_rel, grad, stats_err = compare("card", "CPU")
    card64 = compare("card", "CPU float64")
    cpu64 = compare("CPU", "CPU float64")
    print(f"step float32 vs float64: card {card64[1][0]:.2e}, CPU "
          f"{cpu64[1][0]:.2e} of max|grad|: the "
          f"{'card' if card64[1][0] > cpu64[1][0] else 'CPU'} is further off")
    if loss_rel > STEP_LOSS_REL or grad[0] > STEP_GRAD_REL or \
            stats_err > STEP_STATS_ATOL:
        raise AssertionError("card and CPU training steps differ")
    return dict(loss_rel=loss_rel, grad_rel=grad[0], worst_grad=grad[1],
                stats_err=stats_err, card_vs_f64=card64[1][0],
                cpu_vs_f64=cpu64[1][0])


def profile_cases(torch, tester, batch, infer_ms, reps=3):
    """Device time per tester case by kernel (torch.profiler, CUPTI) and the
    device's busy share of the unprofiled ms per case."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            tester.infer_batch(batch)
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
    if not busy_ms:
        print("profile: no device time in the trace (not measured)")
        return
    print(f"profile: device busy {busy_ms:.3f} ms per case of {infer_ms:.2f} "
          f"ms ({100 * busy_ms / infer_ms:.1f}% busy); "
          f"{sum(e.count for e in kernels) / reps:.0f} kernels per case")
    for e in kernels[:12]:
        ms = e.self_device_time_total / 1e3 / reps
        print(f"  {ms:8.4f} ms {100 * ms / busy_ms:5.1f}%  x{e.count / reps:g}"
              f"  {e.key[:90]}")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from stroke_prediction_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.library()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s "
          f"({_build.library_path().name})")
    log = _build.library_path().with_suffix(".log")
    if log.exists():
        print(log.read_text().strip())

    k1, k5 = kernel_phase(torch)
    train_k, s_err = train_kernel_phase(torch)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        t_launches, case_ms = slice_phase(torch, work)
        launches, step_ms, learner = train_phase(torch, work)
        step = step_vs_cpu(torch, learner)

    def per_step(key, dtype="bfloat16"):
        """Sums over the layers whose route runs ``key`` in one step."""
        runs = {"K1": ("dw", "fused", "split"), "K2": ("fused",),
                "K3": ("split",), "K4": ("dw", "split")}[key]
        rows = [r for r in train_k[dtype] if r["route"] in runs]
        t_ops = sum(r["ops"][key] for r in rows) / PEAK_FLOPS[
            peak_key(key, dtype)]
        t_bytes = sum(r["bytes"][key] for r in rows) / PEAK_BYTES
        f64 = [r["f64"][key] for r in rows if key in r["f64"]]
        f64_dw = [r["f64"][key + " dW"] for r in rows
                  if key + " dW" in r["f64"]]
        return dict(
            {"max_rel_err_f64": max(f64)} if f64 else {},
            **({"max_rel_err_f64_dw": max(f64_dw)} if f64_dw else {}),
            max_abs_err=max(r["err"][key] for r in rows),
            max_abs_err_f32=max(r["err"][key] for r in train_k["float32"]
                                if key in r["err"]),
            ms=sum(r["ms"][key] for r in rows),
            plain_ms=sum(r["plain"][key] for r in rows),
            library_ms=sum(r["lib"][key] for r in rows),
            bound_ms=sum(r["bound"][key][0] for r in rows),
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            gflop=sum(r["ops"][key] for r in rows) / 1e9,
            layers=[r["layer"] for r in rows])

    for dtype in ("float32", "bfloat16"):
        print(f"per training step, {dtype}, summed over the layers each "
              f"kernel runs on (ms kernel / plain / cuDNN / bound; float32 "
              f"K1-K4 bound in 3xTF32): " +
              "; ".join(f"{key} {v['ms']:.4f} / {v['plain_ms']:.4f} / "
                        f"{v['library_ms']:.4f} / {v['bound_ms']:.4f} "
                        f"({v['bound_by']}, {v['gflop']:.2f} GFLOP, "
                        f"L{v['layers']})"
                        for key, v in ((key, per_step(key, dtype))
                                       for key in ("K1", "K2", "K3", "K4"))))
    csrc = "stroke_prediction_tpu_torch/ops/csrc/"
    s2d = "stroke_prediction_tpu/ops/pallas/s2d.py:"
    step_per = (f"one training step (bfloat16, batch {TRAIN_BATCH}, patch "
                f"68x104x104): the layers the route sends here")
    f32_step_per = (f"one float32 training step (batch {TRAIN_BATCH}, patch "
                    f"68x104x104): the layers the route sends here; "
                    f"bound_ms in 3xTF32")
    kernels = [
        dict({"name": "conv3x3_fwd", "route": "cuda",
              "source": csrc + "conv3x3_fwd_tc.cu", "replaces": s2d + "387",
              "launches": launches["conv3x3"]}, **per_step("K1"),
             source_float32=csrc + "conv3x3_fwd_f32_tc.cu",
             per=step_per + " (all 10)",
             tester={"launches": t_launches["conv3x3"], "ms": k1["ms"],
                     "plain_ms": k1["plain_ms"],
                     "library_ms": k1["library_ms"],
                     "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
                     "bound_ms_cuda_cores": k1["bound_ms_cuda_cores"],
                     "max_abs_err": k1["max_abs_err"],
                     "max_rel_err_f64": k1["max_rel_err_f64"],
                     "per": "one tester case (float32, batch 1; bound_ms "
                            "in 3xTF32)"}),
        dict({"name": "conv3x3_bwd_fused", "route": "cuda",
              "source": csrc + "conv3x3_bwd_tc.cu", "replaces": s2d + "491",
              "launches": launches["conv3x3_bwd_fused"]}, **per_step("K2"),
             source_float32=csrc + "conv3x3_bwd_f32_tc.cu", per=step_per,
             float32=dict(per_step("K2", "float32"), per=f32_step_per)),
        dict({"name": "conv3x3_bwd_dx", "route": "cuda",
              "source": csrc + "conv3x3_bwd_dx_tc.cu",
              "replaces": s2d + "589",
              "launches": launches["conv3x3_bwd_dx"]}, **per_step("K3"),
             source_float32=csrc + "conv3x3_bwd_dx_f32_tc.cu", per=step_per,
             float32=dict(per_step("K3", "float32"), per=f32_step_per)),
        dict({"name": "conv3x3_bwd_dw", "route": "cuda",
              "source": csrc + "conv3x3_bwd_dw_tc.cu",
              "replaces": s2d + "623",
              "launches": launches["conv3x3_bwd_dw"]}, **per_step("K4"),
             source_float32=csrc + "conv3x3_bwd_dw_f32_tc.cu", per=step_per,
             float32=dict(per_step("K4", "float32"), per=f32_step_per)),
        {"name": "edt_parabola", "route": "cuda",
         "source": csrc + "edt_parabola.cu",
         "replaces": "stroke_prediction_tpu/ops/edt.py:80",
         "launches": launches["edt_parabola"],
         "max_abs_err": k5["max_abs_err"],
         "ms": 8 * k5[(3584, 64)]["ms"],
         "plain_ms": 8 * k5[(3584, 64)]["plain_ms"],
         "bound_ms": 8 * k5[(3584, 64)]["bound_ms"],
         "bound_by": k5[(3584, 64)]["bound_by"], "library_ms": None,
         "per": "one validation step: 8 x one measured (3584, 64) pass",
         "tester": {"launches": t_launches["edt_parabola"],
                    "ms": 8 * k5[(3584, 128)]["ms"],
                    "plain_ms": 8 * k5[(3584, 128)]["plain_ms"],
                    "bound_ms": 8 * k5[(3584, 128)]["bound_ms"],
                    "per": "one tester case: 8 x one measured (3584, 128) "
                           "pass"}},
    ]
    for k in kernels:
        if k["launches"] < 1:
            raise AssertionError(f"{k['name']} never launched on the path")
    print(f"tester ms per case (card, after the first case): {case_ms:.2f}")
    print(f"training ms per step (card, bfloat16, mean of {TIMED_STEPS} "
          f"back to back, CUDA events): {step_ms:.3f}; card vs CPU float32 "
          f"step {step}; 's', 3 -> 4 and 192 -> 64 cases max|err| (and the "
          f"float32 K2, K3 and K4 vs f64, of max|ref|) {s_err}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
