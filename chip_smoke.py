#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / CUDA port (stroke_prediction_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and exits
non-zero without one.  Phases:

1. card name and power limit (nvidia-smi), torch / CUDA versions, kernel
   build (nvcc, from ops/csrc in this checkout) and its seconds;
2. kernel phase: each hand-written kernel against its plain PyTorch version
   on the card at the shapes the tester gives it (K1: the ten U-Net 3^3
   convs at the full reference width on a 68x168x168 volume, plus one
   z-SAME / ELU / plane-table case; K5: the tester's (28*128, 128) pass and
   an n = 168 pass), with kernel, plain and library times (CUDA events) and
   the least time the card could take (bound);
3. slice phase: the port's full-volume U-Net tester CLI on three synthetic
   256x256x28 cases (resampled to 128x128x28, padded by 20 to 68x168x168),
   channels 2 16 32 64 32 16 32 2 with seeded random weights and BN
   statistics; the launch counts of both kernels in that run; finite
   outputs; one case re-run on the CPU (plain versions) and compared; a
   torch.profiler trace of three more cases: device time by kernel and
   the device's busy share.

Prints a ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
line.  Any failure raises and exits non-zero.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

CHANNELS = (2, 16, 32, 64, 32, 16, 32, 2)
VOLUME_DHW = (68, 168, 168)          # 28 x 128 x 128 resampled, padded 20
FOLD = (0, 1, 2)
K1_TOL = dict(atol=1e-4, rtol=1e-4)  # sums of up to 27 * 96 terms, reordered
SLICE_ATOL = 1e-4                    # card vs CPU probabilities

# H100 SXM data-sheet peaks (dense): float32 outside the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def bound_ms(ops, nbytes):
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


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
              max_abs_err=0.0, ops=0.0, bytes=0.0)
    print("K1 conv3x3_fwd per layer (batch 1, float32, 'v', LeakyReLU 0.01):")
    for i, (d, h, w, ci, co) in enumerate(
            unet_conv_shapes(VOLUME_DHW, CHANNELS), 1):
        x = uniform((1, d, h, w, ci), -1.0, 1.0)
        bnd = (27 * ci) ** -0.5
        k = uniform((3, 3, 3, ci, co), -bnd, bnd)
        b = uniform((co,), -bnd, bnd)
        y = conv3x3(x, k, b, "leaky_relu", 0.01)
        ref = conv3x3_plain(x, k, b, "leaky_relu", 0.01)
        torch.cuda.synchronize()
        err = float((y - ref).abs().max())
        torch.testing.assert_close(y, ref, **K1_TOL)
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
        bms, by = bound_ms(ops, nbytes)
        print(f"  L{i:<2} in {d}x{h}x{w} {ci:>2}->{co:<2} {ops / 1e9:6.2f} "
              f"GFLOP  kernel {ms:.4f} ms  plain {plain:.4f} ms  cuDNN "
              f"{lib:.4f} ms  bound {bms:.4f} ms ({by})  "
              f"max|err| {err:.3e}")
        for key, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                       ("bound_ms", bms), ("ops", ops), ("bytes", nbytes)):
            k1[key] += v
        k1["max_abs_err"] = max(k1["max_abs_err"], err)
        del x, k, b, y, ref, x_lib, w_lib
    k1["bound_by"] = bound_ms(k1["ops"], k1["bytes"])[1]
    print(f"  sum of the 10 layers: {k1['ops'] / 1e9:.2f} GFLOP  kernel "
          f"{k1['ms']:.4f} ms  plain {k1['plain_ms']:.4f} ms  cuDNN "
          f"{k1['library_ms']:.4f} ms  bound {k1['bound_ms']:.4f} ms")

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

    # K5: exact against the plain version; some lines without a site
    k5 = {}
    for n_lines, n in ((28 * 128, 128), (68 * 168, 168)):
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
        k5.setdefault("first", dict(ms=ms, plain_ms=plain, bound_ms=bms,
                                    bound_by=by))
        k5["max_abs_err"] = max(k5.get("max_abs_err", 0.0), err)
    print("K5 has no single PyTorch library call that computes it "
          "(library_ms null)")
    return k1, dict(k5["first"], max_abs_err=k5["max_abs_err"])


def slice_phase(torch, work):
    from stroke_prediction_tpu_torch.cli import test_unet_segmentation as cli
    from stroke_prediction_tpu_torch.eval.unet_tester import (
        UnetSegmentationTester)
    from stroke_prediction_tpu_torch.models.convert import save_unet_checkpoint
    from stroke_prediction_tpu_torch.models.unet3d import Unet3D
    from stroke_prediction_tpu_torch.ops.conv3x3 import conv3x3
    from stroke_prediction_tpu_torch.ops.edt import edt_parabola
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

    conv3x3.launches = 0
    edt_parabola.launches = 0
    t0 = time.perf_counter()
    tester = cli.test(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"conv3x3": conv3x3.launches, "edt_parabola": edt_parabola.launches}
    print(f"slice: tester CLI on {len(FOLD)} cases in {wall:.2f} s; "
          f"launches {launches}")
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
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        launches, case_ms = slice_phase(torch, work)

    kernels = [
        {"name": "conv3x3_fwd", "route": "cuda",
         "source": "stroke_prediction_tpu_torch/ops/csrc/conv3x3_fwd.cu",
         "replaces": "stroke_prediction_tpu/ops/pallas/s2d.py:387",
         "launches": launches["conv3x3"], "max_abs_err": k1["max_abs_err"],
         "ms": k1["ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
         "library_ms": k1["library_ms"],
         "per": "one tester case: the 10 U-Net convs"},
        {"name": "edt_parabola", "route": "cuda",
         "source": "stroke_prediction_tpu_torch/ops/csrc/edt_parabola.cu",
         "replaces": "stroke_prediction_tpu/ops/edt.py:80",
         "launches": launches["edt_parabola"],
         "max_abs_err": k5["max_abs_err"],
         "ms": 8 * k5["ms"], "plain_ms": 8 * k5["plain_ms"],
         "bound_ms": 8 * k5["bound_ms"], "bound_by": k5["bound_by"],
         "library_ms": None,
         "per": "one tester case: 8 x one measured (3584, 128) pass"},
    ]
    for k in kernels:
        if k["launches"] < 1:
            raise AssertionError(f"{k['name']} never launched on the path")
    print(f"tester ms per case (card, after the first case): {case_ms:.2f}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
