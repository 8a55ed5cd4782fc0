"""Time and accuracy of the bfloat16 K4 (``conv3x3_bwd_dw``: dW + db
alone) at the layers that take it in a U-Net and a CAE training step, with
its plan's chunk count:

    python -m stroke_prediction_tpu_torch.bench.conv_bwd_dw [--reps N]
        [--label NAME]

The U-Net's entry conv (dW only) and split layers at batch 6, patch 104 x
104 x 68, channels 2 16 32 64 32 16 32 2 (LeakyReLU 0.01); the CAE's entry
conv and split layers at batch 4, 28 x 128 x 128 masks, channels 1 16 24
32 100 200 1 (ELU; the encoder's z-SAME convs with a plane-table bias, the
decoder's (1, 2, 2)-padded ones with a vector).  Seeded random inputs; per
layer the mean of ``--reps`` calls between CUDA events after a warm-up,
and dk's largest error relative to max|dk| against the plain version
(cuDNN's float32 wgrad) and against float64, both from the same g' (as
the kernel forms it, rounded to bfloat16), beside the plain version's own
error against float64 (random signs make each dk a sum that cancels to
~1/sqrt(voxels) of its terms).
Prints the card's name and power limit, then one JSON line per layer and
one per network with the sum.  To compare two versions of the kernel, run
it with each checkout's package first on ``PYTHONPATH``, in one session on
one card.  Exits non-zero without a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

# (input D, H, W, C_in, C_out, mode, plane-table bias) of the layers whose
# backward runs K4 (bwd_route 'dw' or 'split')
UNET_PATCH, UNET_BATCH = (68, 104, 104), 6
UNET_CHANNELS = (2, 16, 32, 64, 32, 16, 32, 2)
CAE_LAYERS = (                # batch 4; encoder, then decoder
    (28, 128, 128, 1, 16, "s", True), (14, 62, 62, 24, 24, "s", True),
    (14, 60, 60, 24, 24, "s", True), (7, 29, 29, 32, 32, "s", True),
    (7, 27, 27, 32, 32, "s", True), (3, 12, 12, 100, 200, "v", False),
    (7, 29, 29, 32, 32, "s", False), (7, 31, 31, 32, 24, "s", False),
    (14, 62, 62, 24, 24, "s", False))
CAE_BATCH = 4


def unet_layers():
    """The U-Net's ten 3^3 convs on the patch, those that take K4."""
    from stroke_prediction_tpu_torch.ops.conv3x3 import bwd_route

    c_in, b1, b2, b3, b4, b5, _, _ = UNET_CHANNELS
    shapes = []

    def block(s, ci, co):
        shapes.append((*s, ci, co))
        s = tuple(v - 2 for v in s)
        shapes.append((*s, co, co))
        return tuple(v - 2 for v in s)

    r1 = block(UNET_PATCH, c_in, b1)
    r2 = block(tuple(v // 2 for v in r1), b1, b2)
    r3 = block(tuple(v // 2 for v in r2), b2, b3)
    r4 = block(tuple(2 * v for v in r3), b3 + b2, b4)
    block(tuple(2 * v for v in r4), b4 + b1, b5)
    return [(*s, "v", False) for i, s in enumerate(shapes)
            if bwd_route(s[3], s[4], i > 0) in ("dw", "split")]


def main(argv=None) -> int:
    import torch

    from stroke_prediction_tpu_torch.ops.conv3x3 import (
        MODES, _masked_cotangent, _ncdhw, _plan, conv3x3_bwd_dw,
        conv3x3_bwd_dw_plain)

    parser = argparse.ArgumentParser()
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--label", type=str, default="")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("conv_bwd_dw: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def uniform(shape):
        return (torch.rand(shape, generator=gen, device=dev) * 2 - 1).to(
            torch.bfloat16)

    for net, batch, act, alpha, layers in (
            ("unet", UNET_BATCH, "leaky_relu", 0.01, unet_layers()),
            ("cae", CAE_BATCH, "elu", 1.0, CAE_LAYERS)):
        total = 0.0
        for d, h, w, ci, co, mode, table in layers:
            x = uniform((batch, d, h, w, ci))
            d_out = d if mode == "s" else d - 2
            g = uniform((batch, d_out, h - 2, w - 2, co))
            y = uniform(g.shape)
            run = lambda: conv3x3_bwd_dw(  # noqa: E731
                x, g, y, act, alpha, mode, table)
            run()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(args.reps):
                run()
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / args.reps
            total += ms
            chunks = _plan(False, "bf16", tuple(x.shape), co, mode)[1]
            dk = run()[0].double()
            plain = conv3x3_bwd_dw_plain(x, g, y, act, alpha, mode,
                                         table)[0].double()
            gp = _masked_cotangent(g, y, act, alpha).double()
            dk64 = torch.nn.grad.conv3d_weight(
                _ncdhw(x.double()), (co, ci, 3, 3, 3), _ncdhw(gp),
                padding=(MODES[mode], 0, 0)).permute(2, 3, 4, 1, 0)
            scale = float(dk64.abs().max())

            def err(a, b):
                return float((a - b).abs().max()) / scale

            print(json.dumps({"label": args.label, "net": net,
                              "x": list(x.shape), "c_out": co, "mode": mode,
                              "table": table, "chunks": chunks, "ms": ms,
                              "err_vs_plain": err(dk, plain),
                              "err_vs_f64": err(dk, dk64),
                              "plain_err_vs_f64": err(plain, dk64)}))
        print(json.dumps({"label": args.label, "net": net, "layers":
                          len(layers), "sum_ms": total}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
