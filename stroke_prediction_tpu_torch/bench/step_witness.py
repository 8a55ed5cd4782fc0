"""How far the float32 training steps that ``chip_smoke.py`` holds to a
float64 step lie from it, on the card and on the CPU, and whether the
card's CAE step repeats:

    python -m stroke_prediction_tpu_torch.bench.step_witness

Run from the root of a checkout (it uses ``chip_smoke.py``'s step sides
and inputs: the reference U-Net step and the seeded phase-1 CAE step at
batch 2).  Prints the card's name and power limit and the host's CPU, then:

* per step, each float32 side against the float64 CPU step (the largest
  three of |err| / max|ref| per gradient; the CAE's also per layer, as
  its check reads them): the card twice, the CPU at 1, 2 (the witnesses'
  pool) and 8 threads and with oneDNN off;
* the CAE's float32 card step run 4 times with cuDNN's deterministic
  algorithms (as the CAE learners' ``train_step``) and 4 times with any:
  how many gradients differ between the runs.

Exits non-zero without a CUDA card.
"""

from __future__ import annotations

import importlib.util
import os
import subprocess
import sys
import time

CPU_SIDES = (("CPU 1 thread", 1, True), ("CPU 2 threads", 2, True),
             ("CPU 8 threads", 8, True), ("CPU 2 threads, oneDNN off", 2,
                                          False))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.getcwd(), "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _learner(cli, args):
    """The CLI's learner for ``args``, its training not run."""
    from stroke_prediction_tpu_torch.train.learner import Learner

    run = Learner.run_training
    Learner.run_training = lambda self: None
    try:
        return cli.train(args)
    finally:
        Learner.run_training = run


def _sides(torch, side):
    """``side(name, device, dtype)`` on the card twice, on the CPU as
    CPU_SIDES say and in float64 -> {name: (loss, grads, stats, s)}."""
    out = {}
    for name, threads, onednn in CPU_SIDES:
        torch.set_num_threads(threads)
        with torch.backends.mkldnn.flags(enabled=onednn):
            out[name] = side(name, "cpu", torch.float32)
    torch.set_num_threads(8)
    out["CPU float64"] = side("CPU float64", "cpu", torch.float64)
    for name in ("card", "card, again"):
        out[name] = side(name, "cuda", torch.float32)
    return out


def _report(cs, what, out, layer_of=None):
    ref = out["CPU float64"][1]
    for name, (_, grads, _, secs) in out.items():
        if name == "CPU float64":
            continue
        errs = sorted(((cs.rel_err(grads[k], ref[k]), k) for k in ref),
                      reverse=True)[:3]
        line = (f"{what} {name} vs float64 ({secs:.1f} s): "
                + ", ".join(f"{k} {e:.3e}" for e, k in errs))
        if layer_of is not None:
            top = {}
            for k in ref:
                top.setdefault(layer_of(k), []).append(k)
            per = sorted(((float((grads[k] - ref[k]).abs().max())
                           / max(float(ref[j].abs().max()) for j in ks), k)
                          for ks in top.values() for k in ks),
                         reverse=True)[:3]
            line += "; of its layer's max: " + ", ".join(
                f"{k} {e:.3e}" for e, k in per)
        print(line, flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("step_witness: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    cs = _chip_smoke()
    print(f"host CPU {cs.host_cpu()}, {os.cpu_count()} cores, CPU kernels "
          f"{torch.backends.cpu.get_cpu_capability()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from stroke_prediction_tpu_torch.cli import (
        train_shape_reconstruction, train_unet_segmentation)
    from stroke_prediction_tpu_torch.data.augment import (
        crop_patch, random_offsets)
    from stroke_prediction_tpu_torch.data.dataset import (
        KEY_GLOBAL, KEY_IMAGES, KEY_LABELS)
    from stroke_prediction_tpu_torch.models.cae3d import Cae3D, Dec3D, Enc3D
    from stroke_prediction_tpu_torch.models.unet3d import Unet3D
    from stroke_prediction_tpu_torch.ops import _build
    from stroke_prediction_tpu_torch.ops.warp import elastic_noise
    from stroke_prediction_tpu_torch.utils.args import (
        get_args_shape_training, get_args_unet_training)

    _build.library()
    work = os.path.join("build", "step_witness")
    fold = [str(i) for i in cs.TRAIN_FOLD]

    # the U-Net step of chip_smoke.py::step_vs_cpu
    learner = _learner(train_unet_segmentation, get_args_unet_training(
        [os.path.join(work, "unused.model"), "--synthetic", "--fold", *fold,
         "--validsetsize", "0.25", "--batchsize", str(cs.TRAIN_BATCH),
         "--outbasepath", os.path.join(work, "unet"), "--device", "cuda",
         "--channels", *map(str, cs.CHANNELS)]))
    data, _ = learner.device_data(learner._dataloader_training)
    images, labels = data[KEY_IMAGES][:2].cpu(), data[KEY_LABELS][:2].cpu()
    offsets = random_offsets(torch.Generator().manual_seed(2), 2,
                             tuple(images.shape[1:4]), cs.PATCH_DHW[::-1])
    imgs, labs = crop_patch(images, labels, offsets, cs.PATCH_DHW[::-1],
                            (20, 20, 20))
    unet = Unet3D(cs.CHANNELS, generator=torch.Generator().manual_seed(3))
    stub = cs.learner_stub(learner)
    _report(cs, "U-Net step", _sides(torch, lambda name, dev, dt: (
        cs.unet_step_side(torch, unet, imgs, labs, stub, name, dev, dt))))

    # the seeded CAE step of chip_smoke.py::cae_steps_vs_cpu
    learner = _learner(train_shape_reconstruction, get_args_shape_training(
        ["--synthetic", "--fold", *fold, "--validsetsize", "0.25",
         "--batchsize", str(cs.CAE_TRAIN_BATCH), "--outbasepath",
         os.path.join(work, "cae")]))
    data, _ = learner.device_data(learner._dataloader_training)
    nb = cs.CAE_VS_CPU_BATCH
    args = (data[KEY_LABELS][:nb].cpu(), data[KEY_GLOBAL][:nb].cpu(),
            elastic_noise(torch.Generator().manual_seed(5), nb, cs.CAE_DHW),
            torch.tensor([True, False]), cs.learner_stub(learner))
    gen = torch.Generator().manual_seed(3)
    cae = Cae3D(Enc3D(cs.CAE_CHANNELS, generator=gen),
                Dec3D(cs.CAE_CHANNELS, generator=gen))

    def cae_side(name, dev, dt):
        return cs.cae_step_side(torch, cae, *args, name, dev, dt)

    _report(cs, "CAE step", _sides(torch, cae_side), cs.cae_layer_of)

    flags = torch.backends.cudnn.flags
    for label, any_algorithm in (("deterministic", False), ("any", True)):
        if any_algorithm:
            torch.backends.cudnn.flags = lambda *a, **kw: flags(
                *a, **dict(kw, deterministic=False))
        t0 = time.perf_counter()
        try:
            runs = [cae_side("card", "cuda", torch.float32)[1]
                    for _ in range(4)]
        finally:
            torch.backends.cudnn.flags = flags
        diff = {k: max(float((r[k] - runs[0][k]).abs().max())
                       for r in runs[1:]) for k in runs[0]}
        worst = max(diff, key=diff.get)
        print(f"CAE step on the card, 4 runs, cuDNN {label} algorithms "
              f"({time.perf_counter() - t0:.1f} s): "
              f"{sum(v > 0 for v in diff.values())} of {len(diff)} "
              f"gradients differ between runs, most {worst} "
              f"{diff[worst]:.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
