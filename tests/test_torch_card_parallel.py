"""Data-parallel training across cards (marker ``card``: needs two or more
CUDA cards, and skips without them).  Imports no JAX, and runs with
``--noconftest`` (tests/conftest.py sets up JAX):

    python -m pytest --noconftest -m card tests/test_torch_card_parallel.py

The U-Net and the phase-1 CAE training CLIs with ``--ndevices N``, N the
machine's cards (one process each, NCCL), against the same CLI in one
process: float32 at the reference width (and the U-Net's patch), a global
batch of 8 (8 / N rows a rank), two epochs.  The
losses agree to 1e-4 relative (float32 sums over other rows in another
order).  The weights are held by their update, final less initial: the
two runs' updates differ by at most 1e-2 of the update's norm over all
parameters.  Element by element they cannot be held tight: Adam's first
steps move a weight by about lr whatever its gradient's size, so an
element whose gradient is near zero can move either way in the two runs
(one element of 6912 was 1.1e-4 apart on four H100s), while a missing or
per-rank reduction changes the update throughout (the criterion of the
JAX package's tests/test_parallel.py).

The ``space`` axis across two cards: one float32 U-Net training step
(reference width, batch 2, patch 68x104x104) at ``{data: 1, space: 2}``,
each card holding its block of H and the row exchanges going over NCCL,
against the same step in one process under the data-parallel rule: the
loss and each layer's gradients no further from a float64 one-process
step (the plain versions of the kernels) than twice the float32
one-process step's distance plus 1e-4 (a dropped exchange adjoint or
reduction moves a layer's gradients by about their size).  The same for
one float32 phase-1 CAE step (reference width, batch 2, 28x128x128 masks,
the latent L1 term off, augmentation off): its stride-2, padded and
transposed convs, global means (the hinges) and BN fetch their rows and
sum over NCCL.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import types

import numpy as np
import pytest
import torch

from stroke_prediction_tpu_torch.cli.common import free_port
from stroke_prediction_tpu_torch.models.cae3d import Cae3D, Dec3D, Enc3D
from stroke_prediction_tpu_torch.models.convert import (
    state_to_jax, unet_state_to_jax)
from stroke_prediction_tpu_torch.models.unet3d import (
    Unet3D, unet_output_spatial)
from stroke_prediction_tpu_torch.parallel import distributed
from stroke_prediction_tpu_torch.parallel.mesh import (
    batch_sharding, make_mesh, shard_batch)
from stroke_prediction_tpu_torch.train.optim import make_optimizer
from stroke_prediction_tpu_torch.train.unet_learner import (
    UnetSegmentationLearner)
from stroke_prediction_tpu_torch.utils import checkpoint

pytestmark = pytest.mark.card

REPO = Path(__file__).resolve().parents[1]
RUN_TIMEOUT = 900          # seconds per CLI run
LOSS_REL, UPDATE_REL = 1e-4, 1e-2
CHANNELS, SEED = (2, 16, 32, 64, 32, 16, 32, 2), 4   # the CLI's defaults
COMMON = ["--synthetic", "--epochs", "2", "--batchsize", "8", "--fold",
          *map(str, range(10)), "--validsetsize", "0.2", "--dtype", "float32"]
ARGS = ["unused.model", *COMMON]
UNET = "stroke_prediction_tpu_torch.cli.train_unet_segmentation"
CAE = "stroke_prediction_tpu_torch.cli.train_shape_reconstruction"
CAE_CHANNELS = (1, 16, 24, 32, 100, 200, 1)         # the CLI's defaults
SPATIAL_PATCH, SPATIAL_BATCH = (68, 104, 104), 2
SPATIAL_FACTOR, SPATIAL_FLOOR = 2.0, 1e-4        # PERF.md's data-parallel rule
# the curriculum factor 0, as chip_smoke.py's CTP_VS_CPU_FACTOR: at 0.4 the
# latent L1 term's gradient, sign(z_interp - z_lesion), flips at latent
# elements near zero with the last bits of a float32 step, and on these
# random masks put the encoder's gradients 4.57e-3 of a layer's norm off
# float64 on two cards over NCCL and on two gloo ranks of one card alike
# (one process 1.83e-4; the float64 rank-step 2.5e-14 of one process)
CAE_SPATIAL_DHW, CAE_SPATIAL_FACTOR = (28, 128, 128), 0.0


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


def _train(tmp_path, name, extra, module=UNET, args=ARGS, stem="unet"):
    (tmp_path / name).mkdir()
    base = tmp_path / name / stem
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(REPO), TMPDIR=str(tmp_path))
    out = subprocess.run(
        [sys.executable, "-m", module, *args, "--outbasepath", str(base),
         *extra], env=env, cwd=tmp_path, capture_output=True, text=True,
        timeout=RUN_TIMEOUT)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
    return base, out.stdout


def _cards():
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        pytest.skip("needs two or more CUDA cards")
    return n


def _check(n, runs, outs, mark, start):
    """The two runs' epoch lines, files, losses and updates from the
    initial parameters ``start`` (a flax params tree)."""
    many, one = runs
    lines = re.findall(r"^Epoch \d+/2 (?:training|validate) loss: \S+",
                       outs[0], re.M)
    assert len(lines) == 4, outs[0][-2000:]
    assert sorted(p.name for p in many.parent.iterdir()) == sorted(
        p.name for p in one.parent.iterdir())
    got = checkpoint.load_curves(f"{many}{mark}.json")
    want = checkpoint.load_curves(f"{one}{mark}.json")
    for phase in ("training", "validate"):
        assert len(got[phase]) == len(want[phase]) >= 1
        for a, b in zip(got[phase], want[phase]):
            print(f"{phase} loss {a['loss']} / {b['loss']}")
            assert abs(a["loss"] - b["loss"]) <= LOSS_REL * b["loss"], phase
    updates = []
    for run in (many, one):
        final, _ = checkpoint.load_checkpoint(f"{run}{mark}_final.model")
        first = dict(_leaves(start))
        updates.append(np.concatenate([
            (leaf - first[path]).ravel()
            for path, leaf in _leaves(final["params"])]))
    ratio = np.linalg.norm(updates[0] - updates[1]) / np.linalg.norm(
        updates[1])
    print(f"{n} cards: update {np.linalg.norm(updates[1]):.4e}, relative "
          f"difference {ratio:.3e}, largest element "
          f"{np.abs(updates[0] - updates[1]).max():.3e}")
    assert ratio <= UPDATE_REL


def test_ndevices_on_the_cards_equals_one_process(tmp_path):
    n = _cards()
    many, out_many = _train(tmp_path, "many", ["--ndevices", str(n)])
    one, out_one = _train(tmp_path, "one", [])
    init = Unet3D(CHANNELS, generator=torch.Generator().manual_seed(SEED))
    _check(n, (many, one), (out_many, out_one), "_unet",
           unet_state_to_jax(init.state_dict())["params"])


def test_cae_ndevices_on_the_cards_equals_one_process(tmp_path):
    """The phase-1 CAE CLI (256 x 256 x 28 cases resampled to 128 x 128 x
    28, channels 1 16 24 32 100 200 1): its global losses, hinges and
    latent means included, and its gradients' average across the cards."""
    n = _cards()
    many, out_many = _train(tmp_path, "many", ["--ndevices", str(n)], CAE,
                            COMMON, "cae")
    one, out_one = _train(tmp_path, "one", [], CAE, COMMON, "cae")
    gen = torch.Generator().manual_seed(SEED)
    init = Cae3D(Enc3D(CAE_CHANNELS, generator=gen),
                 Dec3D(CAE_CHANNELS, generator=gen))
    start = state_to_jax(init.state_dict(), init.config)["params"]
    _check(n, (many, one), (out_many, out_one), "_cae1", start)



def _spatial_inputs():
    gen = torch.Generator().manual_seed(SEED)
    model = Unet3D(CHANNELS, generator=gen)
    images = torch.rand(SPATIAL_BATCH, *SPATIAL_PATCH, 2, generator=gen) * 4
    labels = (torch.rand(SPATIAL_BATCH, *unet_output_spatial(SPATIAL_PATCH),
                         2, generator=gen) > 0.5).float()
    return {"state": model.state_dict(), "images": images, "labels": labels}


def _spatial_step(inputs, mesh, device, dtype=torch.float32):
    """(loss, {name: gradient}) of one training step on this rank's block
    of H (the whole batch without a mesh); float64 with the plain versions
    of K1-K4."""
    from stroke_prediction_tpu_torch.ops import conv3x3 as cm

    model = Unet3D(CHANNELS, compute_dtype=dtype)
    model.load_state_dict(inputs["state"])
    model.to(device, dtype)
    learner = UnetSegmentationLearner(
        types.SimpleNamespace(batch_size=SPATIAL_BATCH), None, model,
        make_optimizer(model.parameters(), 1e-3), None, 1,
        patch_whd=SPATIAL_PATCH[::-1], device=device, mesh=mesh)
    local = shard_batch(mesh, {k: inputs[k] for k in ("images", "labels")},
                        spatial=True)
    names = ("conv3x3", "conv3x3_bwd_fused", "conv3x3_bwd_dx",
             "conv3x3_bwd_dw")
    real = {n: getattr(cm, n) for n in names}
    try:
        if dtype == torch.float64:
            for n in names:
                setattr(cm, n, getattr(cm, n + "_plain"))
        with batch_sharding(mesh, spatial=True).active():
            metrics = learner.train_patches(
                local["images"].contiguous().to(device, dtype),
                local["labels"].contiguous().to(device, dtype))
    finally:
        for n in names:
            setattr(cm, n, real[n])
    return float(metrics["loss"]), {k: p.grad.cpu().double()
                                    for k, p in model.named_parameters()}


def _spatial_rank(rank, coordinator, inputs_path, outdir):
    """Rank ``rank`` of the two-card spatial step: NCCL, cuda:rank."""
    distributed.initialize(coordinator, 2, rank)
    loss, grads = _spatial_step(torch.load(inputs_path), make_mesh(1, 2),
                                torch.device("cuda", rank))
    distributed.shutdown()
    torch.save({"loss": loss, "grads": grads},
               os.path.join(outdir, f"rank{rank}.pt"))


def _distance(step, ref):
    """(loss relative, the largest gradient distance of a layer relative
    to its norm) of ``step`` from ``ref``."""
    (loss, grads), (ref_loss, ref_grads) = step, ref
    layers = {}
    for k, g in ref_grads.items():
        layer = re.sub(r"\.(bn|conv)\..*$|\.(kernel|bias)$", "", k)
        d2, r2 = layers.get(layer, (0.0, 0.0))
        layers[layer] = (d2 + float(((grads[k] - g) ** 2).sum()),
                         r2 + float((g ** 2).sum()))
    return (abs(loss - ref_loss) / abs(ref_loss),
            max((d2 / r2) ** 0.5 for d2, r2 in layers.values()))


def test_space_axis_on_two_cards_equals_one_process(tmp_path):
    _cards()
    inputs = _spatial_inputs()
    path = tmp_path / "inputs.pt"
    torch.save(inputs, path)
    torch.multiprocessing.start_processes(
        _spatial_rank, args=(f"127.0.0.1:{free_port()}", str(path),
                             str(tmp_path)),
        nprocs=2, join=True, start_method="spawn")
    dev = torch.device("cuda", 0)
    f64 = _spatial_step(inputs, None, dev, torch.float64)
    one = _distance(_spatial_step(inputs, None, dev), f64)
    limit = [SPATIAL_FACTOR * d + SPATIAL_FLOOR for d in one]
    for rank in range(2):
        got = torch.load(tmp_path / f"rank{rank}.pt")
        dist = _distance((got["loss"], got["grads"]), f64)
        print(f"space axis, rank {rank}: (loss, worst layer) off float64 "
              f"{dist}, one process {one}, limits {limit}")
        assert dist[0] <= limit[0] and dist[1] <= limit[1]


def _cae_spatial_inputs():
    gen = torch.Generator().manual_seed(SEED)
    model = Cae3D(Enc3D(CAE_CHANNELS, generator=gen),
                  Dec3D(CAE_CHANNELS, generator=gen))
    labels = (torch.rand(SPATIAL_BATCH, *CAE_SPATIAL_DHW, 3, generator=gen)
              > 0.5).float()
    clinical = torch.rand(SPATIAL_BATCH, 5, generator=gen) * 4
    return {"state": model.state_dict(), "labels": labels,
            "clinical": clinical}


def _cae_spatial_step(inputs, mesh, device, dtype=torch.float32):
    """(loss, {name: gradient}) of one phase-1 CAE training step on this
    rank's block of H (the whole batch without a mesh); float64 with the
    plain versions of K1-K4."""
    from stroke_prediction_tpu_torch.ops import conv3x3 as cm
    from stroke_prediction_tpu_torch.train.cae_learners import (
        CaeReconstructionLearner)

    model = Cae3D(Enc3D(CAE_CHANNELS, compute_dtype=dtype),
                  Dec3D(CAE_CHANNELS, compute_dtype=dtype))
    model.load_state_dict(inputs["state"])
    model.to(device, dtype)
    learner = CaeReconstructionLearner(
        types.SimpleNamespace(batch_size=SPATIAL_BATCH), None, model,
        make_optimizer(model.parameters(), 1e-3), None, 1, device=device,
        mesh=mesh)
    learner.augment = lambda batch: batch
    local = shard_batch(mesh, {k: inputs[k] for k in ("labels", "clinical")},
                        spatial=True)
    names = ("conv3x3", "conv3x3_bwd_fused", "conv3x3_bwd_dx",
             "conv3x3_bwd_dw")
    real = {n: getattr(cm, n) for n in names}
    try:
        if dtype == torch.float64:
            for n in names:
                setattr(cm, n, getattr(cm, n + "_plain"))
        with batch_sharding(mesh, spatial=True).active():
            metrics = learner.train_step(
                {"images": None,
                 "labels": local["labels"].contiguous().to(device, dtype),
                 "clinical": local["clinical"].to(device, dtype)},
                CAE_SPATIAL_FACTOR)
    finally:
        for n in names:
            setattr(cm, n, real[n])
    return float(metrics["loss"]), {k: p.grad.cpu().double()
                                    for k, p in model.named_parameters()}


def _cae_spatial_rank(rank, coordinator, inputs_path, outdir):
    """Rank ``rank`` of the two-card spatial CAE step: NCCL, cuda:rank."""
    distributed.initialize(coordinator, 2, rank)
    loss, grads = _cae_spatial_step(torch.load(inputs_path), make_mesh(1, 2),
                                    torch.device("cuda", rank))
    distributed.shutdown()
    torch.save({"loss": loss, "grads": grads},
               os.path.join(outdir, f"rank{rank}.pt"))


def test_cae_space_axis_on_two_cards_equals_one_process(tmp_path):
    _cards()
    inputs = _cae_spatial_inputs()
    path = tmp_path / "inputs.pt"
    torch.save(inputs, path)
    torch.multiprocessing.start_processes(
        _cae_spatial_rank, args=(f"127.0.0.1:{free_port()}", str(path),
                                 str(tmp_path)),
        nprocs=2, join=True, start_method="spawn")
    dev = torch.device("cuda", 0)
    f64 = _cae_spatial_step(inputs, None, dev, torch.float64)
    one = _distance(_cae_spatial_step(inputs, None, dev), f64)
    limit = [SPATIAL_FACTOR * d + SPATIAL_FLOOR for d in one]
    for rank in range(2):
        got = torch.load(tmp_path / f"rank{rank}.pt")
        dist = _distance((got["loss"], got["grads"]), f64)
        print(f"cae space axis, rank {rank}: (loss, worst layer) off float64 "
              f"{dist}, one process {one}, limits {limit}")
        assert dist[0] <= limit[0] and dist[1] <= limit[1]
