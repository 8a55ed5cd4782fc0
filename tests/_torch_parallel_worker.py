"""One rank of the port's 2-process data-parallel CPU test
(test_torch_parallel.py).

    python tests/_torch_parallel_worker.py HOST:PORT WORLD RANK INPUTS OUTDIR

Imports torch and stroke_prediction_tpu_torch only (checked at the end: no
JAX in this process).  Joins a gloo process group, then on the inputs that
the test wrote (``INPUTS``, an .npz):

* ``step``: one float64 U-Net training step of ``UnetSegmentationLearner``
  on this rank's rows of a 4-row global batch (sharded): the loss, every
  parameter gradient after the all-reduce, the running statistics and the
  metrics (HD / ASSD included);
* ``control``: the same step with BN's moments left per rank (no
  reduction), which the test requires to fail;
* ``replicated``: the step on a 3-row batch, which does not divide over
  two ranks and so runs whole on each;
* ``dice``: the Dice loss of this rank's rows under a sharded step;
* ``measures``: ``binary_measures`` of this rank's rows, HD / ASSD
  included, under a sharded step, of blobs and of an empty result;
* ``learner``: two epochs of ``run_training`` on tiny synthetic cases with
  this rank's own output base, so that the test sees which ranks wrote,
  and its ``StepTimer``'s count of volumes and chips.

Writes ``OUTDIR/rank<RANK>.npz`` and prints ``PARALLEL_WORKER_OK``.
"""

import os
import sys
import types

import numpy as np
import torch

from stroke_prediction_tpu_torch.data import dataset as ds
from stroke_prediction_tpu_torch.data.loader import (
    get_stroke_shape_training_data)
from stroke_prediction_tpu_torch.eval.metrics import (
    batch_dice_loss, binary_measures)
from stroke_prediction_tpu_torch.models import layers
from stroke_prediction_tpu_torch.models.unet3d import Unet3D
from stroke_prediction_tpu_torch.parallel import distributed
from stroke_prediction_tpu_torch.parallel.mesh import (
    batch_sharding, make_data_mesh, row_sharding)
from stroke_prediction_tpu_torch.train.optim import make_optimizer
from stroke_prediction_tpu_torch.train.unet_learner import (
    UnetSegmentationLearner)

CHANNELS = (2, 4, 6, 8, 6, 4, 6, 2)
PATCH, PAD = (44, 44, 44), (20, 20, 20)
MEASURES = ("dc", "hd", "assd", "precision", "sensitivity", "specificity")


def unet_learner(inputs, mesh):
    """A float64 learner at ``inputs``' weights (``state/<key>``)."""
    model = Unet3D(CHANNELS, compute_dtype=torch.float64)
    model.load_state_dict({k[len("state/"):]: torch.from_numpy(inputs[k])
                           for k in inputs.files if k.startswith("state/")})
    model.to(torch.float64)
    optimizer = make_optimizer(model.parameters(), 1e-3, betas=(0.99, 0.999),
                               weight_decay=1e-5)
    return UnetSegmentationLearner(
        types.SimpleNamespace(batch_size=4), None, model, optimizer, None, 1,
        patch_whd=PATCH, pad_xyz=PAD, distances_on_training=True,
        device="cpu", mesh=mesh)


def step(inputs, mesh, images, labels):
    """{loss, grad/<name>, stat/<name>, metric/<key>} of one step."""
    learner = unet_learner(inputs, mesh)
    images, labels = inputs[images], inputs[labels]
    sharding = row_sharding(mesh, len(images))
    with sharding.active():
        metrics = learner.train_patches(
            torch.from_numpy(sharding.take(images)).contiguous(),
            torch.from_numpy(sharding.take(labels)).contiguous())
    model = learner._model
    out = {f"metric/{k}": v.double().numpy() for k, v in metrics.items()}
    out.update({f"grad/{k}": p.grad.numpy()
                for k, p in model.named_parameters()})
    out.update({f"stat/{k}": b.numpy() for k, b in model.named_buffers()})
    return out


def learner_run(mesh, base):
    """Two training epochs on four tiny synthetic cases (two train, two
    validate, batch 2, so every step sharded), files written under
    ``base``."""
    provider = ds.SyntheticCaseProvider(n_cases=4, shape_xyz=(24, 24, 24),
                                        seed=4)
    dataset = ds.StrokeDataset3D(provider, [ds.MOD_CBV, ds.MOD_TTD],
                                 [ds.LABEL_CORE, ds.LABEL_PENU], pad=PAD)
    train, valid = get_stroke_shape_training_data(dataset, range(4), 0.5,
                                                  seed=4, batchsize=2)
    model = Unet3D(CHANNELS, generator=torch.Generator().manual_seed(4))
    optimizer = make_optimizer(model.parameters(), 1e-3)
    learner = UnetSegmentationLearner(
        train, valid, model, optimizer, None, 2, patch_whd=PATCH,
        pad_xyz=PAD, path_outputs_base=base, log_throughput=True,
        device="cpu", mesh=mesh)
    learner.run_training()
    return learner


def main():
    coordinator, world, rank, inputs_path, outdir = sys.argv[1:6]
    torch.set_num_threads(1)
    distributed.initialize(coordinator, int(world), int(rank), device="cpu")
    mesh = make_data_mesh()
    inputs = np.load(inputs_path)
    out = {"rank": np.int64(mesh.rank)}

    out.update({f"step/{k}": v for k, v in
                step(inputs, mesh, "images", "labels").items()})
    reduce_sums = layers.reduce_sums
    layers.reduce_sums = lambda *xs: xs          # per-rank BN moments
    try:
        out.update({f"control/{k}": v for k, v in
                    step(inputs, mesh, "images", "labels").items()})
    finally:
        layers.reduce_sums = reduce_sums
    out.update({f"replicated/{k}": v for k, v in
                step(inputs, mesh, "images_odd", "labels_odd").items()})

    sharding = batch_sharding(mesh)

    def local(key):
        return torch.from_numpy(sharding.take(inputs[key]))

    with sharding.active():
        out["dice"] = batch_dice_loss(local("dice_o"),
                                      local("dice_t")).numpy()
        for case in ("blobs", "empty"):
            m = binary_measures(local(f"measures_{case}_r"),
                                local(f"measures_{case}_t"))
            out.update({f"measures_{case}/{f}": getattr(m, f).numpy()
                        for f in MEASURES})

    base_dir = os.path.join(outdir, f"files{mesh.rank}")
    os.makedirs(base_dir)
    learner = learner_run(mesh, os.path.join(base_dir, "unet"))
    out["learner_loss"] = np.float64(
        learner._metric_dtos["training"][-1]["loss"])
    # the second pass timed (the first is warm-up): its volumes, its chips
    out["timer"] = np.array([learner._timer._volumes,
                             learner._timer._n_chips])
    distributed.shutdown()

    jax_loaded = [m for m in sys.modules
                  if m in ("jax", "stroke_prediction_tpu")
                  or m.startswith(("jax.", "stroke_prediction_tpu."))]
    if jax_loaded:
        raise AssertionError(f"a rank imported {jax_loaded[:5]}")
    np.savez(os.path.join(outdir, f"rank{mesh.rank}.npz"), **out)
    print(f"PARALLEL_WORKER_OK rank={mesh.rank}", flush=True)


if __name__ == "__main__":
    main()
