"""One rank of the port's spatial CAE tests (test_torch_spatial_cae.py,
test_torch_spatial_cae_frozen.py): the CAE learners and ``LargeUnet3D``
with H sharded over the ranks.

    python tests/_torch_spatial_cae_worker.py HOST:PORT DATA SPACE RANK INPUTS OUTDIR

Imports torch and stroke_prediction_tpu_torch only (checked at the end: no
JAX in this process).  Joins a gloo group of DATA * SPACE ranks, builds the
``(DATA, SPACE)`` mesh and, on this rank's rows and block of H of the
global batch (``INPUTS``, an .npz the test wrote, as
_torch_cae_parallel_worker.py reads it; the masks and images each cut by
their own H), runs the float64 training steps that ``cases`` names:

* ``step/<case>``: the learner's ``train_step``, augmentation off;
* ``aug/<case>``: the same with its augmentation on (the learner's seeded
  generator: every rank draws what one process draws);
* ``pad/<case>``: control, the loss of one training-mode forward
  (augmentation off) with each rank's padded convs (the stride-2 convs'
  padding 1, the decoder's H padding 2) padding its own block: the rows of
  the other ranks inside the volume read as zeros;
* ``draws/<case>``: control, the loss of one training-mode forward after
  the augmentation, its noise drawn and blurred over this rank's block of
  H alone (the data-parallel draws);
* ``eval/<case>``: ``eval_step`` (HD / ASSD on);
* ``large``: one float64 step of ``LargeUnet3D`` through
  ``UnetSegmentationLearner.train_patches``.

Then, outside any process group's step, the one-process references that
``one/<rank>`` names (``<section>/<case>``), so that the ranks share that
work with the test's process.  Writes ``OUTDIR/rank<RANK>.npz`` and prints
``SPATIAL_WORKER_OK``.
"""

import os
import sys
import types

import numpy as np
import torch

from stroke_prediction_tpu_torch.data import augment
from stroke_prediction_tpu_torch.data.dataset import (
    KEY_GLOBAL, KEY_IMAGES, KEY_LABELS)
from stroke_prediction_tpu_torch.models.unet3d import LargeUnet3D
from stroke_prediction_tpu_torch.ops.warp import elastic_fields, elastic_noise
from stroke_prediction_tpu_torch.parallel import (
    collectives, distributed, spatial)
from stroke_prediction_tpu_torch.parallel.mesh import (
    batch_sharding, current, make_mesh, shard_batch)
from stroke_prediction_tpu_torch.train.optim import make_optimizer
from stroke_prediction_tpu_torch.train.unet_learner import (
    UnetSegmentationLearner)

import _torch_cae_parallel_worker as cae

F64 = torch.float64
LARGE_CHANNELS = (2, 3, 4, 5, 6, 5, 4, 3, 4, 2)
LARGE_X = (4, 92, 93, 92, 2)     # H 93: the first layers' blocks differ
LARGE_Y = (4, 4, 4, 4, 2)


def local_batch(inputs, kind, mesh):
    """This rank's rows and block of H of the global batch."""
    keys = {KEY_IMAGES: cae.IMAGES[kind], KEY_LABELS: "labels",
            KEY_GLOBAL: "clinical"}
    got = shard_batch(mesh, {k: None if v is None else inputs[v]
                             for k, v in keys.items()}, spatial=True)
    return {k: None if v is None else torch.from_numpy(
        np.ascontiguousarray(v)).to(F64) for k, v in got.items()}


def _block_padding(real):
    """``spatial.conv_rows`` with the classic fault of a padded conv: each
    rank pads its own block, so the halo rows of its neighbours inside the
    volume read as zeros."""
    def conv_rows(x, h_in, stride=1, pad=0):
        got, h_out = real(x, h_in, stride, pad)
        if not pad:
            return got, h_out
        lo, _ = spatial.own_block(h_out)
        o_lo, o_hi = spatial.own_block(h_in)
        rows = stride * lo - pad + torch.arange(got.shape[2])
        keep = ((rows >= o_lo) & (rows < o_hi)) | (rows < 0) | (rows >= h_in)
        return got * keep.to(got.dtype).reshape(1, 1, -1, 1, 1), h_out
    return conv_rows


def _local_draws(generator, labels):
    """The data-parallel draws: noise of this rank's block of H."""
    sharding = current()
    n = sharding.global_size(labels.shape[0])
    flip = augment.random_flip_mask(generator, n)
    noise = elastic_noise(generator, n, tuple(labels.shape[1:4]),
                          labels.dtype)
    fields = torch.stack([elastic_fields(x) for x in sharding.take(noise)])
    return sharding.take(flip), fields


def run(section, case, inputs, mesh):
    """{metric/<k>, grad/<name>, stat/<name>, count/<k>} of one ``section``
    run of ``case`` on this rank's part (the whole batch without a
    mesh)."""
    if case == "large":
        return large_step(inputs, mesh)
    kind, factor = cae.CASES[case]
    learner = cae.make_learner(kind, inputs, mesh)
    if section in ("step", "pad", "eval"):
        learner.augment = lambda batch: batch
    batch = local_batch(inputs, kind, mesh)
    patches = []
    if section == "pad":
        patches.append((spatial, "conv_rows",
                        _block_padding(spatial.conv_rows)))
    if section == "draws":
        patches.append((augment, "_cae_draws", _local_draws))
    saved = [(m, n, getattr(m, n)) for m, n, _ in patches]
    collectives.reset_exchange_counts()
    try:
        for m, n, f in patches:
            setattr(m, n, f)
        with batch_sharding(mesh, spatial=True).active():
            if section == "eval":
                metrics = learner.eval_step(batch, factor)
            elif section in ("pad", "draws"):
                learner._model.train()
                with torch.no_grad():
                    loss, _ = learner.forward_loss(learner.augment(batch),
                                                   factor)
                return {"metric/loss": loss.numpy()}
            else:
                metrics = learner.train_step(batch, factor)
    finally:
        for m, n, f in saved:
            setattr(m, n, f)
    model = learner._model
    out = {f"metric/{k}": v.double().numpy() for k, v in metrics.items()}
    out.update({f"count/{k}": np.int64(v)
                for k, v in collectives.EXCHANGE_COUNTS.items()})
    if section != "eval":
        out.update({f"grad/{k}": p.grad.numpy()
                    for k, p in model.named_parameters()
                    if p.grad is not None})
    out.update({f"stat/{k}": b.numpy() for k, b in model.named_buffers()})
    return out


def large_step(inputs, mesh):
    """One float64 ``LargeUnet3D`` step on this rank's part of
    ``large_x`` / ``large_y``."""
    model = LargeUnet3D(LARGE_CHANNELS, compute_dtype=F64)
    model.load_state_dict({k[len("large/"):]: torch.from_numpy(inputs[k])
                           for k in inputs.files if k.startswith("large/")})
    model.double()
    learner = UnetSegmentationLearner(
        types.SimpleNamespace(batch_size=LARGE_X[0]), None, model,
        make_optimizer(model.parameters(), 1e-3, betas=(0.99, 0.999),
                       weight_decay=1e-5), None, 1,
        patch_whd=LARGE_X[1:4][::-1], pad_xyz=(44, 44, 44), device="cpu",
        mesh=mesh)
    part = shard_batch(mesh, {"x": inputs["large_x"], "y": inputs["large_y"]},
                       spatial=True)
    collectives.reset_exchange_counts()
    with batch_sharding(mesh, spatial=True).active():
        metrics = learner.train_patches(
            *(torch.from_numpy(np.ascontiguousarray(part[k])) for k in "xy"))
    out = {f"metric/{k}": v.double().numpy() for k, v in metrics.items()}
    out.update({f"count/{k}": np.int64(v)
                for k, v in collectives.EXCHANGE_COUNTS.items()})
    out.update({f"grad/{k}": p.grad.numpy()
                for k, p in model.named_parameters()})
    out.update({f"stat/{k}": b.numpy() for k, b in model.named_buffers()})
    return out


def main():
    coordinator, data, space, rank, inputs_path, outdir = sys.argv[1:7]
    data, space, rank = int(data), int(space), int(rank)
    torch.set_num_threads(1)
    distributed.initialize(coordinator, data * space, rank, device="cpu")
    mesh = make_mesh(data, space)
    inputs = np.load(inputs_path)
    out = {"rank": np.int64(mesh.rank)}
    for entry in inputs["cases"]:
        section, case = str(entry).split("/")
        out.update({f"{entry}/{k}": v
                    for k, v in run(section, case, inputs, mesh).items()})
    distributed.shutdown()

    # the one-process references, outside any process group's step
    for entry in inputs[f"one/{mesh.rank}"]:
        section, case = str(entry).split("/")
        out.update({f"one/{entry}/{k}": v
                    for k, v in run(section, case, inputs, None).items()})

    jax_loaded = [m for m in sys.modules
                  if m in ("jax", "stroke_prediction_tpu")
                  or m.startswith(("jax.", "stroke_prediction_tpu."))]
    if jax_loaded:
        raise AssertionError(f"a rank imported {jax_loaded[:5]}")
    np.savez(os.path.join(outdir, f"rank{mesh.rank}.npz"), **out)
    print(f"SPATIAL_WORKER_OK rank={mesh.rank}", flush=True)


if __name__ == "__main__":
    main()
