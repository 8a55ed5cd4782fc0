"""Train the 3-D U-Net on core/penumbra segmentation (port of
cli/train_unet_segmentation.py): Adam(1e-3, L2 1e-5, betas (0.99, 0.999)),
optional MultiStepLR (``--lrsteps``), mean core + penumbra Dice loss, patch
pipeline resample -> fixed flip -> pad(20^3) -> random patch (104, 104, 68),
batch size 6, validation Dice and HD/ASSD every epoch.

    python -m stroke_prediction_tpu_torch.cli.train_unet_segmentation \\
        <unetpath> [--synthetic] [--fold ...] [--dtype bfloat16|float32] \\
        [--device cuda|cpu] [--outbasepath BASE] [--inbasepath BASE]

Writes ``<BASE>_unet.{model,optim,json}`` on each new validation optimum,
``<BASE>_unet_final.model`` at the end and, where matplotlib is installed,
the PNGs.  ``--inbasepath`` resumes from such a snapshot, written by either
package.

Data parallel, each step the one-process step on the global batch (only
rank 0 writes files):

* ``--ndevices N``: N processes on this machine, one card each (``--device
  cpu``: N CPU processes over gloo), each caching the cases and running its
  rows of every batch whose size divides N, the whole of any other;
* ``--distributed --coordinator HOST:PORT --nprocs P --procid I``: this
  process is rank I of P, one card each, and loads only its share of each
  batch (a last batch that does not divide over P is dropped).
"""

import datetime
from typing import Optional

import torch

from stroke_prediction_tpu_torch.cli.common import (
    make_dataset, make_mesh, spawned)
from stroke_prediction_tpu_torch.data.dataset import (
    LABEL_CORE, LABEL_PENU, MOD_CBV, MOD_TTD)
from stroke_prediction_tpu_torch.data.loader import (
    get_stroke_shape_training_data)
from stroke_prediction_tpu_torch.models.unet3d import Unet3D
from stroke_prediction_tpu_torch.parallel import distributed
from stroke_prediction_tpu_torch.parallel.distributed import is_lead
from stroke_prediction_tpu_torch.train.optim import (
    make_optimizer, multistep_lr)
from stroke_prediction_tpu_torch.train.unet_learner import (
    UnetSegmentationLearner)
from stroke_prediction_tpu_torch.utils.args import get_args_unet_training


def train(args) -> Optional[UnetSegmentationLearner]:
    """Train; returns the learner, or None where ``--ndevices`` ran the
    ranks in processes of their own."""
    if spawned("stroke_prediction_tpu_torch.cli."
               "train_unet_segmentation", args):
        return None
    mesh, device = make_mesh(args)
    learning_rate = 1e-3
    betas = (0.99, 0.999)
    pad = tuple(args.padding)
    patch = (104, 104, 68)
    if args.synthetic and args.xyoriginal < 256:
        # small synthetic smoke geometry: patch = minimum valid-conv size
        patch = (44, 44, 44)

    unet = Unet3D(channels=tuple(args.channels),
                  generator=torch.Generator().manual_seed(args.seed),
                  compute_dtype=getattr(torch, args.dtype)).to(device)
    optimizer = make_optimizer(unet.parameters(), learning_rate, betas=betas,
                               weight_decay=1e-5)
    sched = multistep_lr(learning_rate, args.lrsteps) if args.lrsteps else None

    dataset = make_dataset(args, [MOD_CBV, MOD_TTD],
                           [LABEL_CORE, LABEL_PENU],
                           flip_split_id=args.hemisflipid, pad=pad)
    ds_train, ds_valid = get_stroke_shape_training_data(
        dataset, args.fold, args.validsetsize, seed=args.seed,
        batchsize=args.batchsize, process_shard=args.distributed)
    if is_lead():
        print("Size training set:", len(ds_train.indices),
              "samples | Size validation set:",
              len(ds_valid.indices) if ds_valid else 0,
              "samples | Capacity batch:", args.batchsize, "samples")
        print("# training batches:", len(ds_train),
              "| # validation batches:", len(ds_valid) if ds_valid else 0)

    learner = UnetSegmentationLearner(
        ds_train, ds_valid, unet, optimizer, sched, n_epochs=args.epochs,
        patch_whd=patch, pad_xyz=pad,
        path_previous_base=args.inbasepath,
        path_outputs_base=args.outbasepath, seed=args.seed,
        distances_on_training=args.distances, profile_dir=args.profile,
        device=device, mesh=mesh)
    learner.run_training()
    if mesh is not None:
        distributed.shutdown()
    return learner


if __name__ == "__main__":
    print(datetime.datetime.now())
    train(get_args_unet_training())
    print(datetime.datetime.now())
