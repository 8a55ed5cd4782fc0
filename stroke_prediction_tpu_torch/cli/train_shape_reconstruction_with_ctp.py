"""CTP-conditioned phase-1 CAE training (port of
cli/train_shape_reconstruction_with_ctp.py): ``Enc3DCtp`` encodes each mask
concatenated with the CBV and TTD images, cropped back from their padding,
so ``--channelscae``'s first entry (the entry conv's C_in) must be at least
3.  ``Dec3D`` at the same channels, Adam (1e-3, betas (0.99, 0.999), L2
1e-5) with the beta1 ramp, optional MultiStepLR (``--lrsteps``), the
curriculum loss of ``CaeReconstructionLearner``; cases resampled, flipped
by case id past ``--hemisflipid``, the images padded by ``--padding``; per
step a random hemispheric flip of images and labels and an elastic
deformation of the labels.

    python -m stroke_prediction_tpu_torch.cli.train_shape_reconstruction_with_ctp \\
        [--synthetic] [--fold ...] [--channelscae 3 16 24 32 100 200 1] \\
        [--dtype bfloat16|float32] [--device cuda|cpu] \\
        [--outbasepath BASE] [--inbasepath BASE]

Writes ``<BASE>_cae1.{model,optim,json}`` (header kind ``cae3d_ctp`` with
its padding) on each new validation optimum, ``<BASE>_cae1_final.model`` at
the end and, where matplotlib is installed, the PNGs.  ``--inbasepath``
resumes from such a snapshot, written by either package.

Data parallel, each step the one-process step on the global batch (only
rank 0 prints the set sizes and epoch lines and writes files):

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
    LABEL_CORE, LABEL_LESION, LABEL_PENU, MOD_CBV, MOD_TTD)
from stroke_prediction_tpu_torch.data.loader import (
    get_stroke_shape_training_data)
from stroke_prediction_tpu_torch.models.cae3d import (
    Cae3DCtp, Dec3D, Enc3DCtp)
from stroke_prediction_tpu_torch.parallel import distributed
from stroke_prediction_tpu_torch.parallel.distributed import is_lead
from stroke_prediction_tpu_torch.train.cae_learners import (
    CaeReconstructionLearner)
from stroke_prediction_tpu_torch.train.optim import (
    make_optimizer, multistep_lr)
from stroke_prediction_tpu_torch.utils.args import get_args_shape_training


def train(args) -> Optional[CaeReconstructionLearner]:
    """Train; returns the learner, or None where ``--ndevices`` ran the
    ranks in processes of their own."""
    if spawned("stroke_prediction_tpu_torch.cli."
               "train_shape_reconstruction_with_ctp", args):
        return None
    learning_rate = 1e-3
    betas = (0.99, 0.999)
    pad = tuple(args.padding)

    mesh, device = make_mesh(args)
    gen = torch.Generator().manual_seed(args.seed)
    dtype = getattr(torch, args.dtype)
    channels = tuple(args.channelscae)
    cae = Cae3DCtp(enc=Enc3DCtp(channels, args.globals, padding=pad,
                                generator=gen, compute_dtype=dtype),
                   dec=Dec3D(channels, args.globals, generator=gen,
                             compute_dtype=dtype)).to(device)
    optimizer = make_optimizer(cae.parameters(), learning_rate, betas=betas,
                               weight_decay=1e-5)
    sched = multistep_lr(learning_rate, args.lrsteps) if args.lrsteps else None

    dataset = make_dataset(args, [MOD_CBV, MOD_TTD],
                           [LABEL_CORE, LABEL_PENU, LABEL_LESION],
                           flip_split_id=args.hemisflipid, pad=pad)
    ds_train, ds_valid = get_stroke_shape_training_data(
        dataset, args.fold, args.validsetsize, seed=args.seed,
        batchsize=args.batchsize, process_shard=args.distributed)
    if is_lead():
        print("Size training set:", len(ds_train.indices),
              "samples | Size validation set:",
              len(ds_valid.indices) if ds_valid else 0,
              "samples | Capacity batch:", args.batchsize, "samples")

    learner = CaeReconstructionLearner(
        ds_train, ds_valid, cae, optimizer, sched, n_epochs=args.epochs,
        normalization_hours_penumbra=args.normalize,
        inputs_from_images=True,        # the padded CBV / TTD
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
    train(get_args_shape_training())
    print(datetime.datetime.now())
