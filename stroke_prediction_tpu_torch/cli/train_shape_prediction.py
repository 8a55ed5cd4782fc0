"""Phase-2 training: a new encoder predicts the shape-space latents from
the U-Net segmentations (port of cli/train_shape_prediction.py).  Loads the
phase-1 CAE (``caepath``, float32, frozen), builds a new ``Enc3D`` at
``--channelsenc`` in ``--dtype`` (with ``--initbycae`` its parameters and
BN statistics copied from the CAE's encoder) and trains it with
``CaePredictionLearner`` on the ``_unet_core`` / ``_unet_penu`` volumes
(hemisphere-flipped from case ``--hemisflipid`` on) against the labels:
Adam (1e-3, betas (0.9, 0.999), L2 1e-5) without the beta1 ramp, optional
MultiStepLR (``--lrsteps``); per step a random hemispheric flip and an
elastic deformation of the images and labels together.

    python -m stroke_prediction_tpu_torch.cli.train_shape_prediction \\
        CAE.model [--synthetic] [--fold ...] [--initbycae] \\
        [--channelsenc 1 16 24 32 100 200 1] [--dtype bfloat16|float32] \\
        [--device cuda|cpu] [--outbasepath BASE] [--inbasepath BASE]

Writes ``<BASE>_cae2.model`` (the frozen CAE), ``<BASE>_cae2_enc.model``
(the encoder) and ``<BASE>_cae2.{optim,json}`` on each new validation
optimum, ``<BASE>_cae2{,_enc}_final.model`` at the end and, where
matplotlib is installed, the PNGs.  ``--inbasepath`` resumes the encoder
from such a snapshot, written by either package; ``--initbycae`` follows
the resume, as in the JAX CLI.

Data parallel, each step the one-process step on the global batch (every
rank loads the phase-1 CAE; only rank 0 prints the set sizes and epoch
lines and writes files):

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
    LABEL_CORE, LABEL_LESION, LABEL_PENU, MOD_UNET_CORE, MOD_UNET_PENU)
from stroke_prediction_tpu_torch.data.loader import (
    get_stroke_prediction_training_data)
from stroke_prediction_tpu_torch.models.cae3d import Enc3D
from stroke_prediction_tpu_torch.models.factory import load_model
from stroke_prediction_tpu_torch.parallel import distributed
from stroke_prediction_tpu_torch.parallel.distributed import is_lead
from stroke_prediction_tpu_torch.train.cae_learners import (
    CaePredictionLearner)
from stroke_prediction_tpu_torch.train.optim import (
    make_optimizer, multistep_lr)
from stroke_prediction_tpu_torch.utils.args import (
    get_args_shape_prediction_training)


def train(args) -> Optional[CaePredictionLearner]:
    """Train; returns the learner, or None where ``--ndevices`` ran the
    ranks in processes of their own."""
    if spawned("stroke_prediction_tpu_torch.cli."
               "train_shape_prediction", args):
        return None
    learning_rate = 1e-3
    betas = (0.9, 0.999)

    mesh, device = make_mesh(args)
    cae, _ = load_model(args.caepath, device)
    gen = torch.Generator().manual_seed(args.seed)
    enc = Enc3D(tuple(args.channelsenc), args.globals, generator=gen,
                compute_dtype=getattr(torch, args.dtype)).to(device)
    optimizer = make_optimizer(enc.parameters(), learning_rate, betas=betas,
                               weight_decay=1e-5)
    sched = multistep_lr(learning_rate, args.lrsteps) if args.lrsteps else None

    dataset = make_dataset(args, [MOD_UNET_CORE, MOD_UNET_PENU],
                           [LABEL_CORE, LABEL_PENU, LABEL_LESION],
                           flip_split_id=args.hemisflipid)
    ds_train, ds_valid = get_stroke_prediction_training_data(
        dataset, args.fold, args.validsetsize, seed=args.seed,
        batchsize=args.batchsize, process_shard=args.distributed)
    if is_lead():
        print("Size training set:", len(ds_train.indices),
              "samples | Size validation set:",
              len(ds_valid.indices) if ds_valid else 0,
              "samples | Capacity batch:", args.batchsize, "samples")

    learner = CaePredictionLearner(
        ds_train, ds_valid, cae, enc, optimizer, sched,
        n_epochs=args.epochs, normalization_hours_penumbra=args.normalize,
        path_previous_base=args.inbasepath,
        path_outputs_base=args.outbasepath, seed=args.seed,
        distances_on_training=args.distances, profile_dir=args.profile,
        device=device, mesh=mesh)
    if args.initbycae:
        # the phase-1 encoder's parameters and BN statistics
        enc.encoder.load_state_dict(cae.enc.encoder.state_dict())
    learner.run_training()
    if mesh is not None:
        distributed.shutdown()
    return learner


if __name__ == "__main__":
    print(datetime.datetime.now())
    train(get_args_shape_prediction_training())
    print(datetime.datetime.now())
