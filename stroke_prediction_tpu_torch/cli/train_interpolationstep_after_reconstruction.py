"""Step learning on a frozen phase-1 shape space (port of
cli/train_interpolationstep_after_reconstruction.py): load the phase-1 CAE
(``caepath``), build a fresh ``Cae3D(Enc3DStep, Dec3D)`` at
``--channelscae`` in ``--dtype``, freeze all but the clinical step head
(``reduce1``, ``reduce2``, ``step_head``), graft the CAE's encoder trunk and
decoder into it (parameters and BN statistics) and train the head with
``CaeStepLearner``: Adam (1e-3, betas (0.9, 0.999), L2 1e-5) over the head
with the beta1 ramp, optional MultiStepLR (``--lrsteps``); per step a
random hemispheric flip and an elastic deformation of the labels.  The
whole CAE runs in training mode, so the frozen parts' BN statistics move.

    python -m stroke_prediction_tpu_torch.cli.\\
train_interpolationstep_after_reconstruction CAE.model \\
        [--synthetic] [--fold ...] [--channelscae 1 16 24 32 100 200 1] \\
        [--dtype bfloat16|float32] [--device cuda|cpu] \\
        [--outbasepath BASE] [--inbasepath BASE]

Writes ``<BASE>_cae1step.{model,optim,json}`` on each new validation
optimum, ``<BASE>_cae1step_final.model`` at the end and, where matplotlib
is installed, the PNGs.  ``--inbasepath`` resumes from such a snapshot,
written by either package; the graft follows the resume, as in the JAX
CLI.

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
    LABEL_CORE, LABEL_LESION, LABEL_PENU, MOD_CBV, MOD_TTD)
from stroke_prediction_tpu_torch.data.loader import (
    get_stroke_shape_training_data)
from stroke_prediction_tpu_torch.models.cae3d import Cae3D, Dec3D, Enc3DStep
from stroke_prediction_tpu_torch.models.factory import load_model
from stroke_prediction_tpu_torch.parallel import distributed
from stroke_prediction_tpu_torch.parallel.distributed import is_lead
from stroke_prediction_tpu_torch.train.cae_learners import CaeStepLearner
from stroke_prediction_tpu_torch.train.optim import (
    make_optimizer, multistep_lr, trainable_by_path)
from stroke_prediction_tpu_torch.utils.args import get_args_step_training

STEP_HEAD = ("reduce1", "reduce2", "step_head")


def train(args) -> Optional[CaeStepLearner]:
    """Train; returns the learner, or None where ``--ndevices`` ran the
    ranks in processes of their own."""
    if spawned("stroke_prediction_tpu_torch.cli."
               "train_interpolationstep_after_reconstruction", args):
        return None
    learning_rate = 1e-3
    betas = (0.9, 0.999)

    mesh, device = make_mesh(args)
    cae_loaded, _ = load_model(args.caepath, device)
    gen = torch.Generator().manual_seed(args.seed)
    dtype = getattr(torch, args.dtype)
    channels = tuple(args.channelscae)
    cae = Cae3D(enc=Enc3DStep(channels, args.globals, generator=gen,
                              compute_dtype=dtype),
                dec=Dec3D(channels, args.globals, generator=gen,
                          compute_dtype=dtype)).to(device)

    dataset = make_dataset(args, [MOD_CBV, MOD_TTD],
                           [LABEL_CORE, LABEL_PENU, LABEL_LESION])
    ds_train, ds_valid = get_stroke_shape_training_data(
        dataset, args.fold, args.validsetsize, seed=args.seed,
        batchsize=args.batchsize, process_shard=args.distributed)
    if is_lead():
        print("Size training set:", len(ds_train.indices),
              "samples | Size validation set:",
              len(ds_valid.indices) if ds_valid else 0)

    # only the clinical step head trains
    optimizer = make_optimizer(trainable_by_path(cae, STEP_HEAD),
                               learning_rate, betas=betas,
                               weight_decay=1e-5)
    sched = multistep_lr(learning_rate, args.lrsteps) if args.lrsteps else None
    learner = CaeStepLearner(
        ds_train, ds_valid, cae, optimizer, sched, n_epochs=args.epochs,
        normalization_hours_penumbra=args.normalize,
        path_previous_base=args.inbasepath,
        path_outputs_base=args.outbasepath, seed=args.seed,
        distances_on_training=args.distances, profile_dir=args.profile,
        device=device, mesh=mesh)

    # the phase-1 CAE's encoder trunk and decoder, parameters and BN
    # statistics, into the fresh model
    cae.enc.encoder.load_state_dict(cae_loaded.enc.encoder.state_dict())
    cae.dec.load_state_dict(cae_loaded.dec.state_dict())
    learner.run_training()
    if mesh is not None:
        distributed.shutdown()
    return learner


if __name__ == "__main__":
    print(datetime.datetime.now())
    train(get_args_step_training())
    print(datetime.datetime.now())
