"""One rank of the port's 2-process data-parallel CAE learner tests
(test_torch_cae_parallel.py, test_torch_cae_parallel_frozen.py).

    python tests/_torch_cae_parallel_worker.py HOST:PORT WORLD RANK INPUTS DIR

Imports torch and stroke_prediction_tpu_torch only (checked at the end: no
JAX in this process).  Joins a gloo process group, then, for each learner
case that ``INPUTS`` (an .npz the test wrote) names, one float64 training
step (augmentation off) on this rank's rows of a 4-row global batch:

* ``step``: the learner's ``train_step``, sharded: the loss and measures,
  every trainable parameter's gradient after the all-reduce and before it
  (``pregrad``: the control without ``average_gradients``), the buffers;
* ``bn``: the same step with BN's moments left per rank (control);
* ``hinge``: the loss of a forward with the hinges' means left per rank
  (control: the ranks' losses differ);
* ``replicated`` (the cases in ``replicated``): the step on a 3-row batch,
  which does not divide over two ranks and so runs whole on each.

Then the augmentation draws (``random_cae_augment``,
``random_cae_augment_images``, ``random_cae_augment_ctp`` from one seed)
of this rank's rows under a sharded step, with the generator's next
numbers; the lead-only writes of the phase-1 and phase-2 learners into a
directory of this rank's own; and, with no mesh and no sharding, the
one-process steps that ``one/<rank>`` names (``<case>:<rows>``), so that
the ranks share that work with the test's process.

Writes ``DIR/rank<RANK>.npz`` and prints ``CAE_PARALLEL_WORKER_OK``.
"""

import os
import sys
import types

import numpy as np
import torch

from stroke_prediction_tpu_torch.data import augment
from stroke_prediction_tpu_torch.data.dataset import (
    KEY_GLOBAL, KEY_IMAGES, KEY_LABELS)
from stroke_prediction_tpu_torch.eval import metrics
from stroke_prediction_tpu_torch.models import layers
from stroke_prediction_tpu_torch.models.cae3d import (
    Cae3D, Cae3DCtp, Dec3D, Enc3D, Enc3DCtp, Enc3DStep)
from stroke_prediction_tpu_torch.parallel import distributed
from stroke_prediction_tpu_torch.parallel.mesh import (
    batch_sharding, make_data_mesh, row_sharding)
from stroke_prediction_tpu_torch.train import cae_learners
from stroke_prediction_tpu_torch.train.optim import (
    make_optimizer, trainable_by_path)

CHANNELS = (1, 4, 6, 8, 10, 12, 1)
CTP_CHANNELS = (3, 4, 6, 8, 10, 12, 1)
PAD = (4, 4, 4)                       # the CTP images' padding, (D, H, W)
SPATIAL = (28, 64, 64)                # the smallest (D, H, W) the CAE takes
HEAD = ("reduce1", "reduce2", "step_head")
# case -> (learner, curriculum factor)
CASES = {"phase1": ("phase1", 0.0), "phase1_factor": ("phase1", 0.4),
         "ctp": ("ctp", 0.4), "step": ("step", 0.0),
         "prediction": ("prediction", 0.0)}
# the batch arrays of each learner: images (or None), labels, clinical
IMAGES = {"phase1": None, "ctp": "ctp_images", "step": None,
          "prediction": "pred_images"}
AUGMENT_SEED = 7
F64 = torch.float64


def _state(inputs, name):
    prefix = f"state/{name}/"
    return {k[len(prefix):]: torch.from_numpy(inputs[k])
            for k in inputs.files if k.startswith(prefix)}


def _float64(model):
    """``model`` in float64, its stacks computing in float64."""
    model.double()
    for m in model.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = F64
    return model


def make_learner(kind, inputs, mesh, base="/nonexistent/cae"):
    """The float64 learner of ``kind`` at ``inputs``' weights, Adam as its
    CLI builds it, the data loader a stand-in (batch 4)."""
    loader = types.SimpleNamespace(batch_size=4, dataset=None, indices=[])
    kw = dict(device="cpu", mesh=mesh, path_outputs_base=base)
    if kind == "prediction":
        cae = Cae3D(Enc3D(CHANNELS, 5), Dec3D(CHANNELS, 5))
        cae.load_state_dict(_state(inputs, "cae"))
        enc = Enc3D(CHANNELS, 5)
        enc.load_state_dict(_state(inputs, "enc"))
        opt = make_optimizer(enc.parameters(), 1e-3, betas=(0.9, 0.999),
                             weight_decay=1e-5)
        return cae_learners.CaePredictionLearner(
            loader, None, _float64(cae), _float64(enc), opt, None, 1, **kw)
    if kind == "ctp":
        model = Cae3DCtp(Enc3DCtp(CTP_CHANNELS, 5, padding=PAD),
                         Dec3D(CTP_CHANNELS, 5))
    else:
        model = Cae3D((Enc3DStep if kind == "step" else Enc3D)(CHANNELS, 5),
                      Dec3D(CHANNELS, 5))
    model.load_state_dict(_state(inputs, kind))
    _float64(model)
    params = (trainable_by_path(model, HEAD) if kind == "step"
              else model.parameters())
    opt = make_optimizer(params, 1e-3, betas=(0.9, 0.999),
                         weight_decay=1e-5)
    cls = (cae_learners.CaeStepLearner if kind == "step"
           else cae_learners.CaeReconstructionLearner)
    return cls(loader, None, model, opt, None, 1,
               inputs_from_images=kind == "ctp", **kw)


def local_batch(inputs, kind, sharding, n_rows):
    """This rank's rows of the first ``n_rows`` of the global batch."""
    def rows(key):
        return torch.from_numpy(sharding.take(inputs[key][:n_rows])
                                ).contiguous().to(F64)
    return {KEY_IMAGES: None if IMAGES[kind] is None else rows(IMAGES[kind]),
            KEY_LABELS: rows("labels"), KEY_GLOBAL: rows("clinical")}


def step(case, inputs, mesh, n_rows=4, base="/nonexistent/cae"):
    """{metric/<k>, grad/<name>, pregrad/<name>, stat/<name>} of one
    training step of ``case`` on this rank's rows of the first ``n_rows``
    (by the row rule), and the learner."""
    kind, factor = CASES[case]
    learner = make_learner(kind, inputs, mesh, base)
    learner.augment = lambda batch: batch
    sharding = row_sharding(mesh, n_rows)
    batch = local_batch(inputs, kind, sharding, n_rows)
    model = learner._model
    pre = {}
    average = cae_learners.average_gradients

    def keep_then_average(params):
        params = list(params)
        pre.update({k: p.grad.clone() for k, p in model.named_parameters()
                    if p.grad is not None})
        average(params)

    cae_learners.average_gradients = keep_then_average
    try:
        with sharding.active():
            metrics_ = learner.train_step(batch, factor)
    finally:
        cae_learners.average_gradients = average
    out = {f"metric/{k}": v.double().numpy() for k, v in metrics_.items()}
    out.update({f"grad/{k}": p.grad.numpy()
                for k, p in model.named_parameters() if p.grad is not None})
    out.update({f"pregrad/{k}": g.numpy() for k, g in pre.items()})
    out.update({f"stat/{k}": b.numpy() for k, b in model.named_buffers()})
    return out, learner


def hinge_control_loss(case, inputs, mesh):
    """The loss of one training-mode forward on this rank's rows with the
    hinges' means taken over the rank's rows alone."""
    kind, factor = CASES[case]
    learner = make_learner(kind, inputs, mesh)
    sharding = row_sharding(mesh, 4)
    batch = local_batch(inputs, kind, sharding, 4)
    real = metrics.global_mean
    metrics.global_mean = torch.mean
    try:
        learner._model.train()
        with sharding.active(), torch.no_grad():
            loss, _ = learner.forward_loss(batch, factor)
    finally:
        metrics.global_mean = real
    return loss.numpy()


def one_process(entry, inputs):
    """``entry`` ``"<case>:<rows>"``: the one-process step (no mesh, no
    sharding) of the case on the first ``rows`` of the global batch, under
    ``one/<case>/`` (4 rows) or ``one3/<case>/`` (3 rows)."""
    case, n_rows = entry.split(":")
    got, _ = step(case, inputs, None, n_rows=int(n_rows))
    key = "one" if n_rows == "4" else f"one{n_rows}"
    return {f"{key}/{case}/{k}": v for k, v in got.items()}


def augment_draws(inputs, mesh):
    """Each CAE augmentation of this rank's rows under a sharded step, from
    one seed, and the generator's next four numbers after it."""
    sharding = batch_sharding(mesh)

    def rows(key):
        return torch.from_numpy(sharding.take(inputs[key])).contiguous()

    labels = rows("labels")
    out = {}
    for name, fn, args in (
            ("labels", augment.random_cae_augment, (labels,)),
            ("images", augment.random_cae_augment_images,
             (rows("pred_images"), labels)),
            ("ctp", augment.random_cae_augment_ctp,
             (rows("ctp_images"), labels))):
        gen = torch.Generator().manual_seed(AUGMENT_SEED)
        with sharding.active():
            got = fn(gen, *args)
        for i, t in enumerate(got if isinstance(got, tuple) else (got,)):
            out[f"augment/{name}/{i}"] = t.numpy()
        out[f"augment/{name}/next"] = torch.rand(4, generator=gen).numpy()
    return out


def main():
    coordinator, world, rank, inputs_path, outdir = sys.argv[1:6]
    torch.set_num_threads(1)
    distributed.initialize(coordinator, int(world), int(rank), device="cpu")
    mesh = make_data_mesh()
    inputs = np.load(inputs_path)
    cases = [str(c) for c in inputs["cases"]]
    replicated = [str(c) for c in inputs["replicated"]]
    out = {"rank": np.int64(mesh.rank)}
    files = os.path.join(outdir, f"files{mesh.rank}")
    os.makedirs(files)

    for case in cases:
        got, learner = step(case, inputs, mesh,
                            base=os.path.join(files, case))
        out.update({f"step/{case}/{k}": v for k, v in got.items()})
        if case in ("phase1", "prediction"):
            learner.save_model()
            learner.save_training()
        if case == "phase1_factor":
            continue                  # phase 1's controls run at factor 0
        reduce_sums = layers.reduce_sums
        layers.reduce_sums = lambda *xs: xs          # per-rank BN moments
        try:
            got, _ = step(case, inputs, mesh)
        finally:
            layers.reduce_sums = reduce_sums
        out.update({f"bn/{case}/{k}": v for k, v in got.items()})
        out[f"hinge/{case}"] = hinge_control_loss(case, inputs, mesh)
    for case in replicated:
        got, _ = step(case, inputs, mesh, n_rows=3)
        out.update({f"replicated/{case}/{k}": v for k, v in got.items()})
    if "phase1" in cases:
        out.update(augment_draws(inputs, mesh))
    distributed.shutdown()

    # the one-process references, outside any process group's step
    for entry in inputs[f"one/{mesh.rank}"]:
        out.update(one_process(str(entry), inputs))

    jax_loaded = [m for m in sys.modules
                  if m in ("jax", "stroke_prediction_tpu")
                  or m.startswith(("jax.", "stroke_prediction_tpu."))]
    if jax_loaded:
        raise AssertionError(f"a rank imported {jax_loaded[:5]}")
    np.savez(os.path.join(outdir, f"rank{mesh.rank}.npz"), **out)
    print(f"CAE_PARALLEL_WORKER_OK rank={mesh.rank}", flush=True)


if __name__ == "__main__":
    main()
