"""The learner's device plan (train/learner.py, the JAX learner's
``_make_plan`` / ``_build_epoch_fn`` / ``_run_epoch``) on the CPU, where
the planned pass runs the same step body as the card's CUDA graphs, eagerly:

* the plan's rows for ``PLAN_BLOCK`` epochs are the JAX loader's
  ``epoch_chunks()`` sequence for the same seed;
* planned and eager passes give the same curves and weights (the port's
  ``TestEpochPlanBitIdentity``), for the U-Net and the CAE's phase 1,
  across an lr milestone, the beta1 ramp and a nonzero loss factor;
* the learning rate, beta1 and the loss factor are device state, changed
  in place, which a captured step reads when it replays;
* the planned step's body makes no host read (a tripwire on the tensor
  methods that copy to the host);
* ``train.optim.Adam``'s state round-trips through ``.optim`` byte for
  byte, the file today's ``torch.optim.Adam`` state writes, and a resumed
  planned run equals a resumed eager one.
"""

import contextlib
import filecmp
import re
import types

import numpy as np
import pytest
import torch

from stroke_prediction_tpu.data import loader as jax_loader
from stroke_prediction_tpu_torch.data import dataset
from stroke_prediction_tpu_torch.data.loader import (
    BatchLoader, get_stroke_shape_training_data)
from stroke_prediction_tpu_torch.models.cae3d import Cae3D, Dec3D, Enc3D
from stroke_prediction_tpu_torch.models.convert import (
    adam_state_from_jax, adam_state_to_jax)
from stroke_prediction_tpu_torch.models.unet3d import Unet3D
from stroke_prediction_tpu_torch.train import optim
from stroke_prediction_tpu_torch.train.cae_learners import (
    CaeReconstructionLearner)
from stroke_prediction_tpu_torch.train.learner import Learner
from stroke_prediction_tpu_torch.train.unet_learner import (
    UnetSegmentationLearner)
from stroke_prediction_tpu_torch.utils import checkpoint

torch.set_num_threads(1)

UNET_CHANNELS = (2, 4, 6, 8, 6, 4, 6, 2)
CAE_CHANNELS = (1, 2, 3, 4, 5, 6, 1)
BETAS = (0.9, 0.999)


class _Factored(CaeReconstructionLearner):
    """Phase 1 with a loss factor from the first epoch on (the curriculum
    starts at epoch 26), so that a short run changes it between passes."""

    def loss_factor(self, epoch):
        return 0.1 + 0.3 * epoch


def _no_plots(learner):
    """The learner without its PNGs (the visual grids' forwards and
    matplotlib's rendering are the slow part of a CPU run)."""
    learner.pyplot = lambda: None
    return learner


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    """The synthetic cases, made once for the module's learners."""
    return str(tmp_path_factory.mktemp("cases"))


def _unet_learner(cache, tmp_path, tag, **kw):
    ds = dataset.StrokeDataset3D(
        dataset.SyntheticCaseProvider(n_cases=7, shape_xyz=(24, 24, 24),
                                      seed=4, cache_dir=cache),
        [dataset.MOD_CBV, dataset.MOD_TTD],
        [dataset.LABEL_CORE, dataset.LABEL_PENU], resample=0.5,
        pad=(20, 20, 20))
    # five training cases: chunks of 2, 2 and a ragged 1, two groups
    train, valid = get_stroke_shape_training_data(ds, range(7), 0.3,
                                                  seed=4, batchsize=2)
    model = Unet3D(UNET_CHANNELS, generator=torch.Generator().manual_seed(4))
    opt = optim.make_optimizer(model.parameters(), 1e-3, betas=BETAS,
                               weight_decay=1e-5)
    return _no_plots(UnetSegmentationLearner(
        train, valid, model, opt, optim.multistep_lr(1e-3, [1]), n_epochs=2,
        patch_whd=(44, 44, 44), pad_xyz=(20, 20, 20),
        path_outputs_base=str(tmp_path / tag), device="cpu", **kw))


def _cae_learner(cache, tmp_path, tag, **kw):
    ds = dataset.StrokeDataset3D(
        dataset.SyntheticCaseProvider(n_cases=4, shape_xyz=(64, 64, 28),
                                      seed=4, cache_dir=cache),
        [dataset.MOD_CBV, dataset.MOD_TTD],
        [dataset.LABEL_CORE, dataset.LABEL_PENU, dataset.LABEL_LESION])
    train, valid = get_stroke_shape_training_data(ds, range(4), 0.5,
                                                  seed=4, batchsize=2)
    gen = torch.Generator().manual_seed(4)
    model = Cae3D(Enc3D(CAE_CHANNELS, generator=gen),
                  Dec3D(CAE_CHANNELS, generator=gen))
    opt = optim.make_optimizer(model.parameters(), 1e-3, betas=BETAS,
                               weight_decay=1e-5)
    return _no_plots(_Factored(
        train, valid, model, opt, optim.multistep_lr(1e-3, [1]),
        n_epochs=2, path_outputs_base=str(tmp_path / tag),
        device="cpu", **kw))


def _weights(learner):
    return {k: v.clone() for k, v in learner._model.state_dict().items()}


def test_plan_rows_are_the_jax_loaders_epoch_chunks():
    """Two blocks of ``PLAN_BLOCK`` epochs plus a part block: each epoch's
    rows and slots in the plan are the JAX loader's ``epoch_chunks()`` of
    that epoch (the same seed), ragged tail chunk apart in its group."""
    indices, n_epochs = [3, 7, 8, 11, 12, 15, 20], 2 * Learner.PLAN_BLOCK + 3
    ours = BatchLoader(None, indices, 3, shuffle=True, seed=4)
    theirs = jax_loader.BatchLoader(None, indices, 3, shuffle=True, seed=4)
    rowmap = {idx: row for row, idx in enumerate(indices)}
    stub = types.SimpleNamespace(
        _n_epochs=n_epochs, PLAN_BLOCK=Learner.PLAN_BLOCK,
        device=torch.device("cpu"),
        device_data=lambda loader: (None, rowmap))
    plan = Learner._make_plan(stub, ours, 0)
    assert plan["bounds"] == [(0, 2, 3), (2, 3, 1)]
    assert (plan["n_steps"], plan["n_vol"]) == (3, 7)
    assert len(plan["blocks"]) == 3
    for e in range(n_epochs):
        want = theirs.epoch_chunks()
        block, slot = divmod(e, Learner.PLAN_BLOCK)
        got = [row for group in plan["blocks"][block]
               for row in group[slot].tolist()]
        assert [[indices[r] for r in row[:-1]] for row in got] == want
        assert [row[-1] for row in got] == [0, 1, 2]


@pytest.mark.parametrize("kind", ["unet", "cae", "unet, an epoch a block"])
def test_planned_passes_equal_eager_passes(cache, tmp_path, kind):
    """The curves (every metric of both phases) and the trained weights of
    a planned run equal an eager run's bit for bit, across the lr
    milestone at epoch 1 and, for the CAE, the beta1 ramp and a loss
    factor that changes with the epoch; with one epoch a plan block, the
    runners load the second block into their buffers."""
    make = _cae_learner if kind == "cae" else _unet_learner
    planned = make(cache, tmp_path, "planned", device_cache=True)
    blocked = kind == "unet, an epoch a block"
    if blocked:
        planned.PLAN_BLOCK = 1
    planned.run_training()
    if blocked:
        assert len(planned._plans["train"]["blocks"]) == 2
    eager = make(cache, tmp_path, "eager", device_cache=False)
    eager.run_training()
    assert planned._plans and not eager._plans
    if kind != "cae":
        assert planned._plans["train"]["bounds"] == [(0, 2, 2), (2, 3, 1)]
    assert planned.step_counts == eager.step_counts
    assert planned._metric_dtos == eager._metric_dtos
    want = _weights(eager)
    for key, value in _weights(planned).items():
        assert torch.equal(value, want[key]), key


def test_switch_reads_the_environment(cache, tmp_path, monkeypatch):
    """``device_cache=None`` reads ``STROKE_TPU_DEVICE_CACHE`` ("0" off,
    anything else or unset on); a ``process_shard`` loader stays eager."""
    monkeypatch.setenv("STROKE_TPU_DEVICE_CACHE", "0")
    assert not _unet_learner(cache, tmp_path, "off")._device_cache
    monkeypatch.delenv("STROKE_TPU_DEVICE_CACHE")
    learner = _unet_learner(cache, tmp_path, "on")
    loader = learner._dataloader_training
    assert learner._device_cache and learner._plans_loader(loader)
    loader.process_shard = True
    assert not learner._plans_loader(loader)


def test_epoch_probe_line(cache, tmp_path, monkeypatch, capsys):
    """``STROKE_TPU_TIME_EPOCH=1``: one ``[epoch-probe]`` line a planned
    pass, as the JAX learner prints it."""
    monkeypatch.setenv("STROKE_TPU_TIME_EPOCH", "1")
    _unet_learner(cache, tmp_path, "probe", device_cache=True).run_training()
    found = re.findall(r"\[epoch-probe\] (train|eval) dispatch [0-9.]+ms "
                       r"fetch [0-9.]+ms$", capsys.readouterr().out, re.M)
    assert found == ["train", "eval"] * 2


def test_hyperparameters_change_in_place_and_reach_the_step(cache, tmp_path):
    """The lr, beta1 and the loss factor a captured step reads are tensors
    that keep their storage while their values change (``adapt_lr``,
    ``adapt_betas``, a planned pass's factor).  A planned step, a change of
    all three, and a second planned step give the weights that two eager
    steps on the same rows give across the same change."""
    planned, eager = (_cae_learner(cache, tmp_path, tag, device_cache=c)
                      for tag, c in (("planned", True), ("eager", False)))
    loader = planned._dataloader_training
    plan = planned._plan_of(loader, 0)
    (i, j, _), *_ = plan["bounds"]
    run = planned._runner(loader, plan, True, 0)
    opt = planned._optimizer
    lr, b1 = opt.param_groups[0]["lr"], opt.param_groups[0]["betas"][0]
    factor = planned._factor
    data, _ = eager.device_data(eager._dataloader_training)
    for epoch in (0, 1):
        for learner in (planned, eager):
            learner.adapt_lr(epoch)
            learner.adapt_betas(epoch)
        planned._factor.fill_(planned.loss_factor(epoch))
        assert opt.param_groups[0]["lr"] is lr
        assert opt.param_groups[0]["betas"][0] is b1
        assert planned._factor is factor
        idx = plan["blocks"][0][0][epoch][0]
        run(plan["blocks"][0][0], epoch * (j - i))
        eager.train_step({k: None if v is None else v.index_select(
            0, idx[:-1]) for k, v in data.items()}, eager.loss_factor(epoch))
    assert float(lr) == pytest.approx(1e-4)
    assert float(b1) == pytest.approx(BETAS[0] - 0.3)
    assert float(factor) == pytest.approx(planned.loss_factor(1))
    want = _weights(eager)
    for key, value in _weights(planned).items():
        assert torch.equal(value, want[key]), key


HOST_READS = ("item", "tolist", "cpu", "numpy", "__bool__", "__int__",
              "__float__")


@contextlib.contextmanager
def _tripwire():
    """Every tensor method that reads a value on the host raises."""
    saved = {name: getattr(torch.Tensor, name) for name in HOST_READS}

    def trip(name):
        def raising(self, *a, **kw):
            raise AssertionError(f"Tensor.{name} in a planned step")
        return raising

    try:
        for name in HOST_READS:
            setattr(torch.Tensor, name, trip(name))
        yield
    finally:
        for name, fn in saved.items():
            setattr(torch.Tensor, name, fn)


@pytest.mark.parametrize("kind", ["unet", "cae"])
def test_planned_step_body_reads_nothing_on_the_host(cache, tmp_path, kind):
    """A training and a validation step of the planned path (the body a
    CUDA graph captures, the kernels' plain versions here) under the
    tripwire; the control, a fetch of its metrics, trips it."""
    make = _unet_learner if kind == "unet" else _cae_learner
    learner = make(cache, tmp_path, "tripwire", device_cache=True)
    for loader, training in ((learner._dataloader_training, True),
                             (learner._dataloader_validation, False)):
        plan = learner._plan_of(loader, 0)
        run = learner._runner(loader, plan, training, 0)
        with _tripwire():
            run(plan["blocks"][0][0], 0)
        with pytest.raises(AssertionError, match="Tensor.cpu"):
            with _tripwire():
                plan["out"].cpu()
        assert torch.isfinite(plan["out"][0]).any()


def test_optim_round_trips_byte_for_byte(tmp_path):
    """A ``.optim`` written from today's ``torch.optim.Adam`` (two steps
    at lr 1e-4, beta1 0.6) loads into ``train.optim.Adam`` and writes back
    the same bytes; the loaded state is on the parameters' device and the
    hyperparameters are the held tensors."""
    model = Unet3D(UNET_CHANNELS, generator=torch.Generator().manual_seed(4))
    rs = np.random.RandomState(0)
    ref = torch.optim.Adam(model.parameters(), lr=1e-4, betas=(0.6, 0.999),
                           weight_decay=1e-5)
    for _ in range(2):
        for p in model.parameters():
            p.grad = torch.from_numpy(rs.randn(*p.shape).astype(np.float32))
        ref.step()
    today = str(tmp_path / "today.optim")
    checkpoint.save_checkpoint(today, {"opt_state": adam_state_to_jax(
        ref, model)})
    opt = optim.make_optimizer(model.parameters(), 1e-3, betas=BETAS)
    held = opt.param_groups[0]["lr"]
    loaded, _ = checkpoint.load_checkpoint(today)
    opt.load_state_dict(adam_state_from_jax(loaded["opt_state"], model, opt))
    assert opt.param_groups[0]["lr"] is held
    assert float(held) == pytest.approx(1e-4)
    assert float(opt.param_groups[0]["betas"][0]) == pytest.approx(0.6)
    assert isinstance(opt.param_groups[0]["betas"][1], torch.Tensor)
    first = next(model.parameters())
    assert int(opt.state[first]["step"]) == 2
    assert opt.state[first]["step"].dtype == torch.float32
    again = str(tmp_path / "again.optim")
    checkpoint.save_checkpoint(again, {"opt_state": adam_state_to_jax(
        opt, model)})
    assert filecmp.cmp(today, again, shallow=False)


def test_resumed_planned_run_equals_resumed_eager_run(cache, tmp_path):
    """A run's best-valid snapshot resumed for one more epoch: the planned
    learner (its plan made after the load) and the eager one give the same
    curves, weights and ``.optim`` bytes."""
    first = _unet_learner(cache, tmp_path, "first", device_cache=False)
    first.run_training()
    base = str(tmp_path / "first")
    runs = []
    for tag, on in (("planned", True), ("eager", False)):
        learner = _unet_learner(cache, tmp_path, tag, device_cache=on,
                                path_previous_base=base)
        learner._n_epochs = learner.get_start_epoch() + 1
        learner.run_training()
        learner.save_training()
        runs.append(learner)
    planned, eager = runs
    assert planned._plans["train"]["epoch0"] == planned.get_start_epoch() - 1
    assert planned._metric_dtos == eager._metric_dtos
    want = _weights(eager)
    for key, value in _weights(planned).items():
        assert torch.equal(value, want[key]), key
    assert filecmp.cmp(str(tmp_path / "planned_unet.optim"),
                       str(tmp_path / "eager_unet.optim"), shallow=False)
