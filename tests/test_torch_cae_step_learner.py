"""Port parity for step learning on a frozen phase-1 CAE
(``CaeStepLearner``, ``cli/train_interpolationstep_after_reconstruction``)
and for what it needs: K3 alone as the backward of a frozen conv (the
``"dx"`` route), the trainable parameters by path, and the masked Adam
state that the JAX learner's ``optax.masked`` chain writes.

One learner training step (augmentation off) is held to JAX's
``CaeStepLearner._loss`` run in float64 (``_Float64Numpy``) on the same
variables and batch, in float64, float32 and bfloat16 at
``tests/test_torch_cae_train_step.py``'s limits: the loss, the step head's
six gradients (each within the type's limit of its own max|ref|), every
running statistic of the whole CAE (all of it runs in training mode, so
the frozen trunk's statistics move) and the frozen parameters bit for bit
after Adam, with no gradient.  The masked ``.optim``: byte-identical to
JAX's for the same state, read from a JAX-written file, and resumed in
both packages after the CLI's run."""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from stroke_prediction_tpu import inference as jax_inference
from stroke_prediction_tpu.core.dto import BRANCH_GTRUTH as JAX_GTRUTH
from stroke_prediction_tpu.data import dataset as jax_dataset
from stroke_prediction_tpu.data import loader as jax_loader
from stroke_prediction_tpu.eval import metrics as jax_metrics
from stroke_prediction_tpu.models import cae3d as jax_cae3d
from stroke_prediction_tpu.models import layers as jax_layers
from stroke_prediction_tpu.train import cae_learners as jax_cae_learners
from stroke_prediction_tpu.train import checkpoint as jax_checkpoint
from stroke_prediction_tpu.train import optim as jax_optim
from stroke_prediction_tpu.utils import args as jax_args
from stroke_prediction_tpu_torch.cli import common as port_common
from stroke_prediction_tpu_torch.cli import (
    train_interpolationstep_after_reconstruction as step_cli)
from stroke_prediction_tpu_torch.data.dataset import (
    KEY_GLOBAL, KEY_IMAGES, KEY_LABELS)
from stroke_prediction_tpu_torch.models.cae3d import (
    Cae3D, Dec3D, Enc3D, Enc3DStep)
from stroke_prediction_tpu_torch.models.convert import (
    _key_map, adam_state_from_jax, adam_state_to_jax, save_cae_checkpoint,
    state_from_jax)
from stroke_prediction_tpu_torch.ops import conv3x3 as cm
from stroke_prediction_tpu_torch.train import optim
from stroke_prediction_tpu_torch.train.cae_learners import CaeStepLearner
from stroke_prediction_tpu_torch.utils import checkpoint
from stroke_prediction_tpu_torch.utils.args import get_args_step_training

from test_torch_cae_train_step import (
    CHANNELS, _batch, _config, _jax_model, _tols, _variables)
from test_torch_train import ULP, _Float64Numpy, _leaf

torch.set_num_threads(1)

HEAD = ("reduce1", "reduce2", "step_head")
BETAS, L2 = (0.9, 0.999), 1e-5


# ------------------------------------------------------- the "dx" route

def _recording(mp):
    """Count the backward wrappers' calls (on the CPU they run their plain
    versions and count no launch)."""
    seen = []
    for name in ("conv3x3_bwd_fused", "conv3x3_bwd_dx", "conv3x3_bwd_dw"):
        real = getattr(cm, name)

        def rec(*a, _real=real, _name=name, **kw):
            seen.append(_name)
            return _real(*a, **kw)
        mp.setattr(cm, name, rec)
    return seen


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ci, co, mode, act, table", [
    (6, 4, "s", "elu", False), (16, 16, "s", "elu", True),
    (24, 16, "v", "leaky_relu", False)])
def test_frozen_conv_takes_the_dx_route(ci, co, mode, act, table, dtype):
    """A conv whose kernel and bias need no gradient: ``bwd_route`` gives
    'dx', the backward runs K3 alone and returns no kernel or bias
    gradient, and dx equals the full route's dx bit for bit (both are K3's
    plain version on the same g)."""
    assert cm.bwd_route(ci, co, True, False) == "dx"
    assert cm.bwd_route(ci, co, True, True) in ("fused", "split")
    assert cm.bwd_route(ci, co, False, True) == "dw"
    gen = torch.Generator().manual_seed(0)
    d = 5
    x0 = torch.rand((2, d, 7, 8, ci), generator=gen).to(dtype)
    kernel0 = (torch.rand((3, 3, 3, ci, co), generator=gen) - 0.5) * 0.3
    bias0 = torch.rand(((d if mode == "s" else d - 2), co) if table
                       else (co,), generator=gen) - 0.5
    g = torch.rand((2, d if mode == "s" else d - 2, 5, 6, co),
                   generator=gen)
    grads = {}
    for frozen in (True, False):
        x = x0.clone().requires_grad_(True)
        kernel = kernel0.clone().requires_grad_(not frozen)
        bias = bias0.clone().requires_grad_(not frozen)
        with pytest.MonkeyPatch.context() as mp:
            seen = _recording(mp)
            y = cm.Conv3x3Fn.apply(x, kernel, bias, act, 1.0, mode)
            (y.float() * g).sum().backward()
        grads[frozen] = (x.grad, kernel.grad, bias.grad, seen)
    dx, dk, db, seen = grads[True]
    assert seen == ["conv3x3_bwd_dx"]
    assert dk is None and db is None
    assert dx.dtype == dtype
    assert torch.equal(dx, grads[False][0])
    assert grads[False][1] is not None and grads[False][2] is not None


# ------------------------------------------- trainable parameters by path

def _port_cae(variables, dtype=torch.float32):
    model = Cae3D(Enc3DStep(CHANNELS, 5, compute_dtype=dtype),
                  Dec3D(CHANNELS, 5, compute_dtype=dtype))
    model.load_state_dict(state_from_jax(variables, _config(True)))
    return model


@pytest.fixture(scope="module")
def step_variables():
    return _variables(True, 1)


def test_trainable_by_path_matches_jax_mask(step_variables):
    """The port's trainable set is the JAX mask's True leaves."""
    mask = jax_optim.trainable_mask_by_path(step_variables["params"], HEAD)
    model = _port_cae(step_variables)
    trainable = optim.trainable_by_path(model, HEAD)
    want = {key for path, key in _key_map(_config(True))
            if path[0] == "params" and _leaf(mask, path[1:])}
    named = dict(model.named_parameters())
    assert {k for k, p in named.items() if p.requires_grad} == want
    assert [id(p) for p in trainable] == [
        id(p) for p in model.parameters() if p.requires_grad]
    assert len(want) == 6 < len(named)


# ------------------------------------------------- the masked Adam state

def _jax_masked_state(variables, steps=1):
    """optax's masked chain as the JAX step CLI builds it, after ``steps``
    updates on random gradients at beta1 0.6 -> (tx, params, state,
    grads)."""
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    tx = jax_optim.make_optimizer(
        1e-3, betas=BETAS, weight_decay=L2,
        trainable_mask=jax_optim.trainable_mask_by_path(params, HEAD))
    rs = np.random.RandomState(3)
    grads = jax.tree_util.tree_map(
        lambda a: rs.randn(*a.shape).astype(np.float32), variables["params"])
    state = jax_optim.set_hyperparams(tx.init(params), b1=0.6)
    for _ in range(steps):
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
    return tx, params, state, grads


def test_masked_optimizer_state_round_trip(step_variables, tmp_path):
    """A JAX masked ``.optim`` loads into the port's Adam over the head
    and comes back leaf for leaf (frozen leaves empty maps) and byte for
    byte; one more step from it agrees with optax, the frozen parameters
    untouched."""
    tx, params, state, grads = _jax_masked_state(step_variables)
    jax_path = str(tmp_path / "jax.optim")
    jax_checkpoint.save_checkpoint(jax_path, {"opt_state": state})

    model = _port_cae({"params": jax.tree_util.tree_map(np.asarray, params),
                       "batch_stats": step_variables["batch_stats"]})
    opt = optim.make_optimizer(optim.trainable_by_path(model, HEAD), 5e-1,
                               betas=(0.5, 0.999), weight_decay=L2)
    loaded, _ = checkpoint.load_checkpoint(jax_path)
    opt.load_state_dict(adam_state_from_jax(loaded["opt_state"], model, opt))
    assert opt.param_groups[0]["betas"][0] == pytest.approx(0.6)
    assert len(opt.state) == 6
    back = adam_state_to_jax(opt, model)
    assert back["inner_state"]["1"] == {"inner_state": {}}
    assert back["inner_state"]["0"]["inner_state"]["1"]["mu"]["dec"][
        "decoder"]["Conv3d_0"]["kernel"] == {}
    flat_want = jax.tree_util.tree_leaves_with_path(
        serialization.to_state_dict(state))
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_want) == len(flat_back) == 4 + 2 * 6
    for path, leaf in flat_want:
        assert flat_back[path].dtype == np.asarray(leaf).dtype, path
        np.testing.assert_array_equal(flat_back[path], np.asarray(leaf),
                                      err_msg=str(path))
    port_path = str(tmp_path / "port.optim")
    checkpoint.save_checkpoint(port_path, {"opt_state": back})
    with open(jax_path, "rb") as a, open(port_path, "rb") as b:
        assert a.read() == b.read()

    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    updates, state = tx.update(grads, state, params)
    params = optax.apply_updates(params, updates)
    named = dict(model.named_parameters())
    for path, k in _key_map(_config(True)):
        if path[0] == "params" and named[k].requires_grad:
            named[k].grad = torch.from_numpy(_leaf(grads, path[1:]).copy())
    opt.step()
    for path, k in _key_map(_config(True)):
        if path[0] != "params":
            continue
        np.testing.assert_allclose(named[k].detach().numpy(),
                                   _leaf(params, path[1:]), atol=1e-7,
                                   rtol=ULP, err_msg=k)
        if not named[k].requires_grad:
            assert torch.equal(named[k].detach(), before[k]), k


# ------------------------------------------------------------- the step

def _jax_step64(variables):
    """value_and_grad of ``CaeStepLearner._loss`` at train=True in float64,
    the step regressed by the head -> (loss, grads, new batch_stats)."""
    labels, clinical = _batch()
    model = _jax_model(True, jnp.float64)
    loss_self = types.SimpleNamespace(_label_weights=(1.0,))

    def run(params, batch_stats, labels, clinical):
        def loss_fn(p):
            dto = jax_inference.cae_dto_from_batch(None, labels, clinical,
                                                   learn_step=True)
            out, mut = model.apply({"params": p, "batch_stats": batch_stats},
                                   dto, JAX_GTRUTH, True,
                                   mutable=["batch_stats"])
            return jax_cae_learners.CaeStepLearner._loss(
                loss_self, out, 0.0), mut
        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    with pytest.MonkeyPatch.context() as mp:
        for mod in (jax_layers, jax_cae3d, jax_metrics, jax_inference,
                    jax_cae_learners):
            mp.setattr(mod, "jnp", _Float64Numpy())
        jax.config.update("jax_enable_x64", True)
        try:
            cast = lambda t: jax.tree_util.tree_map(  # noqa: E731
                lambda a: jnp.asarray(a, jnp.float64), t)
            (loss, mut), grads = jax.jit(run)(
                cast(variables["params"]), cast(variables["batch_stats"]),
                jnp.asarray(labels, jnp.float64),
                jnp.asarray(clinical, jnp.float64))
            return (float(loss), jax.tree_util.tree_map(np.asarray, grads),
                    jax.tree_util.tree_map(np.asarray, mut["batch_stats"]))
        finally:
            jax.config.update("jax_enable_x64", False)


@pytest.fixture(scope="module")
def jax_step64(step_variables):
    return _jax_step64(step_variables)


def _loader(batch_size=2):
    return types.SimpleNamespace(batch_size=batch_size, dataset=None,
                                 indices=[])


def _learner_step(variables, dtype):
    """One ``CaeStepLearner.train_step`` (augmentation off) of the port's
    model from ``variables``, frozen but for the head, Adam over the head ->
    (metrics, model, parameters before the step)."""
    labels, clinical = _batch()
    model = _port_cae(variables, dtype)
    if dtype == torch.float64:
        model.to(dtype)
    opt = optim.make_optimizer(optim.trainable_by_path(model, HEAD), 1e-3,
                               betas=BETAS, weight_decay=L2)
    learner = CaeStepLearner(_loader(), None, model, opt, None, 1,
                             device="cpu")
    learner.augment = lambda batch: batch
    wide = torch.promote_types(dtype, torch.float32)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    metrics = learner.train_step(
        {KEY_IMAGES: None, KEY_LABELS: torch.from_numpy(labels).to(wide),
         KEY_GLOBAL: torch.from_numpy(clinical).to(wide)})
    return metrics, model, before


@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
def test_step_learner_train_step_matches_jax(step_variables, jax_step64,
                                             dtype):
    want_loss, grads64, want_stats = jax_step64
    tol_loss, tol_grad, _, tol_stats = _tols(dtype)
    metrics, model, before = _learner_step(step_variables,
                                           getattr(torch, dtype))
    assert abs(float(metrics["loss"]) - want_loss) <= tol_loss
    named = dict(model.named_parameters())
    buffers = dict(model.named_buffers())
    n_head = 0
    for path, key in _key_map(_config(True)):
        if path[0] != "params":
            np.testing.assert_allclose(buffers[key].double().numpy(),
                                       _leaf(want_stats, path[1:]),
                                       atol=tol_stats, rtol=0, err_msg=key)
            # all of the CAE runs in training mode: its statistics moved
            assert not np.array_equal(_leaf(step_variables, path),
                                      _leaf(want_stats, path[1:])), key
            continue
        p = named[key]
        if key.split(".")[1] in HEAD:
            n_head += 1
            ref = _leaf(grads64, path[1:])
            err = np.abs(p.grad.double().numpy() - ref).max()
            assert err <= tol_grad * np.abs(ref).max(), (key, err)
            assert float(np.abs(ref).max()) > 0, key
            assert not torch.equal(p.detach(), before[key]), key
        else:
            assert p.grad is None, key
            assert torch.equal(p.detach(), before[key]), key
    assert n_head == 6


def test_step_learner_check_sees_a_wrong_head_gradient(step_variables,
                                                       jax_step64):
    """Control: the float32 step's head gradients pass the check above and
    fail it with the step head's kernel gradient zeroed."""
    _, grads64, _ = jax_step64
    tol_grad = _tols("float32")[1]
    _, model, _ = _learner_step(step_variables, torch.float32)
    named = dict(model.named_parameters())
    for wrong in (False, True):
        bad = []
        for path, key in _key_map(_config(True)):
            if path[0] != "params" or key.split(".")[1] not in HEAD:
                continue
            got = named[key].grad.double().numpy()
            if wrong and key == "enc.step_head.kernel":
                got = np.zeros_like(got)
            ref = _leaf(grads64, path[1:])
            if np.abs(got - ref).max() > tol_grad * np.abs(ref).max():
                bad.append(key)
        assert bad == (["enc.step_head.kernel"] if wrong else [])


# --------------------------------------------------------------- the CLI

def _cli_args(*extra):
    return ["--synthetic", "--xyoriginal", "128", "--zsize", "28",
            "--channelscae", *map(str, CHANNELS), "--batchsize", "2",
            "--fold", "0", "1", "2", "3", "--validsetsize", "0.5",
            "--device", "cpu", "--dtype", "float32", *extra]


def write_phase1_cae(path, seed=0):
    """A phase-1 CAE ``.model`` (``Enc3D``, no step head) with random
    variables, written by the port."""
    model = Cae3D(Enc3D(CHANNELS, 5), Dec3D(CHANNELS, 5))
    model.load_state_dict(state_from_jax(_variables(False, seed),
                                         _config(False)))
    save_cae_checkpoint(path, model)


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """The step CLI on a phase-1 CAE for one epoch, float32, on 64 x 64 x
    28 synthetic masks."""
    out = tmp_path_factory.mktemp("cae_step")
    write_phase1_cae(str(out / "shape_cae1.model"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_common, "synthetic_cache_dir",
                   lambda: str(out / "port_cache"))
        base = str(out / "step")
        learner = step_cli.train(get_args_step_training(_cli_args(
            str(out / "shape_cae1.model"), "--epochs", "1",
            "--outbasepath", base)))
    return learner, base, out


def test_step_cli_trains_the_head_on_a_frozen_cae(cli_run):
    """The artifacts as the JAX CLI names them; the frozen parameters are
    the phase-1 CAE's bit for bit, its statistics moved; the head trained;
    the ``.model`` is an ``Enc3DStep`` CAE and the ``.optim`` the masked
    layout."""
    learner, base, out = cli_run
    assert learner.step_counts == {"train": 1, "eval": 1, "visual": 24}
    for suffix in ("_cae1step.model", "_cae1step.optim", "_cae1step.json",
                   "_cae1step_final.model", "_cae1step_1.png"):
        assert os.path.getsize(base + suffix) > 0, suffix
    phase1, _ = checkpoint.load_checkpoint(str(out / "shape_cae1.model"))
    final, config = checkpoint.load_checkpoint(base + "_cae1step_final.model")
    assert config == dict(_config(True))
    for path, key in _key_map(_config(True)):
        if key.split(".")[1] in HEAD:
            continue
        old, new = _leaf(phase1, path), _leaf(final, path)
        if path[0] == "params":
            np.testing.assert_array_equal(new, old, err_msg=key)
        elif key.endswith(".mean"):
            assert not np.array_equal(new, old), key
    opt, _ = checkpoint.load_checkpoint(base + "_cae1step.optim")
    inner = opt["opt_state"]["inner_state"]
    assert inner["1"] == {"inner_state": {}}
    mu = inner["0"]["inner_state"]["1"]["mu"]
    assert mu["enc"]["encoder"]["BnConvActBlock_0"]["Conv3d_0"][
        "kernel"] == {}
    assert np.abs(mu["enc"]["step_head"]["kernel"]).max() > 0


def test_step_snapshot_resumes_in_both_packages(cli_run, tmp_path, capsys,
                                                monkeypatch):
    """The port's best-valid snapshot in the JAX learner (its masked Adam
    state leaf for leaf), and the port's CLI resumed from it with a
    JAX-written ``.optim`` (optax's masked chain over the snapshot's
    parameters, two updates) for a second epoch."""
    learner, base, out = cli_run
    kw = dict(n_cases=4, shape_xyz=(64, 64, 28), seed=4)
    theirs = jax_dataset.StrokeDataset3D(
        jax_dataset.SyntheticCaseProvider(**kw),
        [jax_dataset.MOD_CBV, jax_dataset.MOD_TTD],
        [jax_dataset.LABEL_CORE, jax_dataset.LABEL_PENU,
         jax_dataset.LABEL_LESION])
    train, valid = jax_loader.get_stroke_shape_training_data(
        theirs, range(4), 0.5, seed=4, batchsize=2)
    ref = jax_cae_learners.CaeStepLearner(
        train, valid, _jax_model(True, jnp.float32),
        lambda params: jax_optim.make_optimizer(
            1e-3, betas=BETAS, weight_decay=L2,
            trainable_mask=jax_optim.trainable_mask_by_path(params, HEAD)),
        None, n_epochs=2, path_previous_base=base,
        path_outputs_base=str(tmp_path / "jax"),
        metrics_with_distances=False)
    saved, _ = checkpoint.load_checkpoint(base + "_cae1step.optim")
    flat_saved = dict(jax.tree_util.tree_leaves_with_path(
        saved["opt_state"]))
    flat_restored = jax.tree_util.tree_leaves_with_path(
        serialization.to_state_dict(ref._state.opt_state))
    assert len(flat_restored) == len(flat_saved) == 4 + 2 * 6
    for path, leaf in flat_restored:
        np.testing.assert_array_equal(np.asarray(leaf), flat_saved[path],
                                      err_msg=str(path))
    start = ref.get_start_epoch()
    assert start == 1

    snap, _ = checkpoint.load_checkpoint(base + "_cae1step.model")
    _, _, state, _ = _jax_masked_state(snap, steps=2)
    resume = tmp_path / "resume"
    for suffix in ("_cae1step.model", "_cae1step.json"):
        (tmp_path / ("resume" + suffix)).write_bytes(
            open(base + suffix, "rb").read())
    jax_checkpoint.save_checkpoint(str(resume) + "_cae1step.optim",
                                   {"opt_state": state})
    capsys.readouterr()
    monkeypatch.setattr(port_common, "synthetic_cache_dir",
                        lambda: str(out / "port_cache"))
    # the grids were checked with the first run
    monkeypatch.setattr(CaeStepLearner, "visualize_epoch", lambda *a: None)
    resumed = step_cli.train(get_args_step_training(_cli_args(
        str(out / "shape_cae1.model"), "--epochs", "2", "--inbasepath",
        str(resume), "--outbasepath", str(tmp_path / "resumed"))))
    printed = capsys.readouterr().out
    assert "Continue training" in printed
    assert "Epoch 2/2 training loss: " in printed
    assert "Epoch 1/2" not in printed
    assert resumed.step_counts["train"] == 1
    head = resumed._model.enc.step_head.kernel
    # the JAX state's step count went on, from its two updates
    assert float(resumed._optimizer.state[head]["step"]) == 2 + 1


def test_step_training_args_match_jax(monkeypatch):
    monkeypatch.setattr("sys.argv", ["prog", "cae.model", "--synthetic"])
    want = vars(jax_args.get_args_step_training())
    got = vars(get_args_step_training(["cae.model", "--synthetic",
                                       "--device", "cpu"]))
    assert got.pop("device") == "cpu"
    assert got == want
    assert get_args_step_training(["cae.model"]).device == "cuda"
