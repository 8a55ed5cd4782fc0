"""Port parity for the CAE training slice around the step: the elastic warp
(ops/warp.py), the flip and the elastic deformation (data/augment.py), the
monotonicity hinge, the beta1 ramp and the loss curriculum, Adam across the
ramp, the loaders without a validation split, the CAE's Adam state in both
directions, and the training CLI end to end on the CPU, each against the
JAX package on the CPU.  ``tests/test_torch_cae_train_step.py`` holds the
step itself.

The deterministic cores get the JAX package's random numbers (its noise,
its flip mask, its per-sample fields) and agree within 1e-6; the samplers
are checked by distribution.  Adam within 1e-7 plus one float32 ulp, as
the U-Net's."""

import os
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from stroke_prediction_tpu.data import augment as jax_augment
from stroke_prediction_tpu.data import dataset as jax_dataset
from stroke_prediction_tpu.data import loader as jax_loader
from stroke_prediction_tpu.eval import metrics as jax_metrics
from stroke_prediction_tpu.models import cae3d as jax_cae3d
from stroke_prediction_tpu.ops import warp as jax_warp
from stroke_prediction_tpu.train import cae_learners as jax_cae_learners
from stroke_prediction_tpu.train import checkpoint as jax_checkpoint
from stroke_prediction_tpu.train import optim as jax_optim
from stroke_prediction_tpu.train.learner import TrainState
from stroke_prediction_tpu.train.unet_learner import (
    _measures_dict as jax_measures_dict)
from stroke_prediction_tpu.utils import args as jax_args
from stroke_prediction_tpu_torch.cli import common as port_common
from stroke_prediction_tpu_torch.cli import train_shape_reconstruction as cli
from stroke_prediction_tpu_torch.data import augment, dataset
from stroke_prediction_tpu_torch.data.loader import (
    get_stroke_shape_training_data, get_testdata)
from stroke_prediction_tpu_torch.eval.cae_tester import (
    CaeReconstructionTester)
from stroke_prediction_tpu_torch.eval.metrics import monotonicity_hinge
from stroke_prediction_tpu_torch.models.cae3d import Cae3D, Dec3D, Enc3D
from stroke_prediction_tpu_torch.models.convert import (
    _key_map, adam_state_from_jax, adam_state_to_jax, state_from_jax)
from stroke_prediction_tpu_torch.ops import warp
from stroke_prediction_tpu_torch.train import optim
from stroke_prediction_tpu_torch.train.cae_learners import (
    CaeReconstructionLearner)
from stroke_prediction_tpu_torch.utils import checkpoint
from stroke_prediction_tpu_torch.utils.args import get_args_shape_training

from test_torch_train import ULP, _leaf
from test_torch_unet import _random_variables

torch.set_num_threads(1)

CHANNELS = (1, 2, 3, 4, 5, 6, 1)
CONFIG = {"kind": "cae3d", "channels": list(CHANNELS), "n_ch_global": 5,
          "step": False}
LABELS = [dataset.LABEL_CORE, dataset.LABEL_PENU, dataset.LABEL_LESION]
MODS = [dataset.MOD_CBV, dataset.MOD_TTD]
BETAS, L2 = (0.9, 0.999), 1e-5
EPOCHS = (0, 1, 2, 3, 4, 5, 25, 26, 50, 60)
TOL = dict(atol=1e-6, rtol=0)


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------------- warp

@pytest.mark.parametrize("sigma", [4.0, 1.5, 0.7])
def test_gaussian_kernel1d_matches_jax(sigma):
    got = warp.gaussian_kernel1d(sigma)
    want = np.asarray(jax_warp.gaussian_kernel1d(sigma))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("shape,axes", [((3, 9, 12, 40), (1, 2, 3)),
                                        ((20, 7, 11), None)])
def test_gaussian_filter3d_matches_jax(shape, axes):
    """Axes shorter than the kernel (radius 16 at sigma 4) and longer."""
    x = np.random.RandomState(0).uniform(-1, 1, shape).astype(np.float32)
    want = np.asarray(jax_warp.gaussian_filter3d(jnp.asarray(x), 4.0,
                                                 axes=axes))
    got = warp.gaussian_filter3d(_t(x), 4.0, axes=axes).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_map_coordinates_linear_matches_jax():
    """Interior points, points on the last plane, row and column, on the
    first, just outside (cval outright) and far outside."""
    d, h, w = 7, 9, 11
    rs = np.random.RandomState(1)
    vol = rs.rand(d, h, w).astype(np.float32)
    pts = [rs.uniform(-1.5, [d + 0.5, h + 0.5, w + 0.5], (200, 3)),
           [[d - 1, h - 1, w - 1], [d - 1, 3.5, 2.25], [2.5, h - 1, 4.0],
            [1.0, 2.0, w - 1], [0, 0, 0], [-1e-4, 2, 2], [d - 1 + 1e-4, 2, 2],
            [3, -0.5, 5], [3, 4, w - 0.999], [-40, 50, 3]]]
    coords = np.concatenate(pts).astype(np.float32).T.reshape(3, 21, 10)
    for cval in (0.0, -2.5):
        want = np.asarray(jax_warp.map_coordinates_linear(
            jnp.asarray(vol), jnp.asarray(coords), cval))
        got = warp.map_coordinates_linear(_t(vol), _t(coords), cval).numpy()
        assert got.shape == (21, 10)
        np.testing.assert_allclose(got, want, **TOL)
        assert (want == cval).sum() > 10


def _jax_noise(key, shape):
    return np.asarray(jax.random.uniform(key, (3,) + shape, minval=-1.0,
                                         maxval=1.0))


def test_elastic_fields_core_matches_jax():
    """The same noise gives JAX's fields: the blur, alpha and the depth
    field's 0.22."""
    key, shape = jax.random.PRNGKey(3), (12, 40, 36)
    want = np.asarray(jax_warp.elastic_fields(key, shape))
    got = warp.elastic_fields(_t(_jax_noise(key, shape))).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert np.abs(want[0]).max() < 0.3 * np.abs(want[1]).max()


def test_elastic_deform_batch_matches_jax():
    """JAX's per-sample fields (its key split) fed to the port's core: the
    same deformed labels, one field shared by a sample's channels.  (Fields
    computed by each package differ in their last bits, and a coordinate
    near 40 moves by 4e-6 a bit: the core is held on the same fields.)"""
    key = jax.random.PRNGKey(7)
    rs = np.random.RandomState(2)
    labels = (rs.rand(2, 12, 40, 36, 3) > 0.5).astype(np.float32)
    want, _ = jax_augment.elastic_deform_batch(key, jnp.asarray(labels))
    fields = np.stack([np.asarray(jax_warp.elastic_fields(
        k, labels.shape[1:4])) for k in jax.random.split(key, 2)])
    got = augment.elastic_deform_batch(_t(labels), _t(fields))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert np.abs(got.numpy() - labels).max() > 0.5       # it moved


def test_hemispheric_flip_matches_jax():
    key = jax.random.PRNGKey(5)
    rs = np.random.RandomState(3)
    images = rs.rand(6, 4, 5, 7, 2).astype(np.float32)
    labels = rs.rand(6, 4, 5, 7, 3).astype(np.float32)
    want_i, want_l = jax_augment.random_hemispheric_flip(
        key, jnp.asarray(images), jnp.asarray(labels))
    flip = _t(jax.random.bernoulli(key, 0.5, (6,)))
    assert 0 < int(flip.sum()) < 6
    np.testing.assert_array_equal(
        augment.hemispheric_flip(_t(images), flip).numpy(),
        np.asarray(want_i))
    np.testing.assert_array_equal(
        augment.hemispheric_flip(_t(labels), flip).numpy(),
        np.asarray(want_l))


def test_samplers_by_distribution():
    """uniform[-1, 1) noise: its range and mean; the flip: p = 0.5 over
    4000 draws (4 sigma); the CAE augmentation reproducible from the
    generator's seed."""
    gen = torch.Generator().manual_seed(0)
    noise = warp.elastic_noise(gen, 2, (28, 64, 64))
    assert noise.shape == (2, 3, 28, 64, 64)
    assert -1.0 <= float(noise.min()) < -0.999
    assert 0.999 < float(noise.max()) < 1.0
    assert abs(float(noise.mean())) < 4 * (1 / 3 / noise.numel()) ** 0.5
    assert abs(float(noise.var()) - 1 / 3) < 1e-2
    flips = augment.random_flip_mask(gen, 4000)
    assert flips.dtype == torch.bool
    assert abs(float(flips.float().mean()) - 0.5) < 4 * 0.5 / 4000 ** 0.5

    labels = (torch.rand((2, 28, 64, 64, 3), generator=gen) > 0.5).float()
    runs = [augment.random_cae_augment(torch.Generator().manual_seed(9),
                                       labels) for _ in range(2)]
    torch.testing.assert_close(runs[0], runs[1], atol=0, rtol=0)
    assert float((runs[0] - labels).abs().max()) > 0.5


# ----------------------------------------------- loss terms and schedules

def test_monotonicity_hinge_matches_jax():
    d = np.random.RandomState(4).uniform(-1, 1, (2, 5, 6, 7, 1)).astype(
        np.float32)
    assert float(monotonicity_hinge(_t(d))) == pytest.approx(
        float(jax_metrics.monotonicity_hinge(jnp.asarray(d))), rel=1e-6)


@pytest.mark.parametrize("epoch", EPOCHS)
def test_beta1_ramp_and_loss_factor_match_jax(epoch):
    assert optim.beta1_ramp(0.9, epoch, 4) == pytest.approx(
        jax_optim.beta1_ramp(0.9, epoch, 4), abs=1e-12)
    assert CaeReconstructionLearner.loss_factor(None, epoch) == \
        jax_cae_learners.CaeReconstructionLearner.loss_factor(None, epoch)


def test_adam_across_the_beta1_ramp_matches_optax():
    """Two steps an epoch at epochs 0-5 on the same gradients, beta1 set by
    each learner's ``adapt_betas``: the JAX learner's through
    ``set_hyperparams`` on optax's injected hyperparameters, the port's on
    ``torch.optim.Adam``'s param groups."""
    rs = np.random.RandomState(6)
    params = {"a": rs.randn(3, 4).astype(np.float32),
              "b": rs.randn(5).astype(np.float32)}
    grads = [{k: rs.randn(*v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(12)]
    tx = jax_optim.make_optimizer(1e-3, betas=BETAS, weight_decay=L2)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    ref = types.SimpleNamespace(
        N_EPOCHS_ADAPT_BETA1=4, _base_b1=BETAS[0], _base_b2=BETAS[1],
        _state=TrainState(params=jp, batch_stats={}, opt_state=tx.init(jp),
                          step=0))
    tp = {k: torch.nn.Parameter(_t(v).clone()) for k, v in params.items()}
    opt = optim.make_optimizer(tp.values(), 1e-3, betas=BETAS,
                               weight_decay=L2)
    port = types.SimpleNamespace(N_EPOCHS_ADAPT_BETA1=4, _base_betas=BETAS,
                                 _optimizer=opt)
    for epoch in range(6):
        jax_cae_learners.CaeReconstructionLearner.adapt_betas(ref, epoch)
        CaeReconstructionLearner.adapt_betas(port, epoch)
        assert opt.param_groups[0]["betas"][0] == pytest.approx(
            float(ref._state.opt_state.hyperparams["b1"]), abs=1e-7)
        for g in grads[2 * epoch:2 * epoch + 2]:
            updates, state = tx.update(g, ref._state.opt_state, jp)
            jp = optax.apply_updates(jp, updates)
            ref._state = ref._state.replace(params=jp, opt_state=state)
            for k, p in tp.items():
                p.grad = _t(g[k]).clone()
            opt.step()
        for k, p in tp.items():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jp[k]), atol=1e-7,
                                       rtol=ULP, err_msg=f"{k} {epoch}")


# ------------------------------------------------- loaders and Adam state

def _datasets(n_cases=6):
    kw = dict(n_cases=n_cases, shape_xyz=(64, 64, 28), seed=4)
    return (dataset.StrokeDataset3D(dataset.SyntheticCaseProvider(**kw),
                                    MODS, LABELS),
            jax_dataset.StrokeDataset3D(
                jax_dataset.SyntheticCaseProvider(**kw), MODS, LABELS))


@pytest.mark.parametrize("split", [True, False])
def test_training_loaders_split_matches_jax(split):
    ours, theirs = _datasets()
    a = get_stroke_shape_training_data(ours, range(6), 0.34, seed=5,
                                       batchsize=2, split=split)
    b = jax_loader.get_stroke_shape_training_data(
        theirs, range(6), 0.34, seed=5, batchsize=2, split=split)
    assert list(a[0].indices) == list(b[0].indices)
    assert a[0].epoch_chunks() == b[0].epoch_chunks()
    if split:
        assert list(a[1].indices) == list(b[1].indices)
    else:
        assert a[1] is None and b[1] is None
        assert sorted(a[0].indices) == list(range(6))


def _jax_cae():
    return jax_cae3d.Cae3D(enc=jax_cae3d.Enc3D(channels=CHANNELS,
                                               n_ch_global=5),
                           dec=jax_cae3d.Dec3D(channels=CHANNELS,
                                               n_ch_global=5))


def _port_cae(variables):
    model = Cae3D(Enc3D(CHANNELS), Dec3D(CHANNELS))
    model.load_state_dict(state_from_jax(variables, CONFIG))
    return model


def test_cae_optimizer_state_from_jax_round_trip(tmp_path):
    """A JAX ``.optim`` of a CAE (optax after one update) loads into the
    port's Adam and comes back leaf for leaf and byte for byte; one more
    step from it agrees with optax."""
    from stroke_prediction_tpu.inference import (
        cae_dto_from_batch as jax_dto)
    from stroke_prediction_tpu.core.dto import BRANCH_GTRUTH

    dto = jax_dto(None, jnp.zeros((1, 28, 64, 64, 3)), jnp.ones((1, 5)))
    shapes = jax.eval_shape(lambda: _jax_cae().init(
        jax.random.PRNGKey(0), dto, BRANCH_GTRUTH, False))
    variables = _random_variables(shapes, np.random.RandomState(0))
    rs = np.random.RandomState(1)
    grads = jax.tree_util.tree_map(
        lambda a: rs.randn(*a.shape).astype(np.float32),
        variables["params"])
    tx = jax_optim.make_optimizer(1e-3, betas=BETAS, weight_decay=L2)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = jax_optim.set_hyperparams(tx.init(params), b1=0.6)
    updates, state = tx.update(grads, state, params)
    params = optax.apply_updates(params, updates)
    jax_path = str(tmp_path / "jax.optim")
    jax_checkpoint.save_checkpoint(jax_path, {"opt_state": state})

    port = _port_cae({"params": jax.tree_util.tree_map(np.asarray, params),
                      "batch_stats": variables["batch_stats"]})
    opt = optim.make_optimizer(port.parameters(), 5e-1, betas=(0.5, 0.999),
                               weight_decay=L2)
    loaded, _ = checkpoint.load_checkpoint(jax_path)
    opt.load_state_dict(adam_state_from_jax(loaded["opt_state"], port, opt))
    assert opt.param_groups[0]["betas"][0] == pytest.approx(0.6)
    back = adam_state_to_jax(opt, port)
    flat_want = jax.tree_util.tree_leaves_with_path(
        serialization.to_state_dict(state))
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_want) == len(flat_back) > 2 * len(list(port.parameters()))
    for path, leaf in flat_want:
        np.testing.assert_array_equal(flat_back[path], np.asarray(leaf),
                                      err_msg=str(path))
    port_path = str(tmp_path / "port.optim")
    checkpoint.save_checkpoint(port_path, {"opt_state": back})
    with open(jax_path, "rb") as a, open(port_path, "rb") as b:
        assert a.read() == b.read()

    updates, state = tx.update(grads, state, params)
    params = optax.apply_updates(params, updates)
    named = dict(port.named_parameters())
    keys = [(path[1:], k) for path, k in _key_map(CONFIG)
            if path[0] == "params"]
    for path, k in keys:
        named[k].grad = _t(_leaf(grads, path).copy())
    opt.step()
    for path, k in keys:
        np.testing.assert_allclose(named[k].detach().numpy(),
                                   _leaf(params, path), atol=1e-7,
                                   rtol=ULP, err_msg=k)


# ------------------------------------------------------------- the CLI

def _epoch_lines(out):
    return re.findall(r"^Epoch (\d+)/(\d+) (training|validate) loss: ", out,
                      re.M)


def _cli_args(tmp_path, *extra):
    return ["--synthetic", "--xyoriginal", "128", "--zsize", "28",
            "--channelscae", *map(str, CHANNELS), "--batchsize", "2",
            "--fold", "0", "1", "2", "3", "4", "5", "--validsetsize", "0.34",
            "--device", "cpu", *extra]


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """The port's CAE training CLI, two epochs in float32 on 64 x 64 x 28
    synthetic masks."""
    out = tmp_path_factory.mktemp("cae_train")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_common, "synthetic_cache_dir",
                   lambda: str(out / "port_cache"))
        base = str(out / "shape")
        learner = cli.train(get_args_shape_training(_cli_args(
            out, "--epochs", "2", "--dtype", "float32", "--outbasepath",
            base)))
    return learner, base, out


def test_cli_trains_cae_end_to_end_on_cpu(cli_run):
    """The artifacts, the curves with the JAX learner's keys, and the
    best-valid model in the port's CAE tester."""
    learner, base, out = cli_run
    assert learner.step_counts["train"] == 2 * 2     # 4 cases, batch 2
    assert learner.step_counts["eval"] == 2
    for suffix in ("_cae1.model", "_cae1.optim", "_cae1.json",
                   "_cae1_final.model", "_cae1_1.png", "_cae1_2.png",
                   "_cae1_plots.png"):
        assert os.path.getsize(base + suffix) > 0, suffix
    curves = checkpoint.load_curves(base + "_cae1.json")
    m = jax_metrics.binary_measures(jnp.ones((2, 2)), jnp.ones((2, 2)),
                                    with_distances=False)
    want = {"loss"} | {k for name in ("lesion", "core", "penu")
                       for k in jax_measures_dict(name, m)}
    for phase in ("training", "validate"):
        assert len(curves[phase]) >= 1
        for entry in curves[phase]:
            assert set(entry) == want
    assert np.isfinite(curves["validate"][0]["lesion_assd"])
    assert curves["training"][0]["lesion_assd"] == float("inf")

    ds, _ = _datasets(3)
    tester = CaeReconstructionTester(get_testdata(ds, [0], shuffle=False),
                                     base + "_cae1.model", str(out / "t"),
                                     10, device="cpu")
    metrics, dto = tester.infer_batch(ds.stack([0]))
    assert dto.reconstructions.gtruth.interpolation.shape == (1, 28, 64, 64,
                                                              1)
    assert 0.0 <= metrics["lesion"].dc <= 1.0


def test_port_cae_snapshot_resumes_in_both_packages(cli_run, tmp_path,
                                                    capsys, monkeypatch):
    """The port's best-valid snapshot (``.model``, ``.optim``, ``.json``):
    the JAX learner's ``load_training`` restores the port's Adam state leaf
    for leaf, and the port's CLI resumes from it for a third epoch."""
    learner, base, out = cli_run
    _, theirs = _datasets(4)
    train, valid = jax_loader.get_stroke_shape_training_data(
        theirs, range(4), 0.5, seed=4, batchsize=2)
    ref = jax_cae_learners.CaeReconstructionLearner(
        train, valid, _jax_cae(),
        jax_optim.make_optimizer(1e-3, betas=BETAS, weight_decay=L2), None,
        n_epochs=3, path_previous_base=base, path_outputs_base=str(
            tmp_path / "jax"), metrics_with_distances=False)
    saved, _ = checkpoint.load_checkpoint(base + "_cae1.optim")
    restored = serialization.to_state_dict(ref._state.opt_state)
    flat_saved = dict(jax.tree_util.tree_leaves_with_path(
        saved["opt_state"]))
    flat_restored = jax.tree_util.tree_leaves_with_path(restored)
    assert len(flat_restored) == len(flat_saved)
    for path, leaf in flat_restored:
        np.testing.assert_array_equal(np.asarray(leaf), flat_saved[path],
                                      err_msg=str(path))
    assert int(ref._state.opt_state.count) > 0
    assert ref.get_start_epoch() == len(
        checkpoint.load_curves(base + "_cae1.json")["training"])
    capsys.readouterr()

    monkeypatch.setattr(port_common, "synthetic_cache_dir",
                        lambda: str(out / "port_cache"))
    resumed = cli.train(get_args_shape_training(_cli_args(
        out, "--epochs", "3", "--dtype", "float32", "--inbasepath", base,
        "--outbasepath", str(tmp_path / "resumed"))))
    printed = capsys.readouterr().out
    assert "Continue training" in printed
    start = ref.get_start_epoch()
    assert _epoch_lines(printed)[0] == (str(start + 1), "3", "training")
    assert resumed.step_counts["train"] == 2 * (3 - start)


def test_cli_steplearning_trains_without_validation(tmp_path, capsys,
                                                    monkeypatch):
    """``--steplearning``: an Enc3DStep on every fold case, no validation
    loader, its head kept (and decayed by Adam's L2 term, as optax does)
    with the time given; the default bfloat16."""
    monkeypatch.setattr(port_common, "synthetic_cache_dir",
                        lambda: str(tmp_path / "port_cache"))
    base = str(tmp_path / "step")
    learner = cli.train(get_args_shape_training(_cli_args(
        tmp_path, "--epochs", "1", "--steplearning", "--outbasepath",
        base)))
    printed = capsys.readouterr().out
    assert "Size training set: 6 samples | Size validation set: 0" in printed
    assert learner._dataloader_validation is None
    # three grids (the optimum, epoch 0, the end) of three samples, two
    # forwards each
    assert learner.step_counts == {"train": 3, "eval": 0, "visual": 18}
    assert learner._model.enc.encoder.compute_dtype == torch.bfloat16
    state, config = checkpoint.load_checkpoint(base + "_cae1_final.model")
    assert config == dict(CONFIG, step=True)
    head = state["params"]["enc"]["step_head"]["kernel"]
    assert np.abs(head).max() > 0
    opt = learner._optimizer.state[learner._model.enc.step_head.kernel]
    assert float(opt["exp_avg"].abs().max()) > 0


def test_shape_training_args_match_jax(monkeypatch):
    monkeypatch.setattr("sys.argv", ["prog", "--synthetic"])
    want = vars(jax_args.get_args_shape_training())
    got = vars(get_args_shape_training(["--synthetic", "--device", "cpu"]))
    assert got.pop("device") == "cpu"
    assert got == want
    assert get_args_shape_training([]).device == "cuda"
