"""Port parity for the U-Net training slice: BN in training mode, the patch
crop, the training loaders, one full training step of ``Unet3D`` (loss,
every parameter gradient, the new running statistics), Adam against optax
on the same gradients, the optimizer state and the curves carried across,
a bfloat16 forward + loss, and the training CLI end to end, each against
the JAX package on the CPU (the ``lax2d`` conv path; pooling through its
equality-mask backward).

Tolerances: the training step against JAX in float64 (see the test for why
not against JAX float32): in float64, loss and running statistics 1e-12 and
gradients 1e-7 * max |ref| per tensor; in float32, loss and running
statistics 1e-6 and gradients 5e-5 * max |ref| (BN folded into the conv on
the port, applied before it in JAX, and float32 sums in another order).
Adam 1e-7 plus one float32 ulp of the parameter (the same update, rounded
in another order).  bfloat16 loss 2e-2 (the two packages round to bfloat16
at different places)."""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from stroke_prediction_tpu.cli import common as jax_common
from stroke_prediction_tpu.cli import test_unet_segmentation as jax_test_cli
from stroke_prediction_tpu.data import dataset as jax_dataset
from stroke_prediction_tpu.data import loader as jax_loader
from stroke_prediction_tpu.data.augment import random_patch
from stroke_prediction_tpu.eval import metrics as jax_metrics
from stroke_prediction_tpu.eval.metrics import (
    batch_dice_loss as jax_batch_dice_loss)
from stroke_prediction_tpu.models import layers as jax_layers
from stroke_prediction_tpu.models import unet3d as jax_unet3d
from stroke_prediction_tpu.models.layers import BatchNorm as JaxBatchNorm
from stroke_prediction_tpu.models.unet3d import Unet3D as JaxUnet3D
from stroke_prediction_tpu.train import checkpoint as jax_checkpoint
from stroke_prediction_tpu.train.optim import make_optimizer as jax_optimizer
from stroke_prediction_tpu.train.optim import multistep_lr as jax_multistep
from stroke_prediction_tpu.train.optim import set_hyperparams
from stroke_prediction_tpu.utils.args import UnetParser as JaxUnetParser
from stroke_prediction_tpu_torch.cli import common as port_common
from stroke_prediction_tpu_torch.cli import test_unet_segmentation as \
    port_test_cli
from stroke_prediction_tpu_torch.cli import train_unet_segmentation as \
    train_cli
from stroke_prediction_tpu_torch.data import dataset
from stroke_prediction_tpu_torch.data.augment import crop_patch
from stroke_prediction_tpu_torch.data.loader import (
    get_stroke_shape_training_data)
from stroke_prediction_tpu_torch.eval.metrics import batch_dice_loss
from stroke_prediction_tpu_torch.models.convert import (
    _unet_key_map, adam_state_from_jax, adam_state_to_jax,
    unet_state_from_jax)
from stroke_prediction_tpu_torch.models.layers import BatchNorm
from stroke_prediction_tpu_torch.models.unet3d import Unet3D
from stroke_prediction_tpu_torch.train.optim import (
    make_optimizer, multistep_lr, set_learning_rate)
from stroke_prediction_tpu_torch.utils import checkpoint
from stroke_prediction_tpu_torch.utils.args import get_args_unet_training

torch.set_num_threads(1)

CHANNELS = (2, 4, 6, 8, 6, 4, 6, 2)
PATCH, PAD = (44, 44, 44), (20, 20, 20)
BETAS, L2 = (0.99, 0.999), 1e-5
ULP = 2.0 ** -23          # one float32 ulp, relative


def _random_variables(tree, rs, path=()):
    """Random flax variables: torch-style uniform conv weights and
    non-trivial BN parameters and running statistics."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _random_variables(v, rs, path + (k,))
            continue
        if k == "var":
            a = rs.uniform(0.5, 1.5, v.shape)
        elif k == "scale":
            a = rs.uniform(0.7, 1.3, v.shape)
        elif "BatchNorm_0" in path:                      # mean, bias
            a = rs.uniform(-0.3, 0.3, v.shape)
        else:                                            # conv kernel, bias
            a = rs.uniform(-1, 1, v.shape) / np.sqrt(
                np.prod(tree["kernel"].shape[:-1]))
        out[k] = a.astype(np.float32)
    return out


def _leaf(tree, path):
    for p in path:
        tree = tree[p]
    return np.asarray(tree)


def _batch(seed=0):
    """A (2, 50, 48, 46, 2) image batch with its label volumes and the
    patch offsets drawn the JAX way (``random_patch``'s key split)."""
    rs = np.random.RandomState(seed)
    images = (rs.rand(2, 50, 48, 46, 2) * 4).astype(np.float32)
    labels = (rs.rand(2, 10, 8, 6, 2) > 0.5).astype(np.float32)
    return images, labels, jax.random.PRNGKey(seed)


def _jax_offsets(key, images, patch_whd):
    w, h, d = patch_whd
    b, sd, sh, sw = images.shape[:4]
    kx, ky, kz = jax.random.split(key, 3)
    cols = [jax.random.randint(kz, (b,), 0, sd - d + 1),
            jax.random.randint(ky, (b,), 0, sh - h + 1),
            jax.random.randint(kx, (b,), 0, sw - w + 1)]
    return torch.from_numpy(np.stack([np.asarray(c) for c in cols], 1))


@pytest.fixture(scope="module")
def variables():
    shapes = jax.eval_shape(lambda: JaxUnet3D(channels=CHANNELS).init(
        jax.random.PRNGKey(0), jnp.zeros((1,) + PATCH + (2,)), train=False))
    return _random_variables(shapes, np.random.RandomState(0))


def _jax_loss(seg, labels):
    return (jax_batch_dice_loss(seg[..., 0:1], labels[..., 0:1])
            + jax_batch_dice_loss(seg[..., 1:2], labels[..., 1:2])) / 2.0


def _port_loss(seg, labels):
    return (batch_dice_loss(seg[..., 0:1], labels[..., 0:1])
            + batch_dice_loss(seg[..., 1:2], labels[..., 1:2])) / 2.0


class _Float64Numpy:
    """``jax.numpy`` with ``float32`` read as ``float64``.  Put in place of
    the ``jnp`` of the JAX modules on the U-Net's lax2d path (with x64 on),
    it runs their float32 casts (BN moments, sigmoid, Dice) in float64; the
    JAX package itself is unchanged."""

    def __getattr__(self, name):
        return getattr(jnp, "float64" if name == "float32" else name)


def _jax_train_step(variables, imgs, labs, dtype):
    """value_and_grad of the learner's loss at train=True (lax2d path)
    -> (loss, grads, new batch_stats), numpy leaves."""
    model = JaxUnet3D(channels=CHANNELS, compute_dtype=dtype)

    @jax.jit
    def step(params, batch_stats, imgs, labs):
        def loss_fn(p):
            seg, mut = model.apply({"params": p, "batch_stats": batch_stats},
                                   imgs, train=True, mutable=["batch_stats"])
            return _jax_loss(seg, labs), mut
        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    cast = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda a: jnp.asarray(a, dtype), t)
    (loss, mut), grads = step(cast(variables["params"]),
                              cast(variables["batch_stats"]),
                              jnp.asarray(imgs, dtype),
                              jnp.asarray(labs, dtype))
    return (float(loss), jax.tree_util.tree_map(np.asarray, grads),
            jax.tree_util.tree_map(np.asarray, mut["batch_stats"]))


@pytest.fixture(scope="module")
def jax_step(variables):
    """JAX in float32 on the cropped batch -> (images, labels, loss, grads,
    new batch_stats)."""
    images, labels, key = _batch()
    imgs, labs = random_patch(key, jnp.asarray(images), jnp.asarray(labels),
                              PATCH, PAD)
    imgs, labs = np.asarray(imgs), np.asarray(labs)
    return (imgs, labs) + _jax_train_step(variables, imgs, labs,
                                          jnp.float32)


@pytest.fixture(scope="module")
def jax_step64(variables, jax_step):
    """The same JAX step in float64: (loss, grads, new batch_stats)."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jax_layers, jax_unet3d, jax_metrics):
            mp.setattr(mod, "jnp", _Float64Numpy())
        jax.config.update("jax_enable_x64", True)
        try:
            return _jax_train_step(variables, jax_step[0], jax_step[1],
                                   jnp.float64)
        finally:
            jax.config.update("jax_enable_x64", False)


def test_batchnorm_train_mode_matches_jax():
    rs = np.random.RandomState(2)
    x = (rs.rand(2, 5, 6, 7, 3) * 2 - 1).astype(np.float32)
    bn = JaxBatchNorm()
    v = bn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    v = _random_variables(v, rs, ("BatchNorm_0",))
    want, mut = bn.apply(v, jnp.asarray(x), use_running_average=False,
                         mutable=["batch_stats"])

    port = BatchNorm(3).train()
    with torch.no_grad():
        for name in ("scale", "bias"):
            getattr(port, name).copy_(torch.from_numpy(
                _leaf(v, ("params", "BatchNorm_0", name))))
        for name in ("mean", "var"):
            getattr(port, name).copy_(torch.from_numpy(
                _leaf(v, ("batch_stats", "BatchNorm_0", name))))
    xt = torch.from_numpy(x)
    s, t = port.affine(xt)
    np.testing.assert_allclose((xt * s + t).detach().numpy(),
                               np.asarray(want), atol=1e-6, rtol=0)
    for name in ("mean", "var"):
        np.testing.assert_allclose(
            getattr(port, name).numpy(),
            _leaf(mut, ("batch_stats", "BatchNorm_0", name)),
            atol=1e-6, rtol=0)


def test_crop_patch_matches_jax_random_patch():
    rs = np.random.RandomState(4)
    images = rs.rand(3, 11, 13, 15, 2).astype(np.float32)
    labels = rs.rand(3, 9, 7, 11, 2).astype(np.float32)
    patch, pad = (9, 8, 7), (2, 3, 1)                  # (x, y, z)
    key = jax.random.PRNGKey(11)
    want_i, want_l = random_patch(key, jnp.asarray(images),
                                  jnp.asarray(labels), patch, pad)
    got_i, got_l = crop_patch(torch.from_numpy(images),
                              torch.from_numpy(labels),
                              _jax_offsets(key, images, patch), patch, pad)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))


# (loss, grad / max|ref|, batch_stats) against JAX float64, per compute type
TRAIN_STEP_TOL = {"float64": (1e-12, 1e-7, 1e-12),
                  "float32": (1e-6, 5e-5, 1e-6)}


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_unet_train_step_matches_jax(variables, jax_step, jax_step64, dtype):
    """One training step from the same variables on the same crop: the loss,
    all 44 parameter gradients and the new running statistics.

    Both compute types are held to JAX run in float64: JAX's own float32
    step on the CPU is off the float64 one by up to 5e-2 * max|ref| in the
    gradients and 2e-6 in the running means (XLA sums the BN moments over
    1.5e5 voxels in sequence in float32, and the E[x^2] - E[x]^2 variance
    amplifies that), so it cannot check the port's float32 step, which
    stays within 2e-5 * max|ref| and 2e-7."""
    imgs, labs = jax_step[:2]
    want_loss, grads64, want_stats = jax_step64
    tol_loss, tol_grad, tol_stats = TRAIN_STEP_TOL[dtype]
    images, labels, key = _batch()
    got_i, got_l = crop_patch(torch.from_numpy(images),
                              torch.from_numpy(labels),
                              _jax_offsets(key, images, PATCH), PATCH, PAD)
    np.testing.assert_array_equal(got_i.numpy(), imgs)
    np.testing.assert_array_equal(got_l.numpy(), labs)

    dt = getattr(torch, dtype)
    port = Unet3D(CHANNELS, compute_dtype=dt).train()
    port.load_state_dict(unet_state_from_jax(variables))
    port.to(dt)
    loss = _port_loss(port(got_i), got_l.to(dt))
    loss.backward()
    assert abs(float(loss.detach()) - want_loss) <= tol_loss
    named = dict(port.named_parameters())
    buffers = dict(port.named_buffers())
    n_grads = 0
    for path, key_ in _unet_key_map():
        if path[0] == "params":
            ref = _leaf(grads64, path[1:])
            got = named[key_].grad.double().numpy()
            err = np.abs(got - ref).max()
            assert err <= tol_grad * np.abs(ref).max(), (key_, err)
            n_grads += 1
        else:
            np.testing.assert_allclose(buffers[key_].double().numpy(),
                                       _leaf(want_stats, path[1:]),
                                       atol=tol_stats, rtol=0, err_msg=key_)
    assert n_grads == len(named) == 44


def test_adam_matches_optax_on_the_same_grads(variables, jax_step):
    """Two steps at the lr that ``multistep_lr`` gives for epoch 1 with a
    milestone at 1, on the JAX step's gradients."""
    grads = jax_step[3]
    lr = multistep_lr(1e-3, [1])(1)
    assert lr == jax_multistep(1e-3, [1])(1)
    tx = jax_optimizer(1e-3, betas=BETAS, weight_decay=L2)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = set_hyperparams(tx.init(params), learning_rate=lr)

    port = Unet3D(CHANNELS)
    port.load_state_dict(unet_state_from_jax(variables))
    opt = make_optimizer(port.parameters(), 1e-3, betas=BETAS,
                         weight_decay=L2)
    set_learning_rate(opt, lr)
    named = dict(port.named_parameters())
    keys = [(path[1:], k) for path, k in _unet_key_map()
            if path[0] == "params"]
    for _ in range(2):
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        for path, k in keys:
            named[k].grad = torch.from_numpy(_leaf(grads, path).copy())
        opt.step()
    for path, k in keys:
        np.testing.assert_allclose(named[k].detach().numpy(),
                                   _leaf(params, path), atol=1e-7,
                                   rtol=ULP, err_msg=k)


def test_optimizer_state_round_trip(variables, jax_step, tmp_path):
    """A JAX ``.optim`` loads into the port's Adam and comes back leaf for
    leaf (and byte for byte); one more step from it agrees with optax."""
    grads = jax_step[3]
    tx = jax_optimizer(1e-3, betas=BETAS, weight_decay=L2)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = tx.init(params)
    updates, state = tx.update(grads, state, params)
    params = optax.apply_updates(params, updates)
    jax_path = str(tmp_path / "jax.optim")
    jax_checkpoint.save_checkpoint(jax_path, {"opt_state": state})

    port = Unet3D(CHANNELS)
    port.load_state_dict(unet_state_from_jax(
        {"params": jax.tree_util.tree_map(np.asarray, params),
         "batch_stats": variables["batch_stats"]}))
    opt = make_optimizer(port.parameters(), 5e-1, betas=(0.5, 0.999),
                         weight_decay=L2)
    loaded, _ = checkpoint.load_checkpoint(jax_path)
    opt.load_state_dict(adam_state_from_jax(loaded["opt_state"], port, opt))
    assert opt.param_groups[0]["lr"] == pytest.approx(1e-3)
    assert opt.param_groups[0]["betas"][0] == pytest.approx(0.99)

    back = adam_state_to_jax(opt, port)
    want = serialization.to_state_dict(state)
    flat_want = jax.tree_util.tree_leaves_with_path(want)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_want) == len(flat_back)
    for path, leaf in flat_want:
        got = flat_back[path]
        assert got.dtype == np.asarray(leaf).dtype, path
        np.testing.assert_array_equal(got, np.asarray(leaf), err_msg=path)
    port_path = str(tmp_path / "port.optim")
    checkpoint.save_checkpoint(port_path, {"opt_state": back})
    with open(jax_path, "rb") as a, open(port_path, "rb") as b:
        assert a.read() == b.read()

    updates, state = tx.update(grads, state, params)
    params = optax.apply_updates(params, updates)
    named = dict(port.named_parameters())
    keys = [(path[1:], k) for path, k in _unet_key_map()
            if path[0] == "params"]
    for path, k in keys:
        named[k].grad = torch.from_numpy(_leaf(grads, path).copy())
    opt.step()
    for path, k in keys:
        np.testing.assert_allclose(named[k].detach().numpy(),
                                   _leaf(params, path), atol=1e-7,
                                   rtol=ULP, err_msg=k)


def test_distances_flag_is_ported():
    assert get_args_unet_training(["unet.model", "--distances"]).distances


def test_training_loaders_match_jax():
    """The same train / validation split and the same per-epoch order of
    visits as the JAX loaders for the same seed."""
    kw = dict(n_cases=7, shape_xyz=(8, 8, 6), seed=3)
    mods, labels = [dataset.MOD_CBV, dataset.MOD_TTD], [dataset.LABEL_CORE]
    ours = get_stroke_shape_training_data(
        dataset.StrokeDataset3D(dataset.SyntheticCaseProvider(**kw), mods,
                                labels), range(7), 0.3, seed=5, batchsize=2)
    theirs = jax_loader.get_stroke_shape_training_data(
        jax_dataset.StrokeDataset3D(jax_dataset.SyntheticCaseProvider(**kw),
                                    mods, labels),
        range(7), 0.3, seed=5, batchsize=2)
    for a, b in zip(ours, theirs):
        assert list(a.indices) == list(b.indices)
        for _ in range(3):
            assert a.epoch_chunks() == b.epoch_chunks()


def test_save_curves_matches_jax(tmp_path):
    """The curves JSON is byte-identical to the JAX learner's, ``inf``
    included, and reads back."""
    curves = {"training": [{"loss": np.float32(0.5), "core_hd": float("inf"),
                            "core_dc": 0.25}],
              "validate": [{"loss": 0.75, "core_hd": np.float64(3.5),
                            "core_dc": np.float32(0.125)}]}
    checkpoint.save_curves(str(tmp_path / "port.json"), curves)
    jax_checkpoint.save_curves(str(tmp_path / "jax.json"), curves)
    assert (tmp_path / "port.json").read_bytes() == \
        (tmp_path / "jax.json").read_bytes()
    back = checkpoint.load_curves(str(tmp_path / "port.json"))
    assert back["training"][0]["core_hd"] == float("inf")
    assert back["validate"][0]["core_dc"] == 0.125


def test_unet_bfloat16_forward_loss_matches_jax(variables, jax_step):
    imgs, labs = jax_step[0], jax_step[1]
    model = JaxUnet3D(channels=CHANNELS, compute_dtype=jnp.bfloat16)
    seg, _ = jax.jit(lambda v, x: model.apply(
        v, x, train=True, mutable=["batch_stats"]))(variables,
                                                     jnp.asarray(imgs))
    want = float(_jax_loss(seg, jnp.asarray(labs)))

    port = Unet3D(CHANNELS, compute_dtype=torch.bfloat16).train()
    port.load_state_dict(unet_state_from_jax(variables))
    with torch.no_grad():
        seg_t = port(torch.from_numpy(imgs))
    assert seg_t.dtype == torch.float32
    got = float(_port_loss(seg_t, torch.from_numpy(labs)))
    assert abs(got - want) <= 2e-2, (got, want)


def _case_lines(out):
    return [ln for ln in out.splitlines() if ln.startswith("Case Id")]


def _epoch_lines(out):
    return re.findall(r"^Epoch (\d+)/(\d+) (training|validate) loss: ", out,
                      re.M)


def test_cli_trains_end_to_end_on_cpu(tmp_path, capsys, monkeypatch):
    """The port's training CLI for two epochs on tiny synthetic cases: the
    epoch lines, the artifacts, the curves schema of the JAX learner, its
    best-valid model in both packages' testers, and a resume."""
    monkeypatch.setattr(port_common, "synthetic_cache_dir",
                        lambda: str(tmp_path / "port_cache"))
    base = str(tmp_path / "unet")
    common = ["--synthetic", "--xyoriginal", "24", "--zsize", "24",
              "--channels", *map(str, CHANNELS)]
    train_args = [str(tmp_path / "unused.model"), *common, "--batchsize",
                  "2", "--fold", "0", "1", "2", "3", "4", "5",
                  "--validsetsize", "0.34", "--dtype", "float32",
                  "--device", "cpu"]
    learner = train_cli.train(get_args_unet_training(
        train_args + ["--epochs", "2", "--outbasepath", base]))
    out = capsys.readouterr().out
    assert _epoch_lines(out) == [
        ("1", "2", "training"), ("1", "2", "validate"),
        ("2", "2", "training"), ("2", "2", "validate")]
    assert learner.step_counts["train"] == 2 * 2       # 4 cases, batch 2
    for suffix in ("_unet.model", "_unet.optim", "_unet.json",
                   "_unet_final.model", "_visual_1.png", "_visual_2.png",
                   "_visual_plots.png"):
        assert os.path.getsize(base + suffix) > 0, suffix
    curves = checkpoint.load_curves(base + "_unet.json")
    assert set(curves) == {"training", "validate"}
    assert len(curves["training"]) == len(curves["validate"]) >= 1
    assert "loss" in curves["training"][0]

    # the best-valid model in the JAX tester and in the port's
    test_args = [base + "_unet.model", *common, "--fold", "0", "1"]

    def jax_provider(**kw):
        return jax_dataset.SyntheticCaseProvider(
            **{**kw, "cache_dir": str(tmp_path / "jax_cache")})

    monkeypatch.setattr(jax_common, "SyntheticCaseProvider", jax_provider)
    jax_test_cli.test(JaxUnetParser().parse_args(
        test_args + ["--outbasepath", str(tmp_path / "jax_test")]))
    jax_out = capsys.readouterr().out
    port_test_cli.test(get_args_unet_training(
        test_args + ["--outbasepath", str(tmp_path / "port_test"),
                     "--device", "cpu"]))
    port_out = capsys.readouterr().out
    assert len(_case_lines(jax_out)) == 2
    assert _case_lines(port_out) == _case_lines(jax_out)

    # resume from the snapshot: the epochs go on from the snapshot's count
    train_cli.train(get_args_unet_training(
        train_args + ["--epochs", "3", "--inbasepath", base,
                      "--outbasepath", str(tmp_path / "resumed")]))
    out = capsys.readouterr().out
    assert "Continue training" in out
    start = len(curves["training"]) + 1
    assert [int(e) for e, _, _ in _epoch_lines(out)[::2]] == list(
        range(start, 4))
