"""Port parity for phase-2 prediction against a frozen phase-1 CAE
(``CaePredictionLearner``, ``inference.cae_enc_inference``,
``cli/train_shape_prediction``), the phase-2 augmentation of the images
with the labels, the encoder's Adam state and the parser.

``cae_enc_inference``: the port against JAX's on the same variables and
batch, float32, within 1e-5 (the CAE's bar).  One learner training step
(augmentation off) against JAX's ``CaePredictionLearner._loss`` run in
float64 (``_Float64Numpy``), in float64, float32 and bfloat16 (a float32
frozen CAE behind a bfloat16 encoder, as the CLI builds them) at
``tests/test_torch_cae_train_step.py``'s limits: the loss, every encoder
gradient (a kernel's relative to its own max|ref|, a bias's or a BN
scale's to the float64 sum of its terms' sizes, the entry BN's non-zero),
the encoder's running statistics, and the frozen CAE's parameters and
statistics unchanged bit for bit with no gradient; a wrong gradient must
fail the check.  The augmentation core on JAX's fields within 1e-6; the
``.optim`` of the ``enc3d`` tree byte-identical to JAX's.  With structure
batching on, the grouped step is held to JAX's float64 step in float64 and
bfloat16 at the same limits."""

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
from stroke_prediction_tpu.core.dto import BRANCH_INPUTS as JAX_INPUTS
from stroke_prediction_tpu.data import augment as jax_augment
from stroke_prediction_tpu.data import dataset as jax_dataset
from stroke_prediction_tpu.data import loader as jax_loader
from stroke_prediction_tpu.eval import metrics as jax_metrics
from stroke_prediction_tpu.models import cae3d as jax_cae3d
from stroke_prediction_tpu.models import layers as jax_layers
from stroke_prediction_tpu.models.factory import load_model as jax_load_model
from stroke_prediction_tpu.ops import warp as jax_warp
from stroke_prediction_tpu.train import cae_learners as jax_cae_learners
from stroke_prediction_tpu.train import checkpoint as jax_checkpoint
from stroke_prediction_tpu.train import optim as jax_optim
from stroke_prediction_tpu.utils import args as jax_args
from stroke_prediction_tpu_torch.cli import common as port_common
from stroke_prediction_tpu_torch.cli import train_shape_prediction as cli
from stroke_prediction_tpu_torch.data import augment
from stroke_prediction_tpu_torch.data.dataset import (
    KEY_GLOBAL, KEY_IMAGES, KEY_LABELS, LABEL_CORE, LABEL_LESION, LABEL_PENU,
    MOD_UNET_CORE, MOD_UNET_PENU)
from stroke_prediction_tpu_torch.inference import (
    cae_dto_from_batch, cae_enc_inference)
from stroke_prediction_tpu_torch.models import layers
from stroke_prediction_tpu_torch.models.cae3d import Cae3D, Dec3D, Enc3D
from stroke_prediction_tpu_torch.models.convert import (
    _key_map, adam_state_from_jax, adam_state_to_jax, state_from_jax)
from stroke_prediction_tpu_torch.ops.conv3x3 import activation
from stroke_prediction_tpu_torch.train import optim
from stroke_prediction_tpu_torch.train.cae_learners import (
    CaePredictionLearner)
from stroke_prediction_tpu_torch.utils import checkpoint
from stroke_prediction_tpu_torch.utils.args import (
    get_args_shape_prediction_training)

from test_torch_cae_step_learner import _loader, write_phase1_cae
from test_torch_cae_train_step import (
    BATCH, CHANNELS, SPATIAL, SWITCH, _batch, _config, _jax_model, _tols,
    _variables)
from test_torch_train import ULP, _Float64Numpy, _leaf
from test_torch_unet import _random_variables

torch.set_num_threads(1)

ENC = {"kind": "enc3d", "channels": list(CHANNELS), "n_ch_global": 5}
BETAS, L2 = (0.9, 0.999), 1e-5
TOL = dict(atol=1e-5, rtol=0)
ENTRY_BN = ("encoder.blocks.0.bn.scale", "encoder.blocks.0.bn.bias")


def _images():
    """U-Net-output-like core and penumbra probabilities."""
    rs = np.random.RandomState(6)
    return np.clip(rs.rand(BATCH, *SPATIAL, 2) * 1.4 - 0.2, 0.0,
                   1.0).astype(np.float32)


def _jax_enc(dtype=jnp.float32):
    return jax_cae3d.Enc3D(channels=CHANNELS, n_ch_global=5,
                           compute_dtype=dtype)


@pytest.fixture(scope="module")
def variables():
    """(frozen CAE variables, encoder variables), random."""
    labels, clinical = _batch()
    dto = jax_inference.cae_dto_from_batch(
        jnp.asarray(_images()), jnp.asarray(labels), jnp.asarray(clinical),
        inputs_from_images=True)
    shapes = jax.eval_shape(lambda: _jax_enc().init(
        jax.random.PRNGKey(0), dto, JAX_INPUTS, False))
    return _variables(False, 2), _random_variables(
        shapes, np.random.RandomState(7))


def _port_models(variables, dtype=torch.float32):
    cae_vars, enc_vars = variables
    cae = Cae3D(Enc3D(CHANNELS, 5), Dec3D(CHANNELS, 5))
    cae.load_state_dict(state_from_jax(cae_vars, _config(False)))
    enc = Enc3D(CHANNELS, 5, compute_dtype=dtype)
    enc.load_state_dict(state_from_jax(enc_vars, ENC))
    if dtype == torch.float64:
        cae.double()
        enc.double()
        for m in (cae.enc.encoder, cae.dec.decoder):
            m.compute_dtype = dtype
    return cae, enc


def _port_batch(dtype=torch.float32):
    labels, clinical = _batch()
    wide = torch.promote_types(dtype, torch.float32)
    return {KEY_IMAGES: torch.from_numpy(_images()).to(wide),
            KEY_LABELS: torch.from_numpy(labels).to(wide),
            KEY_GLOBAL: torch.from_numpy(clinical).to(wide)}


# ------------------------------------------------------ the forward

@pytest.mark.parametrize("train", [False, True])
def test_cae_enc_inference_matches_jax(variables, train):
    """The inputs branch (new encoder, frozen decoder) and the gtruth
    branch (frozen CAE): every latent and reconstruction within 1e-5, and
    the encoder's running statistics moved as JAX's in training mode."""
    cae_vars, enc_vars = variables
    labels, clinical = _batch()
    images = _images()
    dto = jax_inference.cae_dto_from_batch(
        jnp.asarray(images), jnp.asarray(labels), jnp.asarray(clinical),
        inputs_from_images=True)
    out = jax_inference.cae_enc_inference(
        _jax_model(False, jnp.float32), cae_vars, _jax_enc(), enc_vars, dto,
        train=train, enc_mutable=["batch_stats"] if train else False)
    want, mut = out if train else (out, None)

    cae, enc = _port_models(variables)
    b = _port_batch()
    with torch.no_grad():
        got = cae_enc_inference(cae, enc, cae_dto_from_batch(
            b[KEY_IMAGES], b[KEY_LABELS], b[KEY_GLOBAL],
            inputs_from_images=True), train)
    assert enc.training == train and not cae.training
    for part in ("latents", "reconstructions"):
        for branch, fields in (("inputs", ("core", "penu", "interpolation")),
                               ("gtruth", ("core", "penu", "lesion",
                                           "interpolation"))):
            for f in fields:
                g = getattr(getattr(getattr(got, part), branch), f)
                w = getattr(getattr(getattr(want, part), branch), f)
                assert tuple(g.shape) == w.shape, (part, branch, f)
                np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                           err_msg=f"{part} {branch} {f}")
    if train:
        buffers = dict(enc.named_buffers())
        for path, key in _key_map(ENC):
            if path[0] == "batch_stats":
                np.testing.assert_allclose(
                    buffers[key].numpy(), _leaf(mut["batch_stats"],
                                                path[1:]), atol=1e-6,
                    rtol=0, err_msg=key)


# -------------------------------------------------------------- the step

def _jax_step64(variables):
    """value_and_grad over the encoder's parameters of
    ``CaePredictionLearner._loss`` through JAX's ``cae_enc_inference`` at
    train=True, in float64 -> (loss, grads, new batch_stats)."""
    cae_vars, enc_vars = variables
    labels, clinical = _batch()
    cae_model, enc_model = _jax_model(False, jnp.float64), _jax_enc(
        jnp.float64)
    loss_self = types.SimpleNamespace(_label_weights=(1.0,))

    def run(cae_vars, params, batch_stats, images, labels, clinical):
        def loss_fn(p):
            dto = jax_inference.cae_dto_from_batch(
                images, labels, clinical, inputs_from_images=True)
            out, mut = jax_inference.cae_enc_inference(
                cae_model, cae_vars, enc_model,
                {"params": p, "batch_stats": batch_stats}, dto, train=True,
                enc_mutable=["batch_stats"])
            return jax_cae_learners.CaePredictionLearner._loss(
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
                cast(cae_vars), cast(enc_vars["params"]),
                cast(enc_vars["batch_stats"]),
                jnp.asarray(_images(), jnp.float64),
                jnp.asarray(labels, jnp.float64),
                jnp.asarray(clinical, jnp.float64))
            return (float(loss), jax.tree_util.tree_map(np.asarray, grads),
                    jax.tree_util.tree_map(np.asarray, mut["batch_stats"]))
        finally:
            jax.config.update("jax_enable_x64", False)


def _learner_step(variables, dtype):
    """One ``CaePredictionLearner.train_step`` (augmentation off): the
    encoder at ``dtype`` behind the frozen CAE (float32; float64 for a
    float64 step), Adam over the encoder -> (metrics, cae, enc, the CAE's
    state before)."""
    cae, enc = _port_models(variables, dtype)
    cae_before = {k: v.clone() for k, v in cae.state_dict().items()}
    opt = optim.make_optimizer(enc.parameters(), 1e-3, betas=BETAS,
                               weight_decay=L2)
    learner = CaePredictionLearner(_loader(), None, cae, enc, opt, None, 1,
                                   device="cpu")
    learner.augment = lambda batch: batch
    metrics = learner.train_step(_port_batch(dtype))
    return metrics, cae, enc, cae_before


def _sum_terms(variables):
    """The size of the sum behind each encoder bias-like gradient: one
    float64 step of the port with BN applied rather than folded, every BN
    output and pre-activation kept -> {parameter: sum over the voxels and
    the calls of |g| (a bias) or |g * x_hat| (a BN scale)}."""
    kept = []

    def bn_forward(self, x, groups=1):
        assert groups == 1       # the passes one structure each
        s, t = self.affine(x)
        out = x * s + t
        if out.requires_grad:
            out.retain_grad()
            with torch.no_grad():
                axes = tuple(range(x.ndim - 1))
                mean = x.mean(axes)
                var = torch.clamp((x * x).mean(axes) - mean * mean, min=0.0)
                x_hat = (x - mean) * torch.rsqrt(var + self.epsilon)
            kept.extend([(self.bias, out, None), (self.scale, out, x_hat)])
        return out

    def keep_bias(forward):
        def run(self, x, *args):
            out = forward(self, x)
            if out.requires_grad:
                out.retain_grad()
                kept.append((self.bias, out, None))
            return activation(out, *args) if args else out
        return run

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(layers.BatchNorm, "forward", bn_forward)
        mp.setattr(layers.BnConvActBlock, "forward",
                   lambda self, x, groups=1: self.conv(
                       self.bn(x, groups), self.act, self.act_param))
        mp.setattr(layers.Conv3d, "forward", keep_bias(layers.Conv3d.forward))
        _, _, enc, _ = _learner_step(variables, torch.float64)
    terms = {}
    for param, out, x_hat in kept:
        if out.grad is not None and param.requires_grad:
            g = out.grad if x_hat is None else out.grad * x_hat
            s = g.abs().sum(tuple(range(g.ndim - 1)))
            terms[param] = terms.get(param, 0.0) + s
    return {k: terms[p].numpy() for k, p in enc.named_parameters()
            if p in terms}


@pytest.fixture(scope="module")
def jax_step64(variables):
    return _jax_step64(variables) + (_sum_terms(variables),)


def _check_grads(grads, grads64, terms, tol, sum_tol):
    """Every encoder gradient against JAX's float64 one: a kernel's within
    ``tol`` of its own max|ref|, a bias's or a BN scale's within
    ``sum_tol`` of its sum's size, element by element."""
    params = [(key, _leaf(grads64, path[1:]))
              for path, key in _key_map(ENC) if path[0] == "params"]
    assert len(params) == len(grads) == 4 * 10
    for key, ref in params:
        err = np.abs(grads[key] - ref)
        if key in terms:
            bad = err > sum_tol * terms[key]
            assert not bad.any(), (key, float((err / terms[key])[bad].max()))
        else:
            assert err.max() <= tol * np.abs(ref).max(), (key, err.max())


def _check_step(variables, witness, dtype):
    want_loss, grads64, want_stats, terms = witness
    tol_loss, tol_grad, tol_sum, tol_stats = _tols(dtype)
    metrics, cae, enc, cae_before = _learner_step(variables,
                                                  getattr(torch, dtype))
    assert abs(float(metrics["loss"]) - want_loss) <= tol_loss
    named = dict(enc.named_parameters())
    # every BN's scale and bias and every conv's bias of the encoder
    assert len(terms) == 3 * 10
    _check_grads({k: p.grad.double().numpy() for k, p in named.items()},
                 grads64, terms, tol_grad, tol_sum)
    for key in ENTRY_BN:
        assert float(named[key].grad.abs().max()) > 0, key
    buffers = dict(enc.named_buffers())
    for path, key in _key_map(ENC):
        if path[0] == "batch_stats":
            np.testing.assert_allclose(buffers[key].double().numpy(),
                                       _leaf(want_stats, path[1:]),
                                       atol=tol_stats, rtol=0, err_msg=key)
    for key, value in cae.state_dict().items():
        assert torch.equal(value, cae_before[key]), key
    assert all(p.grad is None and not p.requires_grad
               for p in cae.parameters())


@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
def test_prediction_train_step_matches_jax(variables, jax_step64, dtype):
    _check_step(variables, jax_step64, dtype)


@pytest.mark.parametrize("dtype", ["float64", "bfloat16"])
def test_prediction_grouped_train_step_matches_jax(variables, jax_step64,
                                                   monkeypatch, dtype):
    """Phase 2's step with structure batching on (the new encoder over the
    inputs branch's two groups, the frozen decoder over its three, the
    frozen CAE's gtruth branch) against JAX's float64 step (the sequential
    one: JAX's grouped step is the same function,
    test_torch_cae_train_step.py), at the same limits."""
    monkeypatch.setenv(SWITCH, "1")
    _check_step(variables, jax_step64, dtype)


@pytest.mark.parametrize("dtype, key", [
    ("bfloat16", "encoder.blocks.9.conv.bias"),
    ("float32", "encoder.blocks.0.bn.bias")])
def test_prediction_step_check_sees_a_wrong_gradient(variables, jax_step64,
                                                     dtype, key):
    """Controls of the gradient check: the port's step passes it, and the
    same step with one gradient zeroed or sign-flipped fails it (in
    bfloat16 the fc conv's bias, in float32 the entry BN's bias)."""
    _, grads64, _, terms = jax_step64
    tols = _tols(dtype)[1:3]
    _, _, enc, _ = _learner_step(variables, getattr(torch, dtype))
    grads = {k: p.grad.double().numpy() for k, p in enc.named_parameters()}
    _check_grads(grads, grads64, terms, *tols)
    for wrong in (np.zeros_like(grads[key]), -grads[key]):
        with pytest.raises(AssertionError, match=key):
            _check_grads({**grads, key: wrong}, grads64, terms, *tols)


# ------------------------------------------------------ the augmentation

def test_image_deformation_core_matches_jax():
    """JAX's per-sample fields (its key split) fed to the port's core: the
    images deformed with the labels by one field a sample
    (``apply_to_images=True``), within 1e-6."""
    key = jax.random.PRNGKey(11)
    rs = np.random.RandomState(8)
    labels = (rs.rand(2, 12, 40, 36, 3) > 0.5).astype(np.float32)
    images = rs.rand(2, 12, 40, 36, 2).astype(np.float32)
    want_l, want_i = jax_augment.elastic_deform_batch(
        key, jnp.asarray(labels), jnp.asarray(images), apply_to_images=True)
    fields = torch.from_numpy(np.stack([np.asarray(jax_warp.elastic_fields(
        k, labels.shape[1:4])) for k in jax.random.split(key, 2)]))
    got_i = augment.elastic_deform_batch(torch.from_numpy(images), fields)
    got_l = augment.elastic_deform_batch(torch.from_numpy(labels), fields)
    np.testing.assert_allclose(got_i.numpy(), np.asarray(want_i), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), atol=1e-6,
                               rtol=0)
    assert np.abs(got_i.numpy() - images).max() > 0.5       # it moved


def test_image_augmentation_sampler_shares_the_draws():
    """The phase-2 sampler draws as the phase-1 one does (the same labels
    from the same seed) and moves the images with the labels: images equal
    to the labels come out equal to them."""
    gen = torch.Generator().manual_seed(0)
    labels = (torch.rand((2, 28, 64, 64, 3), generator=gen) > 0.5).float()
    want = augment.random_cae_augment(torch.Generator().manual_seed(9),
                                      labels)
    images, got = augment.random_cae_augment_images(
        torch.Generator().manual_seed(9), labels[..., :2].clone(), labels)
    assert torch.equal(got, want)
    assert torch.equal(images, got[..., :2])
    assert float((got - labels).abs().max()) > 0.5


# ------------------------------------------------ the encoder's Adam state

def test_enc3d_optimizer_state_round_trip(variables, tmp_path):
    """A JAX ``.optim`` of the phase-2 encoder (optax's unmasked chain over
    the ``enc3d`` tree, one update) loads into the port's Adam and comes
    back leaf for leaf and byte for byte; one more step agrees with
    optax."""
    _, enc_vars = variables
    params = jax.tree_util.tree_map(jnp.asarray, enc_vars["params"])
    rs = np.random.RandomState(4)
    grads = jax.tree_util.tree_map(
        lambda a: rs.randn(*a.shape).astype(np.float32), enc_vars["params"])
    tx = jax_optim.make_optimizer(1e-3, betas=BETAS, weight_decay=L2)
    state = tx.init(params)
    updates, state = tx.update(grads, state, params)
    params = optax.apply_updates(params, updates)
    jax_path = str(tmp_path / "jax.optim")
    jax_checkpoint.save_checkpoint(jax_path, {"opt_state": state})

    enc = Enc3D(CHANNELS, 5)
    enc.load_state_dict(state_from_jax(
        {"params": jax.tree_util.tree_map(np.asarray, params),
         "batch_stats": enc_vars["batch_stats"]}, ENC))
    assert enc.config == ENC
    opt = optim.make_optimizer(enc.parameters(), 5e-1, betas=(0.5, 0.999),
                               weight_decay=L2)
    loaded, _ = checkpoint.load_checkpoint(jax_path)
    opt.load_state_dict(adam_state_from_jax(loaded["opt_state"], enc, opt))
    back = adam_state_to_jax(opt, enc)
    flat_want = jax.tree_util.tree_leaves_with_path(
        serialization.to_state_dict(state))
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_want) == len(flat_back) == 4 + 2 * 40
    for path, leaf in flat_want:
        np.testing.assert_array_equal(flat_back[path], np.asarray(leaf),
                                      err_msg=str(path))
    port_path = str(tmp_path / "port.optim")
    checkpoint.save_checkpoint(port_path, {"opt_state": back})
    with open(jax_path, "rb") as a, open(port_path, "rb") as b:
        assert a.read() == b.read()

    updates, state = tx.update(grads, state, params)
    params = optax.apply_updates(params, updates)
    named = dict(enc.named_parameters())
    keys = [(path[1:], k) for path, k in _key_map(ENC)
            if path[0] == "params"]
    for path, k in keys:
        named[k].grad = torch.from_numpy(_leaf(grads, path).copy())
    opt.step()
    for path, k in keys:
        np.testing.assert_allclose(named[k].detach().numpy(),
                                   _leaf(params, path), atol=1e-7,
                                   rtol=ULP, err_msg=k)


# --------------------------------------------------------------- the CLI

def _cli_args(*extra):
    return ["--synthetic", "--xyoriginal", "128", "--zsize", "28",
            "--channelsenc", *map(str, CHANNELS), "--batchsize", "2",
            "--fold", "0", "1", "2", "3", "--validsetsize", "0.5",
            "--device", "cpu", "--dtype", "float32", *extra]


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """The phase-2 CLI with ``--initbycae`` on a phase-1 CAE for one epoch,
    float32, on 64 x 64 x 28 synthetic cases; the encoder's state as
    training began."""
    out = tmp_path_factory.mktemp("cae_pred")
    write_phase1_cae(str(out / "shape_cae1.model"), seed=3)
    start = {}
    real = CaePredictionLearner.run_training

    def run_training(self):
        start.update({k: v.clone() for k, v in self._model.state_dict()
                      .items()})
        return real(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_common, "synthetic_cache_dir",
                   lambda: str(out / "port_cache"))
        mp.setattr(CaePredictionLearner, "run_training", run_training)
        base = str(out / "pred")
        learner = cli.train(get_args_shape_prediction_training(_cli_args(
            str(out / "shape_cae1.model"), "--initbycae", "--epochs", "1",
            "--outbasepath", base)))
    return learner, base, out, start


def test_prediction_cli_trains_an_encoder_on_a_frozen_cae(cli_run):
    """The artifacts as the JAX CLI names them; ``--initbycae`` started the
    encoder from the CAE's encoder (parameters and statistics); the images
    are the U-Net outputs; the frozen CAE written back byte for byte; the
    encoder's checkpoint and ``.optim`` over the ``enc3d`` tree."""
    learner, base, out, start = cli_run
    assert learner.step_counts["train"] == 1
    assert learner.step_counts["eval"] == 1
    ds = learner._dataloader_training.dataset
    assert ds._modalities == [MOD_UNET_CORE, MOD_UNET_PENU]
    assert ds._labels == [LABEL_CORE, LABEL_PENU, LABEL_LESION]
    assert ds._flip_split_id == 15 and ds._pad is None
    for suffix in ("_cae2.model", "_cae2_enc.model", "_cae2.optim",
                   "_cae2.json", "_cae2_final.model", "_cae2_enc_final.model",
                   "_cae2_1.png"):
        assert os.path.getsize(base + suffix) > 0, suffix
    phase1 = (out / "shape_cae1.model").read_bytes()
    for suffix in ("_cae2.model", "_cae2_final.model"):
        with open(base + suffix, "rb") as f:
            assert f.read() == phase1, suffix
    cae_state = learner._cae.state_dict()
    for key, value in start.items():
        assert torch.equal(value, cae_state["enc." + key]), key
    enc, config = checkpoint.load_checkpoint(base + "_cae2_enc_final.model")
    assert config == ENC
    assert set(enc["params"]) == {"encoder"}
    opt, _ = checkpoint.load_checkpoint(base + "_cae2.optim")
    mu = opt["opt_state"]["inner_state"]["1"]["mu"]
    assert set(mu) == {"encoder"}
    assert np.abs(mu["encoder"]["BnConvActBlock_0"]["Conv3d_0"][
        "kernel"]).max() > 0


def test_prediction_snapshot_resumes_in_both_packages(cli_run, tmp_path,
                                                      capsys, monkeypatch):
    """The port's snapshot in the JAX learner (its encoder and Adam state
    leaf for leaf), and the port's CLI resumed from it with a JAX-written
    ``.optim`` (two updates) for a second epoch."""
    learner, base, out, _ = cli_run
    kw = dict(n_cases=4, shape_xyz=(64, 64, 28), seed=4)
    theirs = jax_dataset.StrokeDataset3D(
        jax_dataset.SyntheticCaseProvider(**kw),
        [jax_dataset.MOD_UNET_CORE, jax_dataset.MOD_UNET_PENU],
        [jax_dataset.LABEL_CORE, jax_dataset.LABEL_PENU,
         jax_dataset.LABEL_LESION], flip_split_id=15)
    train, valid = jax_loader.get_stroke_prediction_training_data(
        theirs, range(4), 0.5, seed=4, batchsize=2)
    cae_model, cae_vars = jax_load_model(base + "_cae2.model")
    ref = jax_cae_learners.CaePredictionLearner(
        train, valid, cae_model, cae_vars, _jax_enc(),
        jax_optim.make_optimizer(1e-3, betas=BETAS, weight_decay=L2), None,
        n_epochs=2, path_previous_base=base,
        path_outputs_base=str(tmp_path / "jax"),
        metrics_with_distances=False)
    saved, _ = checkpoint.load_checkpoint(base + "_cae2.optim")
    flat_saved = dict(jax.tree_util.tree_leaves_with_path(
        saved["opt_state"]))
    flat_restored = jax.tree_util.tree_leaves_with_path(
        serialization.to_state_dict(ref._state.opt_state))
    assert len(flat_restored) == len(flat_saved) == 4 + 2 * 40
    for path, leaf in flat_restored:
        np.testing.assert_array_equal(np.asarray(leaf), flat_saved[path],
                                      err_msg=str(path))
    enc_saved, _ = checkpoint.load_checkpoint(base + "_cae2_enc.model")
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            serialization.to_state_dict(ref._state.params)):
        np.testing.assert_array_equal(
            np.asarray(leaf), dict(jax.tree_util.tree_leaves_with_path(
                enc_saved["params"]))[path], err_msg=str(path))
    assert ref.get_start_epoch() == 1

    params = jax.tree_util.tree_map(jnp.asarray, enc_saved["params"])
    tx = jax_optim.make_optimizer(1e-3, betas=BETAS, weight_decay=L2)
    rs = np.random.RandomState(5)
    grads = jax.tree_util.tree_map(
        lambda a: rs.randn(*a.shape).astype(np.float32), enc_saved["params"])
    state = tx.init(params)
    for _ in range(2):
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
    resume = str(tmp_path / "resume")
    for suffix in ("_cae2_enc.model", "_cae2.json"):
        with open(base + suffix, "rb") as a, open(resume + suffix, "wb") as b:
            b.write(a.read())
    jax_checkpoint.save_checkpoint(resume + "_cae2.optim",
                                   {"opt_state": state})
    capsys.readouterr()
    monkeypatch.setattr(port_common, "synthetic_cache_dir",
                        lambda: str(out / "port_cache"))
    monkeypatch.setattr(CaePredictionLearner, "visualize_epoch",
                        lambda *a: None)
    resumed = cli.train(get_args_shape_prediction_training(_cli_args(
        str(out / "shape_cae1.model"), "--epochs", "2", "--inbasepath",
        resume, "--outbasepath", str(tmp_path / "resumed"))))
    printed = capsys.readouterr().out
    assert "Continue training" in printed
    assert "Epoch 2/2 training loss: " in printed
    assert "Epoch 1/2" not in printed
    kernel = resumed._model.encoder.blocks[0].conv.kernel
    assert float(resumed._optimizer.state[kernel]["step"]) == 2 + 1


def test_shape_prediction_args_match_jax(monkeypatch):
    monkeypatch.setattr("sys.argv", ["prog", "cae.model", "--initbycae"])
    want = vars(jax_args.get_args_shape_prediction_training())
    got = vars(get_args_shape_prediction_training(
        ["cae.model", "--initbycae", "--device", "cpu"]))
    assert got.pop("device") == "cpu"
    assert got == want
    assert get_args_shape_prediction_training(["cae.model"]).device == "cuda"
