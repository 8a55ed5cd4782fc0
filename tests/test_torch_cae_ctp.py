"""Port parity for the CTP-conditioned CAE (``Enc3DCtp`` / ``Cae3DCtp``):
the forward, the augmentation's deterministic core, the ``cae3d_ctp``
checkpoint in both directions and the training CLI, each against the JAX
package on the CPU (lax path).  ``tests/test_torch_cae_ctp_step.py`` holds
the training step.

The encoder concatenates each mask with the CBV and TTD images, cropped
back from their padding, so its entry conv runs at C_in 3 on CT
intensities (CBV ~4, TTD ~5-30, as the synthetic cases make them) whose
squared mean is 3-4x their variance.  The forward agrees to 1e-5: in
evaluation mode with JAX's float32, in training mode with JAX run in
float64, because JAX's own float32 forward is 1.8e-5 off float64 there
(its BN moments of the CT channels, ``E[x^2] - E[x]^2`` from sequential
float32 sums) while the port's is 1.3e-6."""

import os
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stroke_prediction_tpu import inference as jax_inference
from stroke_prediction_tpu.core.dto import BRANCH_GTRUTH as JAX_GTRUTH
from stroke_prediction_tpu.data import augment as jax_augment
from stroke_prediction_tpu.eval import metrics as jax_metrics
from stroke_prediction_tpu.models import cae3d as jax_cae3d
from stroke_prediction_tpu.models import layers as jax_layers
from stroke_prediction_tpu.models.factory import load_model as jax_load_model
from stroke_prediction_tpu.ops import warp as jax_warp
from stroke_prediction_tpu.train import cae_learners as jax_cae_learners
from stroke_prediction_tpu.train import checkpoint as jax_checkpoint
from stroke_prediction_tpu_torch.cli import common as port_common
from stroke_prediction_tpu_torch.cli import (
    train_shape_reconstruction_with_ctp as cli)
from stroke_prediction_tpu_torch.data import augment
from stroke_prediction_tpu_torch.inference import cae_dto_from_batch
from stroke_prediction_tpu_torch.models.cae3d import (
    Cae3DCtp, Dec3D, Enc3DCtp)
from stroke_prediction_tpu_torch.models.convert import (
    _key_map, save_cae_checkpoint, state_from_jax)
from stroke_prediction_tpu_torch.models.factory import load_model
from stroke_prediction_tpu_torch.utils import checkpoint
from stroke_prediction_tpu_torch.utils.args import get_args_shape_training

from test_torch_train import _Float64Numpy, _leaf
from test_torch_unet import _random_variables

torch.set_num_threads(1)

CHANNELS = (3, 4, 5, 6, 7, 8, 1)
PAD = (4, 4, 4)                  # (D, H, W), the CLI's (x, y, z) reversed
SPATIAL = (28, 64, 64)           # the smallest (D, H, W) the CAE takes
BATCH = 2
CONFIG = {"kind": "cae3d_ctp", "channels": list(CHANNELS), "n_ch_global": 5,
          "step": False, "padding": list(PAD)}
FIELDS = ("core", "penu", "lesion", "interpolation")
TOL = dict(atol=1e-5, rtol=0)
ENTRY = ("enc.encoder.blocks.0.bn.scale", "enc.encoder.blocks.0.bn.bias",
         "enc.encoder.blocks.0.conv.kernel")


def _batch(n=BATCH, seed=5):
    """Soft core, penumbra and lesion masks, and CBV / TTD images made from
    them as the synthetic cases make theirs (CBV = 4 + 2 noise - 3 core +
    penumbra, TTD = 5 + 3 |noise| + 20 penumbra + 5 lesion), zero-padded by
    PAD as the dataset pads its images; a clinical vector per sample."""
    rs = np.random.RandomState(seed)
    labels = np.clip(rs.rand(n, *SPATIAL, 3) * 1.6 - 0.3, 0.0,
                     1.0).astype(np.float32)
    core, penu, lesion = (labels[..., i] for i in range(3))
    noise = rs.randn(n, *SPATIAL).astype(np.float32)
    cbv = 4.0 + 2.0 * noise - 3.0 * core + penu
    ttd = 5.0 + 3.0 * np.abs(noise) + 20.0 * penu + 5.0 * lesion
    pad = ((0, 0),) + tuple((p, p) for p in PAD) + ((0, 0),)
    images = np.pad(np.stack([cbv, ttd], -1), pad).astype(np.float32)
    clinical = np.array([[2.5, 3.0, 0.2, 0.4, 0.6],
                         [1.0, 5.5, 0.7, 0.1, 0.3]], np.float32)[:n]
    return images, labels, clinical


def _jax_model(dtype=jnp.float32):
    enc = jax_cae3d.Enc3DCtp(channels=CHANNELS, n_ch_global=5, padding=PAD,
                             compute_dtype=dtype)
    return jax_cae3d.Cae3DCtp(enc=enc, dec=jax_cae3d.Dec3D(
        channels=CHANNELS, n_ch_global=5, compute_dtype=dtype))


def _jax_dto(images, labels, clinical):
    return jax_inference.cae_dto_from_batch(
        jnp.asarray(images), jnp.asarray(labels), jnp.asarray(clinical),
        inputs_from_images=True)


def _port_dto(images, labels, clinical, dtype=torch.float32):
    return cae_dto_from_batch(*(torch.from_numpy(a).to(dtype) for a in (
        images, labels, clinical)), inputs_from_images=True)


@pytest.fixture(scope="module")
def variables():
    return _variables()


def _variables():
    """Random variables; the entry BN's running statistics are the moments
    of the masks and images it sees (as a trained model's are), so that
    the evaluation-mode forward normalizes the CT intensities."""
    images, labels, clinical = _batch()
    shapes = jax.eval_shape(lambda: _jax_model().init(
        jax.random.PRNGKey(0), _jax_dto(images, labels, clinical),
        JAX_GTRUTH, False))
    v = _random_variables(shapes, np.random.RandomState(0))
    crop = images[:, PAD[0]:-PAD[0], PAD[1]:-PAD[1], PAD[2]:-PAD[2]]
    x = np.concatenate([labels[..., 1:2], crop], -1).astype(np.float64)
    entry = v["batch_stats"]["enc"]["encoder"]["BnConvActBlock_0"][
        "BatchNorm_0"]["BatchNorm_0"]
    entry["mean"] = x.mean((0, 1, 2, 3)).astype(np.float32)
    entry["var"] = x.var((0, 1, 2, 3)).astype(np.float32)
    return v


def _port_model(variables, dtype=torch.float32):
    model = Cae3DCtp(Enc3DCtp(CHANNELS, 5, padding=PAD, compute_dtype=dtype),
                     Dec3D(CHANNELS, 5, compute_dtype=dtype))
    model.load_state_dict(state_from_jax(variables, CONFIG))
    if dtype == torch.float64:
        model.to(dtype)
    return model


def _assert_outputs_close(got, want, tol=TOL):
    for part in ("latents", "reconstructions"):
        for f in FIELDS:
            a = getattr(getattr(got, part).gtruth, f).double().numpy()
            b = np.asarray(getattr(getattr(want, part).gtruth, f))
            assert a.shape == b.shape, (part, f)
            np.testing.assert_allclose(a, b, err_msg=f"{part} {f}", **tol)


def _jax64(fn):
    """``fn()`` with the JAX modules' float32 read as float64 (x64 on)."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jax_layers, jax_cae3d, jax_metrics, jax_inference,
                    jax_cae_learners):
            mp.setattr(mod, "jnp", _Float64Numpy())
        jax.config.update("jax_enable_x64", True)
        try:
            return fn()
        finally:
            jax.config.update("jax_enable_x64", False)


def _cast64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                  tree)


# ----------------------------------------------------------------- forward

def test_ctp_forward_eval_matches_jax(variables):
    """Evaluation mode, float32 on both sides: latents and reconstructions
    within 1e-5, and the reconstructions of the structures differ (the
    entry BN's statistics normalize the CT channels)."""
    images, labels, clinical = _batch()
    want = _jax_model().apply(variables, _jax_dto(images, labels, clinical),
                              JAX_GTRUTH, False)
    model = _port_model(variables).eval()
    with torch.inference_mode():
        got = model(_port_dto(images, labels, clinical))
    _assert_outputs_close(got, want)
    rec = np.asarray(want.reconstructions.gtruth.core)
    assert rec.max() - rec.min() > 1e-2


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_ctp_forward_train_matches_jax_float64(variables, dtype):
    """Training mode (batch statistics, the chained running updates) against
    JAX in float64: outputs within 1e-5 (float64 1e-10), the running
    statistics too."""
    images, labels, clinical = _batch()

    def run():
        out, mut = _jax_model(jnp.float64).apply(
            _cast64(variables), jax_inference.cae_dto_from_batch(
                *(jnp.asarray(a, jnp.float64) for a in (images, labels,
                                                         clinical)),
                inputs_from_images=True),
            JAX_GTRUTH, True, mutable=["batch_stats"])
        return jax.tree_util.tree_map(np.asarray, (out, mut["batch_stats"]))

    want, stats = _jax64(run)
    dt = getattr(torch, dtype)
    model = _port_model(variables, dt).train()
    with torch.no_grad():
        got = model(_port_dto(images, labels, clinical,
                              torch.promote_types(dt, torch.float32)))
    tol = TOL if dtype == "float32" else dict(atol=1e-10, rtol=0)
    _assert_outputs_close(got, want, tol)
    buffers = dict(model.named_buffers())
    for path, key in _key_map(CONFIG):
        if path[0] == "batch_stats":
            np.testing.assert_allclose(
                buffers[key].double().numpy(), _leaf(stats, path[1:]),
                rtol=1e-6 if dtype == "float32" else 1e-12, atol=1e-6,
                err_msg=key)


def test_ctp_needs_three_input_channels():
    with pytest.raises(ValueError, match="At least 3 channels"):
        Enc3DCtp((2, 4, 5, 6, 7, 8, 1))
    with pytest.raises(AssertionError, match="At least 3 channels"):
        images, labels, clinical = _batch(1)
        jax_cae3d.Enc3DCtp(channels=(2, 4, 5, 6, 7, 8, 1)).init(
            jax.random.PRNGKey(0), _jax_dto(images, labels, clinical),
            JAX_GTRUTH, False)


# ------------------------------------------------------------ augmentation

def test_ctp_augment_core_matches_jax():
    """The JAX CTP learner's augmentation (``_augment`` with
    ``AUGMENT_IMAGES`` False) against the port's core on JAX's flip mask and
    per-sample fields: the padded images flipped only (equal), the labels
    flipped and deformed (1e-6, the warp's parity)."""
    key = jax.random.PRNGKey(11)
    images, labels, _ = _batch(4, seed=7)
    learner = types.SimpleNamespace(_elastic=True, AUGMENT_IMAGES=False)
    want_i, want_l = jax_cae_learners.CaeReconstructionLearner._augment(
        learner, key, jnp.asarray(images), jnp.asarray(labels))
    kf, ke = jax.random.split(key)
    flip = torch.from_numpy(np.asarray(jax.random.bernoulli(kf, 0.5, (4,))))
    assert 0 < int(flip.sum()) < 4
    fields = np.stack([np.asarray(jax_warp.elastic_fields(k, SPATIAL))
                       for k in jax.random.split(ke, 4)])
    got_i = augment.hemispheric_flip(torch.from_numpy(images), flip)
    got_l = augment.elastic_deform_batch(
        augment.hemispheric_flip(torch.from_numpy(labels), flip),
        torch.from_numpy(fields))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), atol=1e-6,
                               rtol=0)
    # the JAX flip alone, for the images
    np.testing.assert_array_equal(np.asarray(want_i), np.asarray(
        jax_augment.random_hemispheric_flip(kf, jnp.asarray(images),
                                            None)[0]))


def test_ctp_augment_sampler_shares_the_phase1_draws():
    """``random_cae_augment_ctp`` draws as ``random_cae_augment`` does (the
    same labels from the same seed); each image is its own or its mirror,
    never deformed, and mirrored exactly where its labels are."""
    images, labels, _ = _batch(4, seed=8)
    ti, tl = torch.from_numpy(images), torch.from_numpy(labels)
    got_i, got_l = augment.random_cae_augment_ctp(
        torch.Generator().manual_seed(1), ti, tl)
    ref_l = augment.random_cae_augment(torch.Generator().manual_seed(1), tl)
    torch.testing.assert_close(got_l, ref_l, atol=0, rtol=0)
    flip = augment.random_flip_mask(torch.Generator().manual_seed(1), 4)
    torch.testing.assert_close(got_i, augment.hemispheric_flip(ti, flip),
                               atol=0, rtol=0)
    assert 0 < int(flip.sum()) < 4


# -------------------------------------------------------------- checkpoint

def test_ctp_checkpoint_both_ways(variables, tmp_path):
    """A JAX-written ``cae3d_ctp`` checkpoint loads in the port's factory and
    the port's, written by ``save_cae_checkpoint``, in the JAX factory, with
    the same header (kind, padding) and the same forward (1e-5)."""
    images, labels, clinical = _batch()
    jax_path = str(tmp_path / "jax_ctp.model")
    jax_checkpoint.save_checkpoint(jax_path, variables, CONFIG)
    port, config = load_model(jax_path, "cpu")
    assert config == CONFIG and isinstance(port, Cae3DCtp)
    assert port.config == CONFIG and port.enc.padding == PAD
    want = _jax_model().apply(variables, _jax_dto(images, labels, clinical),
                              JAX_GTRUTH, False)
    with torch.inference_mode():
        _assert_outputs_close(port(_port_dto(images, labels, clinical)),
                              want)

    port_path = str(tmp_path / "port_ctp.model")
    save_cae_checkpoint(port_path, port)
    model, jvars = jax_load_model(port_path)
    assert isinstance(model, jax_cae3d.Cae3DCtp)
    assert model.enc.padding == PAD
    _, header = checkpoint.load_checkpoint(port_path)
    assert header == CONFIG
    again = model.apply(jvars, _jax_dto(images, labels, clinical),
                        JAX_GTRUTH, False)
    with torch.inference_mode():
        _assert_outputs_close(port(_port_dto(images, labels, clinical)),
                              again)
    with open(jax_path, "rb") as a, open(port_path, "rb") as b:
        assert a.read() == b.read()


# ------------------------------------------------------------------ the CLI

def _cli_args(*extra):
    return ["--synthetic", "--xyoriginal", "128", "--zsize", "28",
            "--channelscae", *map(str, CHANNELS), "--padding",
            *map(str, PAD[::-1]), "--batchsize", "2", "--fold", "0", "1",
            "2", "3", "4", "5", "--validsetsize", "0.34", "--device", "cpu",
            *extra]


def test_ctp_cli_trains_on_cpu(tmp_path, capsys, monkeypatch):
    """The port's CTP CLI, two epochs in float32 on 64 x 64 x 28 synthetic
    masks with images padded by 4: Adam's base betas (0.99, 0.999) under
    the beta1 ramp, the artifacts, the ``cae3d_ctp`` header, HD/ASSD on
    validation only, and the best-valid model in the JAX factory giving the
    port's forward on a validation case."""
    monkeypatch.setattr(port_common, "synthetic_cache_dir",
                        lambda: str(tmp_path / "port_cache"))
    base = str(tmp_path / "ctp")
    learner = cli.train(get_args_shape_training(_cli_args(
        "--epochs", "2", "--dtype", "float32", "--outbasepath", base)))
    printed = capsys.readouterr().out
    assert re.findall(r"Momentum betas have been set to: \(([0-9.]+), "
                      r"0\.999\)", printed) == ["0.59", "0.69"]
    assert learner._base_betas == (0.99, 0.999)
    assert learner.step_counts["train"] == 2 * 2     # 4 cases, batch 2
    assert learner.step_counts["eval"] == 2
    data, _ = learner.device_data(learner._dataloader_training)
    assert tuple(data["images"].shape[1:]) == (36, 72, 72, 2)
    assert tuple(data["labels"].shape[1:]) == (28, 64, 64, 3)
    for suffix in ("_cae1.model", "_cae1.optim", "_cae1.json",
                   "_cae1_final.model", "_cae1_1.png", "_cae1_plots.png"):
        assert os.path.getsize(base + suffix) > 0, suffix
    curves = checkpoint.load_curves(base + "_cae1.json")
    assert np.isfinite(curves["validate"][0]["lesion_assd"])
    assert curves["training"][0]["lesion_assd"] == float("inf")

    state, header = checkpoint.load_checkpoint(base + "_cae1.model")
    assert header == CONFIG
    model, jvars = jax_load_model(base + "_cae1.model")
    valid = learner._dataloader_validation
    sample = valid.dataset.stack(valid.indices[:1])
    args = (sample["images"], sample["labels"], sample["clinical"])
    want = model.apply(jvars, _jax_dto(*args), JAX_GTRUTH, False)
    port, _ = load_model(base + "_cae1.model", "cpu")
    with torch.inference_mode():
        _assert_outputs_close(port(_port_dto(*args)), want)
