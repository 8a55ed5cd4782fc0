"""Port parity: the CAE (models/cae3d.py) and its layers, with weights carried
across from the JAX model by models/convert.py, against the JAX package on
the CPU (lax path; one z-SAME block also against its s2d Pallas path in
interpret mode), and the CAE checkpoints in both directions.

Latents and reconstructions agree to 1e-5 (the U-Net's bar): float32 on
both sides, BN folded into the z-SAME and fc convs on the port and applied
before them in JAX.  The transposed convs, where the port flips the kernel
for torch, agree to 1e-6."""

import flax
import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stroke_prediction_tpu.core.dto import BRANCH_BOTH as JAX_BOTH
from stroke_prediction_tpu.core.dto import BRANCH_GTRUTH as JAX_GTRUTH
from stroke_prediction_tpu.inference import (
    cae_dto_from_batch as jax_cae_dto_from_batch)
from stroke_prediction_tpu.models import cae3d as jax_cae3d
from stroke_prediction_tpu.models import layers as jax_layers
from stroke_prediction_tpu.models.factory import load_model as jax_load_model
from stroke_prediction_tpu.ops.pallas.s2d import s2d_pack, s2d_unpack
from stroke_prediction_tpu.train import checkpoint as jax_checkpoint
from stroke_prediction_tpu_torch.core.dto import BRANCH_BOTH
from stroke_prediction_tpu_torch.inference import cae_dto_from_batch
from stroke_prediction_tpu_torch.models import layers
from stroke_prediction_tpu_torch.models.cae3d import (
    Cae3D, Dec3D, Enc3D, cae_latent_spatial)
from stroke_prediction_tpu_torch.models.convert import (
    save_cae_checkpoint, state_from_jax, state_to_jax)
from stroke_prediction_tpu_torch.models.factory import build_model, load_model

from test_torch_unet import _random_variables

torch.set_num_threads(1)

CHANNELS = (1, 2, 3, 4, 5, 6, 1)
SPATIAL = (28, 64, 64)          # the smallest (D, H, W) the CAE takes
TOL = dict(atol=1e-5, rtol=0)
FIELDS = ("core", "penu", "lesion", "interpolation")


def _config(step):
    return {"kind": "cae3d", "channels": list(CHANNELS), "n_ch_global": 5,
            "step": step}


def _case():
    """Three random masks (core, penumbra, lesion) and a clinical vector
    (tO -> tA 2.5 h, tA -> tR 3 h)."""
    rs = np.random.RandomState(1)
    labels = (rs.rand(1, *SPATIAL, 3) > 0.6).astype(np.float32)
    clinical = np.array([[2.5, 3.0, 0.2, 0.4, 0.6]], np.float32)
    return labels, clinical


def _jax_run(step, seed):
    """A JAX CAE with random weights and BN statistics, and its outputs on
    ``_case()``.  The step model regresses its step (no time given), which
    also creates its head's parameters."""
    enc = (jax_cae3d.Enc3DStep if step else jax_cae3d.Enc3D)(
        channels=CHANNELS, n_ch_global=5)
    model = jax_cae3d.Cae3D(enc=enc, dec=jax_cae3d.Dec3D(channels=CHANNELS,
                                                         n_ch_global=5))
    labels, clinical = _case()
    dto = jax_cae_dto_from_batch(None, jnp.asarray(labels),
                                 jnp.asarray(clinical), learn_step=step)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), dto,
                                               JAX_GTRUTH, False))
    variables = _random_variables(shapes, np.random.RandomState(seed))
    return model, variables, model.apply(variables, dto, JAX_GTRUTH, False)


@pytest.fixture(scope="module")
def jax_cae():
    return _jax_run(False, 0)


@pytest.fixture(scope="module")
def jax_cae_step():
    return _jax_run(True, 3)


def _port_outputs(model, step=False):
    labels, clinical = _case()
    with torch.inference_mode():
        return model(cae_dto_from_batch(
            None, torch.from_numpy(labels), torch.from_numpy(clinical),
            learn_step=step))


def _port_model(variables, step):
    model = build_model(_config(step)).eval()
    model.load_state_dict(state_from_jax(variables, _config(step)))
    return model


def _assert_outputs_equal(got, want):
    for part in ("latents", "reconstructions"):
        for f in FIELDS:
            a = getattr(getattr(got, part).gtruth, f).numpy()
            b = np.asarray(getattr(getattr(want, part).gtruth, f))
            assert a.shape == b.shape, (part, f)
            np.testing.assert_allclose(a, b, err_msg=f"{part} {f}", **TOL)


@pytest.mark.parametrize("spatial,latent", [
    ((28, 128, 128), (1, 10, 10)), ((28, 64, 64), (1, 2, 2)),
    ((36, 96, 80), (2, 6, 4))])
def test_cae_latent_spatial_goldens(spatial, latent):
    assert cae_latent_spatial(spatial) == latent
    assert jax_cae3d.cae_latent_spatial(spatial) == latent


def _random_init(module, *args):
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0),
                                                *args))
    return _random_variables(shapes, np.random.RandomState(5))


@pytest.mark.parametrize("ksize,stride", [(3, 1), (3, 2), (2, 2)])
def test_conv_transpose3d_matches_jax(ksize, stride):
    """Random, non-symmetric kernels: a kernel that the port forgot to flip
    (torch's conv_transpose flips it, JAX's does not) fails by far."""
    x = np.random.RandomState(2).standard_normal((2, 3, 4, 5, 3)).astype(
        np.float32)
    ref = jax_layers.ConvTranspose3d(4, (ksize,) * 3, (stride,) * 3)
    variables = _random_init(ref, jnp.asarray(x))
    want = np.asarray(ref.apply(variables, jnp.asarray(x)))
    port = layers.ConvTranspose3d(3, 4, (ksize,) * 3, (stride,) * 3)
    port.load_state_dict({
        k: torch.from_numpy(np.asarray(v))
        for k, v in variables["params"]["ConvTranspose_0"].items()})
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (
        2, *((n - 1) * stride + ksize for n in (3, 4, 5)), 4)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def _block_state(variables):
    """The port's BN -> conv state dict (``bn.*``, ``conv.*``) from the
    flax tree of one block (``BatchNorm_0/BatchNorm_0``, ``Conv3d_0``)."""
    p, s = variables["params"], variables["batch_stats"]
    bn_p = p["BatchNorm_0"]["BatchNorm_0"]
    bn_s = s["BatchNorm_0"]["BatchNorm_0"]
    tree = {"conv.kernel": p["Conv3d_0"]["kernel"],
            "conv.bias": p["Conv3d_0"]["bias"],
            "bn.scale": bn_p["scale"], "bn.bias": bn_p["bias"],
            "bn.mean": bn_s["mean"], "bn.var": bn_s["var"]}
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def _port_block(variables, ci, co, **kw):
    block = layers.BnConvActBlock(ci, co, act="elu", act_param=1.0, **kw)
    block.load_state_dict(_block_state(variables))
    return block.eval()


@pytest.mark.parametrize("padding,shape", [
    ((1, 1, 1), (1, 7, 12, 10, 3)), ((1, 1, 1), (2, 6, 9, 9, 2)),
    ("VALID", (1, 7, 13, 12, 3))])
def test_stride2_block_matches_jax(padding, shape):
    """BN -> stride-2 3^3 conv -> ELU: the BN output zero-padded by one
    (or not, VALID), then cuDNN's strided conv, against JAX's stride-1
    conv and slice."""
    x = np.random.RandomState(3).standard_normal(shape).astype(np.float32)
    ref = jax_layers.BnConvActBlock(5, strides=(2, 2, 2), padding=padding,
                                    act="elu", act_param=1.0)
    variables = _random_init(ref, jnp.asarray(x), False)
    want = np.asarray(ref.apply(variables, jnp.asarray(x), False))
    port = _port_block(variables, shape[-1], 5, strides=(2, 2, 2),
                       padding=padding)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("ci,co,shape", [(4, 3, (1, 5, 7, 6)),
                                         (2, 2, (2, 6, 5, 8))])
def test_decoder_padded_conv_block_matches_jax(ci, co, shape):
    """The decoder's BN -> (1, 2, 2)-padded 3^3 conv -> ELU: BN applied and
    its output zero-padded (it cannot fold: the pad zeros are BN outputs),
    then K1 in z-SAME mode with the raw kernel and bias."""
    x = np.random.RandomState(6).standard_normal(shape + (ci,)).astype(
        np.float32)

    class JaxBlock(nn.Module):
        @nn.compact
        def __call__(self, v):
            v = jax_layers.BatchNorm()(v, use_running_average=True)
            return jax_layers.elu(jax_layers.Conv3d(
                co, (3, 3, 3), padding=(1, 2, 2))(v), 1.0)

    ref = JaxBlock()
    variables = _random_init(ref, jnp.asarray(x))
    want = np.asarray(ref.apply(variables, jnp.asarray(x)))
    state = _block_state(variables)
    bn = layers.BatchNorm(ci)
    conv = layers.Conv3d(ci, co, padding=(1, 2, 2))
    for module, pre in ((bn, "bn."), (conv, "conv.")):
        module.load_state_dict({k[len(pre):]: v for k, v in state.items()
                                if k.startswith(pre)})
    with torch.no_grad():
        got = conv(bn.eval()(torch.from_numpy(x)), "elu", 1.0).numpy()
    assert got.shape == want.shape == (shape[0], shape[1], shape[2] + 2,
                                       shape[3] + 2, co)
    np.testing.assert_allclose(got, want, **TOL)


def test_zsame_block_matches_s2d_pallas(monkeypatch):
    """The encoder's BN -> z-SAME conv -> ELU block (BN folded with a
    per-plane bias table, K1 in 's' mode) against the JAX package's s2d
    path, the Pallas kernel in interpret mode."""
    monkeypatch.setenv("STROKE_TPU_CONV_IMPL", "pallas_s2d")
    x = np.random.RandomState(8).standard_normal((1, 6, 9, 10, 3)).astype(
        np.float32)
    ref = jax_layers.BnConvActBlock(4, padding=(1, 0, 0), act="elu",
                                    act_param=1.0)
    variables = _random_init(ref, jnp.asarray(x), False)
    want = np.asarray(s2d_unpack(ref.apply(
        variables, s2d_pack(jnp.asarray(x)), False)))
    port = _port_block(variables, 3, 4, padding=(1, 0, 0))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 6, 7, 8, 4)
    np.testing.assert_allclose(got, want, **TOL)


def test_cae3d_matches_jax(jax_cae):
    """Every latent and reconstruction of the gtruth branch (three encodes,
    the interpolation, four decodes) at the case's time to treatment."""
    _, variables, want = jax_cae
    got = _port_outputs(_port_model(variables, False))
    assert got.latents.gtruth.core.shape == (1, 1, 2, 2, 6)
    assert got.reconstructions.gtruth.core.shape == (1, *SPATIAL, 1)
    _assert_outputs_equal(got, want)


def test_cae3d_both_branches_match_jax(jax_cae):
    """The inputs branch (core and penumbra from the images' channels 0 and
    1: U-Net segmentations) beside the gtruth branch."""
    model, variables, _ = jax_cae
    labels, clinical = _case()
    images = np.random.RandomState(2).rand(1, *SPATIAL, 2).astype(
        np.float32)
    want = model.apply(variables, jax_cae_dto_from_batch(
        jnp.asarray(images), jnp.asarray(labels), jnp.asarray(clinical),
        inputs_from_images=True), JAX_BOTH, False)
    with torch.inference_mode():
        got = _port_model(variables, False)(cae_dto_from_batch(
            torch.from_numpy(images), torch.from_numpy(labels),
            torch.from_numpy(clinical), inputs_from_images=True),
            BRANCH_BOTH)
    _assert_outputs_equal(got, want)
    for part in ("latents", "reconstructions"):
        for f in ("core", "penu", "interpolation"):
            np.testing.assert_allclose(
                getattr(getattr(got, part).inputs, f).numpy(),
                np.asarray(getattr(getattr(want, part).inputs, f)),
                err_msg=f"inputs {part} {f}", **TOL)
        assert getattr(got, part).inputs.lesion is None


def test_interpolation_endpoints(jax_cae):
    """A step of 0 h gives the core latent, a step of the whole
    normalization (10 h - tO -> tA) the penumbra latent."""
    _, variables, _ = jax_cae
    model = _port_model(variables, False)
    labels, clinical = _case()
    for hours, end in ((0.0, "core"), (10.0 - 2.5, "penu")):
        with torch.inference_mode():
            out = model(cae_dto_from_batch(None, torch.from_numpy(labels),
                                           torch.from_numpy(clinical),
                                           hours))
        lat = out.latents.gtruth
        torch.testing.assert_close(lat.interpolation, getattr(lat, end),
                                   atol=1e-6, rtol=0)


def test_enc3d_step_head_matches_jax(jax_cae_step):
    """Enc3DStep with no time to treatment: the clinical head's step and
    everything downstream of it."""
    _, variables, want = jax_cae_step
    got = _port_outputs(_port_model(variables, True), step=True)
    step = got.given_variables.time_to_treatment
    assert step.shape == (1, 1)
    np.testing.assert_allclose(
        step.numpy(), np.asarray(want.given_variables.time_to_treatment),
        atol=1e-6, rtol=0)
    _assert_outputs_equal(got, want)


@pytest.mark.parametrize("step", [False, True])
def test_cae_state_round_trip(jax_cae, jax_cae_step, step):
    _, variables, _ = jax_cae_step if step else jax_cae
    sd = state_from_jax(variables, _config(step))
    assert set(sd) == set(build_model(_config(step)).state_dict())
    back = state_to_jax(sd, _config(step))
    flat_a = jax.tree_util.tree_leaves_with_path(variables)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)


@pytest.mark.parametrize("step", [False, True])
def test_jax_cae_checkpoint_loads_in_port(jax_cae, jax_cae_step, step,
                                          tmp_path):
    _, variables, want = jax_cae_step if step else jax_cae
    path = str(tmp_path / "cae.model")
    jax_checkpoint.save_checkpoint(path, variables, _config(step))
    model, config = load_model(path, "cpu")
    assert config == _config(step)
    assert type(model.enc).__name__ == ("Enc3DStep" if step else "Enc3D")
    _assert_outputs_equal(_port_outputs(model, step), want)


def test_port_cae_checkpoint_runs_in_jax(tmp_path):
    """A CAE saved by the port (seeded init, random BN statistics) rebuilds
    in the JAX factory and gives the port's outputs."""
    gen = torch.Generator().manual_seed(0)
    port = Cae3D(Enc3D(CHANNELS, generator=gen),
                 Dec3D(CHANNELS, generator=gen)).eval()
    with torch.no_grad():
        for m in port.modules():
            if isinstance(m, layers.BatchNorm):
                m.scale.uniform_(0.7, 1.3, generator=gen)
                m.bias.uniform_(-0.3, 0.3, generator=gen)
                m.mean.uniform_(-0.3, 0.3, generator=gen)
                m.var.uniform_(0.5, 1.5, generator=gen)
    path = str(tmp_path / "port_cae.model")
    save_cae_checkpoint(path, port)
    model, variables = jax_load_model(path)
    labels, clinical = _case()
    want = model.apply(variables, jax_cae_dto_from_batch(
        None, jnp.asarray(labels), jnp.asarray(clinical)), JAX_GTRUTH,
        False)
    _assert_outputs_equal(_port_outputs(port), want)


def test_step_checkpoint_without_head(jax_cae, tmp_path):
    """A ``step: true`` tree without the head (flax creates it at its first
    call, so a tree initialised with a time to treatment has none) loads
    without one: it gives JAX's outputs at a given time, raises where it
    would regress the step, as JAX does, and saves back without a head."""
    model_ref, variables, want = jax_cae
    path = str(tmp_path / "headless.model")
    jax_checkpoint.save_checkpoint(path, variables, _config(True))
    model, config = load_model(path, "cpu")
    assert type(model.enc).__name__ == "Enc3DStep"
    assert model.enc.step_head is None
    _assert_outputs_equal(_port_outputs(model), want)
    with pytest.raises(ValueError, match="no step head"):
        _port_outputs(model, step=True)

    jax_model, jax_vars = jax_load_model(path)
    labels, clinical = _case()
    with pytest.raises(flax.errors.ScopeParamNotFoundError):
        jax_model.apply(jax_vars, jax_cae_dto_from_batch(
            None, jnp.asarray(labels), jnp.asarray(clinical),
            learn_step=True), JAX_GTRUTH, False)

    back = str(tmp_path / "headless_back.model")
    save_cae_checkpoint(back, model)
    _, tree = jax_load_model(back)
    flat_a = jax.tree_util.tree_leaves_with_path(variables)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(tree))
    assert len(flat_a) == len(flat_b)
    for p, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[p]), leaf)
