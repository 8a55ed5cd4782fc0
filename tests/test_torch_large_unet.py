"""Port parity for the 4-scale U-Net (``LargeUnet3D``, kind
``large_unet3d``): the model with weights carried across from the JAX model
(models/convert.py), its checkpoints in both packages' factories, the
learner's header and resume, and both packages' tester CLIs on one
checkpoint, against the JAX package on the CPU (its lax path, and its s2d
path with the Pallas kernels in interpret mode for the bfloat16 forward).

Channels (2, 3, 4, 5, 6, 5, 4, 3, 4, 2) on a 92^3 input (output 4^3), the
JAX package's own golden shape.  Tolerances: the evaluation forward 1e-5
(float32 on both sides, BN folded into the conv on the port); the training
step against JAX run in float64 at ``test_torch_train.TRAIN_STEP_TOL``'s
float64 limits; the bfloat16 forward's error against JAX's float32 output
at most ``BF16_VS_JAX`` times the JAX bfloat16 s2d path's own."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stroke_prediction_tpu.cli import common as jax_common
from stroke_prediction_tpu.cli import test_unet_segmentation as jax_cli
from stroke_prediction_tpu.data import dataset as jax_dataset
from stroke_prediction_tpu.eval import metrics as jax_metrics
from stroke_prediction_tpu.models import layers as jax_layers
from stroke_prediction_tpu.models import unet3d as jax_unet3d
from stroke_prediction_tpu.models.factory import load_model as jax_load
from stroke_prediction_tpu.models.unet3d import LargeUnet3D as JaxLargeUnet
from stroke_prediction_tpu.train import checkpoint as jax_checkpoint
from stroke_prediction_tpu.utils.args import UnetParser as JaxUnetParser
from stroke_prediction_tpu_torch.cli import common as port_common
from stroke_prediction_tpu_torch.cli import test_unet_segmentation as port_cli
from stroke_prediction_tpu_torch.data import dataset
from stroke_prediction_tpu_torch.data.loader import (
    get_stroke_shape_training_data)
from stroke_prediction_tpu_torch.models import LargeUnet3D
from stroke_prediction_tpu_torch.models.convert import (
    _key_map, save_unet_checkpoint, state_from_jax, state_to_jax)
from stroke_prediction_tpu_torch.models.factory import build_model, load_model
from stroke_prediction_tpu_torch.models.unet3d import unet_output_spatial
from stroke_prediction_tpu_torch.train.optim import make_optimizer
from stroke_prediction_tpu_torch.train.unet_learner import (
    UnetSegmentationLearner)
from stroke_prediction_tpu_torch.utils import checkpoint
from stroke_prediction_tpu_torch.utils.args import get_args_unet_training

from test_torch_train import (
    TRAIN_STEP_TOL, _Float64Numpy, _jax_loss, _leaf, _port_loss,
    _random_variables)

torch.set_num_threads(1)

CHANNELS = (2, 3, 4, 5, 6, 5, 4, 3, 4, 2)
CONFIG = {"kind": "large_unet3d", "channels": list(CHANNELS)}
SPATIAL = (92, 92, 92)
PAD = (44, 44, 44)
# the port's bfloat16 forward: its max error against JAX's float32 output
# at most this factor of JAX's own bfloat16 s2d forward's
BF16_VS_JAX = 2.0


@pytest.fixture(scope="module")
def variables():
    shapes = jax.eval_shape(lambda: JaxLargeUnet(channels=CHANNELS).init(
        jax.random.PRNGKey(0), jnp.zeros((1,) + SPATIAL + (2,)),
        train=False))
    return _random_variables(shapes, np.random.RandomState(0))


def _images(n=1, seed=1):
    return (np.random.RandomState(seed).rand(n, *SPATIAL, 2)
            * 2).astype(np.float32)


def _port(variables, dtype=torch.float32):
    model = LargeUnet3D(CHANNELS, compute_dtype=dtype)
    model.load_state_dict(state_from_jax(variables, CONFIG))
    return model


def _jax_eval(variables, x, dtype=jnp.float32):
    model = JaxLargeUnet(channels=CHANNELS, compute_dtype=dtype)
    return np.asarray(jax.jit(lambda v, a: model.apply(v, a, train=False))(
        variables, jnp.asarray(x)))


@pytest.mark.parametrize("spatial,out", [
    ((92, 92, 92), (4, 4, 4)),
    ((116, 220, 220), (28, 132, 132)),
    ((116, 124, 124), (28, 36, 36)),
])
def test_large_unet_output_spatial(spatial, out):
    """Four scales: the input less 88 where the pools divide evenly."""
    assert unet_output_spatial(spatial, 4) == out
    assert jax_unet3d.unet_output_spatial(spatial, 4) == out


def test_factory_builds_large_unet3d():
    model = build_model(CONFIG)
    assert isinstance(model, LargeUnet3D)
    assert model.config == CONFIG
    assert len(model.blocks) == 7
    assert set(model.state_dict()) == {k for _, k in _key_map(CONFIG)}


def test_large_unet3d_matches_jax(variables):
    """Evaluation forward (running statistics) within 1e-5."""
    x = _images()
    want = _jax_eval(variables, x)
    with torch.inference_mode():
        got = _port(variables).eval()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 4, 4, 4, 2)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_large_unet3d_bfloat16_matches_s2d(variables, monkeypatch):
    """The bfloat16 forward against the JAX package's bfloat16 s2d path
    (Pallas kernels in interpret mode): the port's error against JAX's
    float32 output at most ``BF16_VS_JAX`` times JAX's own."""
    x = _images(seed=2)
    ref = _jax_eval(variables, x)
    monkeypatch.setenv("STROKE_TPU_CONV_IMPL", "pallas_s2d")
    jax_bf16 = _jax_eval(variables, x, jnp.bfloat16)
    with torch.inference_mode():
        got = _port(variables, torch.bfloat16).eval()(
            torch.from_numpy(x)).numpy()
    jax_err = np.abs(jax_bf16 - ref).max()
    port_err = np.abs(got - ref).max()
    assert got.dtype == np.float32 and 0 < jax_err < 1e-1
    assert port_err <= BF16_VS_JAX * jax_err, (port_err, jax_err)


def test_state_round_trip(variables):
    sd = state_from_jax(variables, CONFIG)
    assert set(sd) == set(LargeUnet3D(CHANNELS).state_dict())
    back = state_to_jax(sd, CONFIG)
    flat_a = jax.tree_util.tree_leaves_with_path(variables)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b) == 7 * 2 * 6 + 2 * 2
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)


def _jax_train_step64(variables, imgs, labs):
    """value_and_grad of the learner's loss at train=True, JAX in float64
    (lax path) -> (loss, grads, new batch_stats)."""
    model = JaxLargeUnet(channels=CHANNELS, compute_dtype=jnp.float64)

    @jax.jit
    def step(params, batch_stats, imgs, labs):
        def loss_fn(p):
            seg, mut = model.apply({"params": p, "batch_stats": batch_stats},
                                   imgs, train=True, mutable=["batch_stats"])
            return _jax_loss(seg, labs), mut
        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    f64 = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda a: jnp.asarray(a, jnp.float64), t)
    (loss, mut), grads = step(f64(variables["params"]),
                              f64(variables["batch_stats"]),
                              jnp.asarray(imgs, jnp.float64),
                              jnp.asarray(labs, jnp.float64))
    return (float(loss), jax.tree_util.tree_map(np.asarray, grads),
            jax.tree_util.tree_map(np.asarray, mut["batch_stats"]))


def test_large_unet_train_step_float64_matches_jax(variables, monkeypatch):
    """One float64 training step (batch 2) from the same variables: the
    loss, all 60 parameter gradients and the new running statistics."""
    rs = np.random.RandomState(3)
    imgs = (rs.rand(2, *SPATIAL, 2) * 4).astype(np.float32)
    labs = (rs.rand(2, 4, 4, 4, 2) > 0.5).astype(np.float32)
    for mod in (jax_layers, jax_unet3d, jax_metrics):
        monkeypatch.setattr(mod, "jnp", _Float64Numpy())
    jax.config.update("jax_enable_x64", True)
    try:
        want_loss, grads, want_stats = _jax_train_step64(variables, imgs,
                                                         labs)
    finally:
        jax.config.update("jax_enable_x64", False)
    tol_loss, tol_grad, tol_stats = TRAIN_STEP_TOL["float64"]

    port = _port(variables, torch.float64).train().to(torch.float64)
    loss = _port_loss(port(torch.from_numpy(imgs)),
                      torch.from_numpy(labs).double())
    loss.backward()
    assert abs(float(loss.detach()) - want_loss) <= tol_loss
    named = dict(port.named_parameters())
    buffers = dict(port.named_buffers())
    n_grads = 0
    for path, key in _key_map(CONFIG):
        if path[0] == "params":
            ref = _leaf(grads, path[1:])
            err = np.abs(named[key].grad.numpy() - ref).max()
            assert err <= tol_grad * np.abs(ref).max(), (key, err)
            n_grads += 1
        else:
            np.testing.assert_allclose(buffers[key].numpy(),
                                       _leaf(want_stats, path[1:]),
                                       atol=tol_stats, rtol=0, err_msg=key)
    assert n_grads == len(named) == 7 * 2 * 4 + 2 * 2


def test_jax_checkpoint_loads_in_port(variables, tmp_path):
    """A ``large_unet3d`` ``.model`` written by the JAX package rebuilds in
    the port's factory and gives JAX's output."""
    path = str(tmp_path / "jax_large.model")
    jax_checkpoint.save_checkpoint(path, variables, CONFIG)
    x = _images(seed=4)
    want = _jax_eval(variables, x)
    model, config = load_model(path, "cpu")
    assert config == CONFIG and isinstance(model, LargeUnet3D)
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def _seeded_port(seed=5):
    model = LargeUnet3D(CHANNELS, generator=torch.Generator().manual_seed(
        seed))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in model.modules():
            if hasattr(m, "var"):                    # BatchNorm
                m.mean.uniform_(-0.3, 0.3, generator=gen)
                m.var.uniform_(0.5, 1.5, generator=gen)
    return model.eval()


def test_port_checkpoint_loads_in_jax(tmp_path):
    """A ``large_unet3d`` ``.model`` written by the port rebuilds in the JAX
    factory as a ``LargeUnet3D`` and gives the port's output."""
    port = _seeded_port()
    path = str(tmp_path / "port_large.model")
    save_unet_checkpoint(path, port)
    model, jax_vars = jax_load(path)
    assert isinstance(model, JaxLargeUnet)
    assert checkpoint.load_checkpoint(path)[1] == CONFIG
    x = _images(seed=6)
    want = np.asarray(model.apply(jax_vars, jnp.asarray(x), train=False))
    with torch.inference_mode():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def _learner(tmp_path, n_epochs, previous=None):
    ds = dataset.StrokeDataset3D(
        dataset.SyntheticCaseProvider(n_cases=4, shape_xyz=(8, 8, 4), seed=2,
                                      cache_dir=str(tmp_path / "cache")),
        [dataset.MOD_CBV, dataset.MOD_TTD],
        [dataset.LABEL_CORE, dataset.LABEL_PENU], resample=0.5, pad=PAD)
    train, valid = get_stroke_shape_training_data(ds, range(4), 0.5, seed=3,
                                                  batchsize=2)
    model = LargeUnet3D(CHANNELS, generator=torch.Generator().manual_seed(7))
    opt = make_optimizer(model.parameters(), 1e-3, betas=(0.99, 0.999),
                         weight_decay=1e-5)
    return UnetSegmentationLearner(
        train, valid, model, opt, None, n_epochs=n_epochs,
        patch_whd=SPATIAL, pad_xyz=PAD, path_previous_base=previous,
        path_outputs_base=str(tmp_path / "large"), device="cpu")


def test_learner_writes_large_unet3d_and_resumes(tmp_path, capsys):
    """The U-Net learner on a ``LargeUnet3D`` writes kind ``large_unet3d``
    (the JAX learner writes ``unet3d`` for any model: ROADMAP §3), and a
    learner resumes from that snapshot with the same weights."""
    learner = _learner(tmp_path, 1)
    learner.run_training()
    base = str(tmp_path / "large_unet")
    for suffix in ("", "_final"):
        assert checkpoint.load_checkpoint(
            base + suffix + ".model")[1] == CONFIG, suffix
    model, _ = load_model(base + "_final.model", "cpu")
    assert isinstance(model, LargeUnet3D)
    capsys.readouterr()
    resumed = _learner(tmp_path, 2, previous=str(tmp_path / "large"))
    assert "Continue training" in capsys.readouterr().out
    assert resumed.get_start_epoch() == 1
    want = state_from_jax(checkpoint.load_checkpoint(base + ".model")[0],
                          CONFIG)
    for k, v in resumed._model.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0)
    resumed.run_training()
    assert resumed.step_counts["train"] == 1


def test_tester_clis_match_on_a_large_unet3d_checkpoint(variables, tmp_path,
                                                        capsys, monkeypatch):
    """Both packages' U-Net tester CLIs on one ``large_unet3d`` checkpoint
    (JAX-written) at 92^3 images: the same ``Case Id`` lines."""
    ckpt = str(tmp_path / "large.model")
    jax_checkpoint.save_checkpoint(ckpt, variables, CONFIG)
    common = [ckpt, "--synthetic", "--xyoriginal", "8", "--zsize", "4",
              "--padding", "44", "44", "44", "--fold", "0", "1"]

    def jax_provider(**kw):
        return jax_dataset.SyntheticCaseProvider(
            **{**kw, "cache_dir": str(tmp_path / "jax_cache")})

    monkeypatch.setattr(jax_common, "SyntheticCaseProvider", jax_provider)
    jax_cli.test(JaxUnetParser().parse_args(
        common + ["--outbasepath", str(tmp_path / "jax")]))
    jax_out = capsys.readouterr().out
    monkeypatch.setattr(port_common, "synthetic_cache_dir",
                        lambda: str(tmp_path / "port_cache"))
    tester = port_cli.test(get_args_unet_training(
        common + ["--outbasepath", str(tmp_path / "port"),
                  "--device", "cpu"]))
    port_out = capsys.readouterr().out

    def case_lines(out):
        return [ln for ln in out.splitlines() if ln.startswith("Case Id")]

    assert isinstance(tester._model, LargeUnet3D)
    assert len(case_lines(jax_out)) == 2
    assert case_lines(port_out) == case_lines(jax_out)
