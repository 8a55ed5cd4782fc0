"""Port parity for the tester slice end to end: checkpoint files both ways,
the numpy data layer, the import rules of the port, and the full-volume
U-Net tester CLI run on the CPU by both packages on the same checkpoint."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from stroke_prediction_tpu.cli import common as jax_common
from stroke_prediction_tpu.cli import test_unet_segmentation as jax_cli
from stroke_prediction_tpu.data import dataset as jax_dataset
from stroke_prediction_tpu.data import loader as jax_loader
from stroke_prediction_tpu.models.unet3d import Unet3D as JaxUnet3D
from stroke_prediction_tpu.train import checkpoint as jax_checkpoint
from stroke_prediction_tpu.utils.args import SDMParser as JaxSDMParser
from stroke_prediction_tpu.utils.args import UnetParser as JaxUnetParser
from stroke_prediction_tpu.utils.args import (
    get_args_shape_testing as jax_get_args_shape_testing)
from stroke_prediction_tpu.utils.nifti import read_nifti
from stroke_prediction_tpu_torch.cli import common as port_common
from stroke_prediction_tpu_torch.cli import test_sdm_resampling as sdm_cli
from stroke_prediction_tpu_torch.cli import test_unet_segmentation as port_cli
from stroke_prediction_tpu_torch.data import dataset, loader
from stroke_prediction_tpu_torch.device import resolve_device
from stroke_prediction_tpu_torch.models.convert import save_unet_checkpoint
from stroke_prediction_tpu_torch.models.factory import build_model, load_model
from stroke_prediction_tpu_torch.models.layers import Conv3d
from stroke_prediction_tpu_torch.models.unet3d import Unet3D
from stroke_prediction_tpu_torch.parallel import distributed
from stroke_prediction_tpu_torch.utils import checkpoint
from stroke_prediction_tpu_torch.utils.args import (
    PARALLEL_FLAGS, get_args_sdm, get_args_shape_prediction_training,
    get_args_shape_training, get_args_step_training, get_args_unet_testing,
    get_args_shape_testing, get_args_unet_training)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CHANNELS = (2, 4, 6, 8, 6, 4, 6, 2)


def _tree(rs):
    """A checkpoint-like tree touching every msgpack form the codec has:
    fix/8/16/32-bit lengths of str, bin, array, map and ext, ints of every
    width, floats, bools, nil and numpy scalars."""
    return {
        "params": {f"layer_{i}": {"kernel": rs.rand(2, 3).astype(np.float32)}
                   for i in range(17)},                       # map16
        "big": rs.rand(20000).astype(np.float32),             # ext32
        "mid": rs.rand(100).astype(np.float64),               # ext16
        "ints": rs.randint(-5, 5, size=(3, 4)).astype(np.int32),
        "u8": np.arange(3, dtype=np.uint8),
        "scalar": np.float32(1.5),                            # ext type 3
        "count": np.int32(7),
        "py": [0, 127, 128, 255, 256, 65536, 2 ** 33, -1, -32, -33, -200,
               -40000, -2 ** 40, 1.25, True, False, None, "x" * 40,
               "y" * 300, b"\x00\x01"] + list(range(20)),     # array16
    }


def _assert_tree_equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_tree_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_tree_equal(x, y)
    elif isinstance(a, (np.ndarray, np.generic)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b and type(a) is type(b)


def test_msgpack_writer_is_byte_identical_to_flax():
    tree = _tree(np.random.RandomState(0))
    assert checkpoint.packb(tree) == serialization.msgpack_serialize(tree)
    _assert_tree_equal(checkpoint.unpackb(checkpoint.packb(tree)),
                       serialization.msgpack_restore(
                           serialization.msgpack_serialize(tree)))


def _array_tree(seed):
    """The tree without its Python leaves: checkpoints hold arrays only."""
    tree = _tree(np.random.RandomState(seed))
    del tree["py"]
    return tree


def test_checkpoint_from_jax_loads_in_port(tmp_path):
    tree = _array_tree(1)
    config = {"kind": "unet3d", "channels": list(CHANNELS)}
    path = str(tmp_path / "jax.model")
    jax_checkpoint.save_checkpoint(path, tree, config)
    state, got_config = checkpoint.load_checkpoint(path)
    assert got_config == config
    _assert_tree_equal(state, tree)


def test_checkpoint_from_port_loads_in_jax(tmp_path):
    tree = _array_tree(2)
    config = {"kind": "unet3d", "channels": list(CHANNELS)}
    path = str(tmp_path / "port.model")
    checkpoint.save_checkpoint(path, tree, config)
    state, got_config = jax_checkpoint.load_checkpoint(path)
    assert got_config == config
    _assert_tree_equal(tree, state)


def test_port_unet_checkpoint_runs_in_jax(tmp_path):
    """A U-Net saved by the port rebuilds in the JAX factory and gives the
    same probabilities (the port's CPU forward is the plain path)."""
    from stroke_prediction_tpu.models.factory import load_model as jax_load

    port = Unet3D(CHANNELS, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for m in port.modules():
            if hasattr(m, "var"):
                m.mean.uniform_(-0.2, 0.2)
                m.var.uniform_(0.6, 1.4)
    path = str(tmp_path / "port_unet.model")
    save_unet_checkpoint(path, port)
    model, variables = jax_load(path)
    x = np.random.RandomState(3).rand(1, 44, 44, 44, 2).astype(np.float32)
    want = np.asarray(model.apply(variables, jnp.asarray(x), train=False))
    loaded, config = load_model(path, "cpu")
    assert config == {"kind": "unet3d", "channels": list(CHANNELS)}
    with torch.inference_mode():
        got = loaded(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("kind", ["unet4d"])
def test_factory_refuses_unknown_kinds(kind):
    """A kind that neither package knows raises ``ValueError`` in both."""
    from stroke_prediction_tpu.models.factory import build_model as jax_build

    config = {"kind": kind, "channels": [1, 2, 3, 4, 5, 6, 1]}
    with pytest.raises(ValueError, match=f"Unknown model kind: {kind}"):
        build_model(config)
    with pytest.raises(ValueError, match=f"Unknown model kind: {kind}"):
        jax_build(config)


def test_factory_loads_a_jax_cae3d_ctp_checkpoint(tmp_path):
    """A ``cae3d_ctp`` checkpoint written by the JAX package (random weights
    and BN statistics, padding (2, 3, 4)) rebuilds in the port's factory as
    a ``Cae3DCtp`` with that padding and gives JAX's latents and
    reconstructions (evaluation mode, 1e-5)."""
    from stroke_prediction_tpu.core.dto import BRANCH_GTRUTH
    from stroke_prediction_tpu.inference import (
        cae_dto_from_batch as jax_dto)
    from stroke_prediction_tpu.models import cae3d as jax_cae3d
    from stroke_prediction_tpu_torch.inference import cae_dto_from_batch
    from stroke_prediction_tpu_torch.models.cae3d import Cae3DCtp

    from test_torch_unet import _random_variables

    channels, pad = (3, 2, 3, 4, 5, 6, 1), (2, 3, 4)
    config = {"kind": "cae3d_ctp", "channels": list(channels),
              "n_ch_global": 5, "step": False, "padding": list(pad)}
    rs = np.random.RandomState(4)
    labels = (rs.rand(1, 28, 64, 64, 3) > 0.6).astype(np.float32)
    images = rs.uniform(0, 3, (1, 32, 70, 72, 2)).astype(np.float32)
    clinical = np.array([[2.5, 3.0, 0.2, 0.4, 0.6]], np.float32)
    model = jax_cae3d.Cae3DCtp(
        enc=jax_cae3d.Enc3DCtp(channels=channels, padding=pad),
        dec=jax_cae3d.Dec3D(channels=channels))
    dto = jax_dto(jnp.asarray(images), jnp.asarray(labels),
                  jnp.asarray(clinical), inputs_from_images=True)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), dto,
                                               BRANCH_GTRUTH, False))
    variables = _random_variables(shapes, np.random.RandomState(6))
    want = model.apply(variables, dto, BRANCH_GTRUTH, False)
    path = str(tmp_path / "jax_ctp.model")
    jax_checkpoint.save_checkpoint(path, variables, config)

    port, got_config = load_model(path, "cpu")
    assert got_config == config and isinstance(port, Cae3DCtp)
    assert port.enc.padding == pad
    with torch.inference_mode():
        got = port(cae_dto_from_batch(
            torch.from_numpy(images), torch.from_numpy(labels),
            torch.from_numpy(clinical), inputs_from_images=True))
    for part in ("latents", "reconstructions"):
        for f in ("core", "penu", "lesion", "interpolation"):
            np.testing.assert_allclose(
                getattr(getattr(got, part).gtruth, f).numpy(),
                np.asarray(getattr(getattr(want, part).gtruth, f)),
                atol=1e-5, rtol=0, err_msg=f"{part} {f}")


def test_bare_3x3_conv_refused():
    """The bare conv forms that no ported model runs are refused when the
    layer is built: z padding of 2, a stride-2 conv with H/W-only padding,
    and a 2^3 kernel."""
    for kw in ({"padding": (2, 0, 0)},
               {"strides": (2, 2, 2), "padding": (0, 1, 1)},
               {"kernel_size": (2, 2, 2)}):
        with pytest.raises(NotImplementedError):
            Conv3d(2, 4, **kw)


@pytest.mark.parametrize("padding", ["VALID", (1, 0, 0), (1, 2, 2),
                                     (0, 1, 2)])
def test_bare_3x3_conv_matches_jax(padding):
    """A bare stride-1 3^3 conv (K1 on the zero-padded input; z-SAME mode
    for a z pad of one) against the JAX package's ``Conv3d``."""
    from stroke_prediction_tpu.models.layers import Conv3d as JaxConv3d

    rs = np.random.RandomState(11)
    x = rs.standard_normal((2, 5, 6, 7, 3)).astype(np.float32)
    kernel = rs.standard_normal((3, 3, 3, 3, 4)).astype(np.float32) * 0.2
    bias = rs.standard_normal(4).astype(np.float32)
    ref = JaxConv3d(4, (3, 3, 3), padding=padding)
    want = np.asarray(ref.apply({"params": {"kernel": kernel, "bias": bias}},
                                jnp.asarray(x)))
    conv = Conv3d(3, 4, padding=padding)
    conv.load_state_dict({"kernel": torch.from_numpy(kernel),
                          "bias": torch.from_numpy(bias)})
    with torch.no_grad():
        got = conv(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def tester_inputs(tmp_path_factory):
    """A tiny U-Net checkpoint and a synthetic case cache that the testers
    below share."""
    out = tmp_path_factory.mktemp("tester_flags")
    unet = str(out / "unet.model")
    _random_unet_checkpoint(unet)
    return out, unet


@pytest.mark.parametrize("flags", [
    ["--ndevices", "4"], ["--distributed"], ["--coordinator", "h:1"],
    ["--nprocs", "2"], ["--procid", "0"]])
def test_testers_take_and_ignore_runtime_flags(flags, tester_inputs,
                                               monkeypatch, capsys):
    """Each runtime flag of the data-parallel path parses where the JAX
    package's parser takes it.  The U-Net and SDM testers take it and run
    on one process, as the JAX testers, which build no mesh, do: nothing
    starts a rank or joins a process group, and each prints its one case.
    The shape-testing parser refuses it, as JAX's does.  U-Net training
    and the CAE training parsers (phase 1 and CTP, step learning, phase 2)
    read it; ``--distributed`` there needs its three addresses."""
    assert flags[0].lstrip("-") in PARALLEL_FLAGS
    out, unet = tester_inputs
    name = flags[0].lstrip("-")

    def refuse(*args, **kw):
        raise AssertionError("a tester started a data-parallel run")

    monkeypatch.setattr(port_common, "spawn_ranks", refuse)
    monkeypatch.setattr(distributed, "initialize", refuse)
    monkeypatch.setattr(port_common, "synthetic_cache_dir",
                        lambda: str(out / "cache"))
    base = str(out / name)
    args = get_args_unet_testing(
        [unet, *flags, "--synthetic", "--xyoriginal", "24", "--zsize", "24",
         "--fold", "0", "--channels", *map(str, CHANNELS), "--outbasepath",
         base, "--device", "cpu"])
    assert getattr(args, name) != PARALLEL_FLAGS[name]
    port_cli.test(args)
    args = get_args_sdm([*flags, "--synthetic", "--xyoriginal", "96",
                         "--zsize", "12", "--fold", "0", "--outbasepath",
                         base, "--device", "cpu"])
    assert getattr(args, name) != PARALLEL_FLAGS[name]
    sdm_cli.infer(args)
    printed = capsys.readouterr().out
    assert len(re.findall(r"^Case Id", printed, re.M)) == 1, printed
    assert "TO-->TR" in printed
    assert not torch.distributed.is_initialized()
    shape_argv = ["--path", "cae.model", "--fold", "0", *flags]
    with pytest.raises(SystemExit):
        get_args_shape_testing(shape_argv)
    monkeypatch.setattr(sys, "argv", ["prog", *shape_argv])
    with pytest.raises(SystemExit):
        jax_get_args_shape_testing()

    parsers = ((get_args_unet_training, ["unet.model"]),
               (get_args_shape_training, []),
               (get_args_step_training, ["cae.model"]),
               (get_args_shape_prediction_training, ["cae.model"]))
    for parse, positional in parsers:
        if flags == ["--distributed"]:
            with pytest.raises(SystemExit):
                parse([*positional, *flags])
            flags_full = [*flags, "--coordinator", "h:1", "--nprocs", "2",
                          "--procid", "1"]
            assert parse([*positional, *flags_full]).procid == 1
        else:
            args = parse([*positional, *flags])
            assert getattr(args, name) != PARALLEL_FLAGS[name]
    # the JAX parsers take the same command lines
    JaxUnetParser().parse_args(["unet.model", *flags])
    JaxSDMParser().parse_args(flags)


def test_profile_flag_parses():
    """``--profile LOGDIR`` is ported: it parses as in the JAX parser and
    no longer raises."""
    assert "profile" not in PARALLEL_FLAGS
    args = get_args_unet_training(["unet.model", "--profile", "logdir"])
    assert args.profile == "logdir"
    assert JaxUnetParser().parse_args(
        ["unet.model", "--profile", "logdir"]).profile == "logdir"


def test_dataset_and_loader_match_jax():
    kw = dict(n_cases=4, shape_xyz=(20, 18, 12), seed=9)
    mods = [dataset.MOD_CBV, dataset.MOD_TTD]
    labels = [dataset.LABEL_CORE, dataset.LABEL_PENU, dataset.LABEL_LESION]
    ds = dataset.StrokeDataset3D(dataset.SyntheticCaseProvider(**kw), mods,
                                 labels, resample=0.5, flip_split_id=1,
                                 pad=(3, 2, 1))
    ref = jax_dataset.StrokeDataset3D(jax_dataset.SyntheticCaseProvider(**kw),
                                      mods, labels, resample=0.5,
                                      flip_split_id=1, pad=(3, 2, 1))
    for i in range(4):
        a, b = ds.sample(i), ref.sample(i)
        for key in ("images", "labels", "clinical"):
            assert a[key].dtype == b[key].dtype
            assert a[key].tobytes() == b[key].tobytes(), (i, key)
    assert loader.fold_split(29, range(29), 0.3, 4) == \
        jax_loader.fold_split(29, range(29), 0.3, 4)
    ours = loader.get_testdata(ds, [3, 0, 2], seed=5)
    theirs = jax_loader.get_testdata(ref, [3, 0, 2], seed=5)
    for _ in range(2):
        assert ours.epoch_chunks() == theirs.epoch_chunks()


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_device(None)
        with pytest.raises(RuntimeError):
            resolve_device("cuda")
    with pytest.raises(ValueError):
        resolve_device("meta")


def _port_sources():
    return sorted((REPO / "stroke_prediction_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py"]


def test_port_imports_without_jax_and_never_the_jax_package():
    forbidden = re.compile(
        r"^\s*(from|import)\s+(jax|flax|optax|msgpack|"
        r"stroke_prediction_tpu(?!_torch))\b", re.M)
    for src in _port_sources():
        assert not forbidden.search(src.read_text()), src
    code = ("import sys, pkgutil, importlib\n"
            "for m in ('jax', 'flax', 'optax', 'msgpack', "
            "'stroke_prediction_tpu'):\n"
            "    sys.modules[m] = None\n"
            "import stroke_prediction_tpu_torch as p\n"
            "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
            "    importlib.import_module(m.name)\n"
            "print(' '.join(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = set(out.stdout.split())
    for mod in ("cli.train_unet_segmentation", "train.learner",
                "train.unet_learner", "train.optim", "data.augment",
                "ops.conv3x3", "ops.pooling", "models.convert",
                "models.cae3d", "eval.cae_tester",
                "cli.test_shape_reconstruction",
                "cli.test_shape_reconstruction_CurveAnalysis"):
        assert "stroke_prediction_tpu_torch." + mod in loaded, mod


def _random_unet_checkpoint(path):
    """A tiny JAX-format U-Net checkpoint with random weights and running
    statistics (shapes from eval_shape, values from numpy)."""
    shapes = jax.eval_shape(lambda: JaxUnet3D(channels=CHANNELS).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 44, 44, 44, 2)), train=False))
    rs = np.random.RandomState(0)

    def fill(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = fill(v)
            elif k == "var":
                out[k] = rs.uniform(0.5, 1.5, v.shape).astype(np.float32)
            else:
                out[k] = (rs.uniform(-0.3, 0.3, v.shape)
                          + (k == "scale")).astype(np.float32)
        return out

    jax_checkpoint.save_checkpoint(path, fill(shapes),
                                   {"kind": "unet3d",
                                    "channels": list(CHANNELS)})


def test_cli_end_to_end_matches_jax(tmp_path, capsys, monkeypatch):
    ckpt = str(tmp_path / "unet.model")
    _random_unet_checkpoint(ckpt)
    common = [ckpt, "--synthetic", "--xyoriginal", "24", "--zsize", "24",
              "--fold", "0", "1", "--seed", "7", "--channels",
              *map(str, CHANNELS)]

    # each side generates and caches its own cases under tmp_path
    def jax_provider(**kw):
        return jax_dataset.SyntheticCaseProvider(
            **{**kw, "cache_dir": str(tmp_path / "jax_cache")})

    monkeypatch.setattr(jax_common, "SyntheticCaseProvider", jax_provider)
    jax_cli.test(JaxUnetParser().parse_args(
        common + ["--outbasepath", str(tmp_path / "jax")]))
    jax_out = capsys.readouterr().out
    assert os.listdir(tmp_path / "jax_cache")

    monkeypatch.setattr(port_common, "synthetic_cache_dir",
                        lambda: str(tmp_path / "port_cache"))
    tester = port_cli.test(get_args_unet_training(
        common + ["--outbasepath", str(tmp_path / "port"),
                  "--device", "cpu"]))
    port_out = capsys.readouterr().out
    assert tester.device == torch.device("cpu")

    def case_lines(out):
        return [ln for ln in out.splitlines() if ln.startswith("Case Id")]

    assert len(case_lines(jax_out)) == 2
    assert case_lines(port_out) == case_lines(jax_out)
    assert "Size test set: 2 | # batches: 2" in port_out
    for cid in (0, 1):
        for part in ("_core", "_penu"):
            got, aff = read_nifti(str(tmp_path / f"port_{cid}{part}.nii.gz"))
            want, aff_want = read_nifti(
                str(tmp_path / f"jax_{cid}{part}.nii.gz"))
            assert got.shape == want.shape == (24, 24, 24)
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
            np.testing.assert_array_equal(aff, aff_want)
    assert sorted(os.listdir(tmp_path / "port_cache")) == \
        sorted(os.listdir(tmp_path / "jax_cache"))
    assert json.loads(json.dumps([c for c, _, _ in tester.case_seconds])) \
        == [int(ln.split()[2].rstrip(":")) for ln in case_lines(port_out)]
