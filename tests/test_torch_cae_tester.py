"""Port parity for the CAE serving path: ``CaeReconstructionTester`` and
``CaeReconstructionTesterCurve`` (eval/cae_tester.py) against the JAX
package's testers on the same checkpoint and cases, and both shape-testing
CLIs run end to end on the CPU.

Reconstructions agree to 1e-5 (float32 on both sides).  The measures are
computed from the reconstructions thresholded at 0.5, which are equal on
both sides here: Dice, precision, sensitivity and specificity to 1e-6, HD
and ASSD to 1e-4.  The batched sweep is held to the serial one as the JAX
package holds its own (Dice 1e-5, ASSD 1e-3)."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stroke_prediction_tpu.cli import common as jax_common
from stroke_prediction_tpu.cli import test_shape_reconstruction as jax_cli
from stroke_prediction_tpu.data import dataset as jax_dataset
from stroke_prediction_tpu.data import loader as jax_loader
from stroke_prediction_tpu.eval import cae_tester as jax_cae_tester
from stroke_prediction_tpu.inference import (
    cae_dto_from_batch as jax_cae_dto_from_batch)
from stroke_prediction_tpu.models.cae3d import Cae3D, Dec3D, Enc3D
from stroke_prediction_tpu.core.dto import BRANCH_GTRUTH as JAX_GTRUTH
from stroke_prediction_tpu.train import checkpoint as jax_checkpoint
from stroke_prediction_tpu.utils import args as jax_args
from stroke_prediction_tpu.utils.nifti import read_nifti
from stroke_prediction_tpu_torch.cli import common as port_common
from stroke_prediction_tpu_torch.cli import test_shape_reconstruction as cli
from stroke_prediction_tpu_torch.cli import (
    test_shape_reconstruction_CurveAnalysis as curve_cli)
from stroke_prediction_tpu_torch.data import dataset, loader
from stroke_prediction_tpu_torch.eval.cae_tester import (
    CaeReconstructionTester, CaeReconstructionTesterCurve)
from stroke_prediction_tpu_torch.utils.args import get_args_shape_testing

from test_torch_unet import _random_variables

torch.set_num_threads(1)

CHANNELS = (1, 2, 3, 4, 5, 6, 1)
CONFIG = {"kind": "cae3d", "channels": list(CHANNELS), "n_ch_global": 5,
          "step": False}
LABELS = [dataset.LABEL_CORE, dataset.LABEL_PENU, dataset.LABEL_LESION]
MODS = [dataset.MOD_CBV, dataset.MOD_TTD]
SWEEP = [0.0, 2.0, 5.0]
EXACT = ("dc", "precision", "sensitivity", "specificity")


@pytest.fixture(scope="module")
def cae_checkpoint(tmp_path_factory):
    """A JAX-format CAE checkpoint with random weights and BN statistics."""
    out = tmp_path_factory.mktemp("cae_tester")
    model = Cae3D(enc=Enc3D(channels=CHANNELS, n_ch_global=5),
                  dec=Dec3D(channels=CHANNELS, n_ch_global=5))
    dto = jax_cae_dto_from_batch(None, jnp.zeros((1, 28, 64, 64, 3)),
                                 jnp.ones((1, 5)))
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), dto,
                                               JAX_GTRUTH, False))
    path = str(out / "cae.model")
    jax_checkpoint.save_checkpoint(
        path, _random_variables(shapes, np.random.RandomState(0)), CONFIG)
    return path, out


def _loaders():
    """The same two 64 x 64 x 28 synthetic cases in both packages."""
    kw = dict(n_cases=3, shape_xyz=(64, 64, 28), seed=4)
    port_ds = dataset.StrokeDataset3D(dataset.SyntheticCaseProvider(**kw),
                                      MODS, LABELS)
    jax_ds = jax_dataset.StrokeDataset3D(
        jax_dataset.SyntheticCaseProvider(**kw), MODS, LABELS)
    return (loader.get_testdata(port_ds, [0, 2], seed=1),
            jax_loader.get_testdata(jax_ds, [0, 2], seed=1))


@pytest.fixture(scope="module")
def testers(cae_checkpoint):
    path, out = cae_checkpoint
    port_loader, jax_loader_ = _loaders()
    port = CaeReconstructionTesterCurve(port_loader, path,
                                        str(out / "port"), 10,
                                        device="cpu")
    ref = jax_cae_tester.CaeReconstructionTesterCurve(
        jax_loader_, path, str(out / "jax"), 10)
    return port, ref


def _batch(tester):
    """The first case of the tester's fold (its loader shuffles anew at
    every pass)."""
    data = tester._dataloader
    return data.dataset.stack([data.indices[0]])


def _assert_measures_equal(got, want, what):
    for f in EXACT:
        assert getattr(got, f) == pytest.approx(getattr(want, f), abs=1e-6), \
            (what, f)
    for f in ("hd", "assd"):
        assert getattr(got, f) == pytest.approx(getattr(want, f), abs=1e-4), \
            (what, f)


@pytest.mark.parametrize("step", [None, 5.0])
def test_infer_batch_matches_jax(testers, step):
    port, ref = testers
    with torch.inference_mode():
        got, dto = port.infer_batch(_batch(port), step)
    want, jdto = ref.infer_batch(_batch(ref), step)
    ttt = dto.given_variables.time_to_treatment
    np.testing.assert_allclose(
        ttt.numpy(), np.asarray(jdto.given_variables.time_to_treatment),
        atol=1e-7, rtol=0)
    for f in ("core", "penu", "lesion", "interpolation"):
        a = getattr(dto.reconstructions.gtruth, f).numpy()
        b = np.asarray(getattr(jdto.reconstructions.gtruth, f))
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0, err_msg=f)
        assert np.array_equal(a > 0.5, b > 0.5), f
    for part in ("lesion", "core", "penu"):
        _assert_measures_equal(got[part], want[part], part)


@pytest.fixture(scope="module")
def sweeps(testers):
    port, ref = testers
    with torch.inference_mode():
        got, _ = port.infer_batch_steps(_batch(port), SWEEP)
        serial = [port.infer_batch(_batch(port), s)[0]["lesion"]
                  for s in SWEEP]
    want, _ = ref.infer_batch_steps(_batch(ref), SWEEP)
    return got, serial, want


def test_batched_sweep_matches_serial(sweeps):
    got, serial, _ = sweeps
    assert len(got) == len(SWEEP)
    for batched, one in zip(got, serial):
        assert batched.dc == pytest.approx(one.dc, abs=1e-5)
        assert batched.assd == pytest.approx(one.assd, abs=1e-3)


def test_batched_sweep_matches_jax(sweeps):
    got, _, want = sweeps
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dc == pytest.approx(b.dc, abs=1e-5), i
        assert a.assd == pytest.approx(b.assd, abs=1e-3), i
        assert a.hd == pytest.approx(b.hd, abs=1e-3), i


@pytest.mark.parametrize("step", [None, 5.0])
def test_structure_batching_keeps_the_measures(testers, monkeypatch, step):
    """The tester with structure batching on (``STROKE_TPU_CAE_BATCH=1``:
    one encode, one decode; the sweep's one-row core and penumbra stacked
    with its interpolations) gives the measures of the tester with it
    off: a case's, and each of a sweep's."""
    port, _ = testers
    got = {}
    for switch in ("0", "1"):
        monkeypatch.setenv("STROKE_TPU_CAE_BATCH", switch)
        with torch.inference_mode():
            metrics, _ = port.infer_batch(_batch(port), step)
            swept, _ = port.infer_batch_steps(_batch(port), SWEEP)
        got[switch] = metrics, swept
    (m0, s0), (m1, s1) = got["0"], got["1"]
    for part in ("lesion", "core", "penu"):
        _assert_measures_equal(m1[part], m0[part], part)
    for i, (a, b) in enumerate(zip(s1, s0)):
        _assert_measures_equal(a, b, f"sweep {i}")


def _case_lines(out):
    return [ln for ln in out.splitlines() if ln.startswith("Case Id=")]


def test_run_inference_matches_jax(cae_checkpoint, capsys):
    """``run_inference`` prints the reference line, letter for letter as the
    JAX tester prints it, and writes the three dumps at 128 x 128 x 28 with
    the JAX tester's values and affines."""
    path, out = cae_checkpoint
    port_loader, jax_loader_ = _loaders()
    jax_cae_tester.CaeReconstructionTester(jax_loader_, path,
                                           str(out / "jrun"), 10
                                           ).run_inference()
    want = _case_lines(capsys.readouterr().out)
    port = CaeReconstructionTester(port_loader, path, str(out / "prun"), 10,
                                   "cpu")
    port.run_inference()
    assert _case_lines(capsys.readouterr().out) == want
    assert len(want) == 2 and "normalized_time_to_treatment" in want[0]
    assert [c for c, _, _ in port.case_seconds] == [
        int(ln.split("\t")[0].split("=")[1]) for ln in want]
    for cid in (0, 2):
        for part in ("_core", "_pred", "_penu"):
            got, aff = read_nifti(str(out / f"prun_{cid}{part}.nii.gz"))
            ref, aff_ref = read_nifti(str(out / f"jrun_{cid}{part}.nii.gz"))
            assert got.shape == ref.shape == (128, 128, 28)
            np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
            np.testing.assert_array_equal(aff, aff_ref)


def test_curve_run_inference_prints_all_sweeps(cae_checkpoint, capsys):
    path, out = cae_checkpoint
    port = CaeReconstructionTesterCurve(
        _loaders()[0], path, str(out / "curve"), 10,
        ta_to_tr_fixed_hours=[0.0, 1.0], ta_to_tr_relative_steps=[0.5, 1.0],
        device="cpu")
    port.run_inference()
    printed = capsys.readouterr().out
    assert printed.count("ta_to_tr fixed=") == 2 * 2      # 2 cases
    assert printed.count("ta_to_tr ratio=") == 2 * 2
    assert printed.count("tr_to_penumbra=") == 11 * 2
    assert len(_case_lines(printed)) == 2 * (1 + 2 + 2 + 11)
    assert len(port.case_seconds) == 2


def test_shape_testing_args_match_jax(monkeypatch):
    argv = ["--path", "a.model", "--fold", "0", "1", "--path", "b.model",
            "--fold", "2", "--synthetic"]
    monkeypatch.setattr(sys, "argv", ["prog"] + argv)
    want = vars(jax_args.get_args_shape_testing())
    got = vars(get_args_shape_testing(argv + ["--device", "cpu"]))
    assert got.pop("device") == "cpu"
    assert got == want
    assert get_args_shape_testing(argv).device == "cuda"


def _synthetic_args(path, out, name):
    return ["--path", path, "--fold", "0", "1", "--synthetic",
            "--xyoriginal", "128", "--zsize", "28", "--seed", "7",
            "--outbasepath", str(out / name)]


def test_cli_end_to_end_matches_jax(cae_checkpoint, tmp_path, capsys,
                                    monkeypatch):
    path, _ = cae_checkpoint

    def jax_provider(**kw):
        return jax_dataset.SyntheticCaseProvider(
            **{**kw, "cache_dir": str(tmp_path / "jax_cache")})

    monkeypatch.setattr(jax_common, "SyntheticCaseProvider", jax_provider)
    monkeypatch.setattr(sys, "argv",
                        ["prog"] + _synthetic_args(path, tmp_path, "jax"))
    jax_cli.test(jax_args.get_args_shape_testing())
    want = _case_lines(capsys.readouterr().out)

    monkeypatch.setattr(port_common, "synthetic_cache_dir",
                        lambda: str(tmp_path / "port_cache"))
    (tester,) = cli.test(get_args_shape_testing(
        _synthetic_args(path, tmp_path, "port") + ["--device", "cpu"]))
    printed = capsys.readouterr().out
    assert tester.device == torch.device("cpu")
    assert "Size test set: 2 | # batches: 2" in printed
    assert len(want) == 2 and _case_lines(printed) == want
    for cid in (0, 1):
        for part in ("_core", "_pred", "_penu"):
            vol, _ = read_nifti(str(tmp_path / f"port_{cid}{part}.nii.gz"))
            assert vol.shape == (128, 128, 28)


def test_curve_cli_runs_on_cpu(cae_checkpoint, tmp_path, capsys,
                               monkeypatch):
    path, _ = cae_checkpoint
    monkeypatch.setattr(port_common, "synthetic_cache_dir",
                        lambda: str(tmp_path / "port_cache"))
    (tester,) = curve_cli.test(get_args_shape_testing(
        _synthetic_args(path, tmp_path, "curve") + ["--device", "cpu"]))
    printed = capsys.readouterr().out
    assert tester.device == torch.device("cpu")
    assert printed.count("ta_to_tr fixed=") == 6 * 2      # 0-5 h, 2 cases
    assert printed.count("ta_to_tr ratio=") == 9 * 2
    assert printed.count("tr_to_penumbra=") == 11 * 2
    assert sorted(os.listdir(tmp_path)) == sorted(
        ["port_cache"] + [f"curve_{c}{p}.nii.gz" for c in (0, 1)
                          for p in ("_core", "_pred", "_penu")])


def test_time_to_treatment_of_several_steps_matches_jax():
    """Step hours given as a sequence give one normalized step a value,
    (S, 1): each the JAX package's normalized step for that value."""
    from stroke_prediction_tpu.inference import (
        time_to_treatment as jax_time_to_treatment)
    from stroke_prediction_tpu_torch.inference import time_to_treatment

    clinical = np.array([[2.5, 3.0, 0.2, 0.4, 0.6]], np.float32)
    got = time_to_treatment(torch.from_numpy(clinical), SWEEP)
    assert got.shape == (len(SWEEP), 1)
    for i, s in enumerate(SWEEP):
        want = np.asarray(jax_time_to_treatment(jnp.asarray(clinical), s))
        np.testing.assert_array_equal(got[i:i + 1].numpy(), want)
