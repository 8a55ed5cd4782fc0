"""Port parity for the profiling module (utils/profiling.py) and its uses:
``StepTimer`` against the JAX package's, the learner's ``[throughput]``
line, and ``--profile`` on the port's U-Net training CLI writing a
torch.profiler trace of one training pass with its ``train_step``
ranges."""

import json
import os
import re

import numpy as np
import pytest
import torch

from stroke_prediction_tpu.utils import profiling as jax_profiling
from stroke_prediction_tpu_torch.cli import common as port_common
from stroke_prediction_tpu_torch.cli import train_unet_segmentation as cli
from stroke_prediction_tpu_torch.data import dataset
from stroke_prediction_tpu_torch.data.loader import (
    get_stroke_shape_training_data)
from stroke_prediction_tpu_torch.models.unet3d import Unet3D
from stroke_prediction_tpu_torch.train.optim import make_optimizer
from stroke_prediction_tpu_torch.train.unet_learner import (
    UnetSegmentationLearner)
from stroke_prediction_tpu_torch.utils import profiling
from stroke_prediction_tpu_torch.utils.args import get_args_unet_training

torch.set_num_threads(1)

CHANNELS = (2, 4, 6, 8, 6, 4, 6, 2)


def _run_timer(mod, monkeypatch, warmup, n_chips, ticks, volumes):
    """``mod``'s StepTimer through a start / stop per entry of ``volumes``
    on a fake clock reading ``ticks`` -> (step times, summaries, rate)."""
    it = iter(ticks)
    monkeypatch.setattr(mod.time, "perf_counter", lambda: next(it))
    timer = mod.StepTimer(warmup_steps=warmup, n_chips=n_chips)
    dts, summaries = [], []
    for n in volumes:
        timer.start()
        dts.append(timer.stop(n))
        summaries.append(timer.summary())
    return dts, summaries, timer.volumes_per_sec_per_chip


@pytest.mark.parametrize("warmup,n_chips", [(2, 1), (1, 4), (0, 2)])
def test_step_timer_matches_jax(monkeypatch, warmup, n_chips):
    """The same stop sequence on the same fake clock: the same step times,
    summary strings and rate."""
    ticks = [float(t) for t in np.cumsum(
        np.random.RandomState(warmup).rand(10))]
    volumes = (6, 6, 4, 6, 2)
    ours = _run_timer(profiling, monkeypatch, warmup, n_chips, ticks,
                      volumes)
    theirs = _run_timer(jax_profiling, monkeypatch, warmup, n_chips, ticks,
                        volumes)
    assert ours == theirs
    assert ours[2] > 0


def test_step_timer_rate(monkeypatch):
    """Volumes over the timed steps' seconds per chip."""
    dts, summaries, rate = _run_timer(
        profiling, monkeypatch, 1, 2, [0.0, 5.0, 5.0, 7.0, 7.0, 11.0],
        (100, 6, 12))
    assert dts == [5.0, 2.0, 4.0]
    assert rate == pytest.approx(18 / 6 / 2)
    assert summaries == ["0.00 volumes/sec/chip over 0 timed steps",
                         "1.50 volumes/sec/chip over 1 timed steps",
                         "1.50 volumes/sec/chip over 2 timed steps"]


def test_trace_writes_chrome_json_with_annotations(tmp_path):
    logdir = str(tmp_path / "prof")
    with profiling.trace(logdir):
        with profiling.annotate("my_range"):
            torch.ones(8).sum()
    events = json.load(open(os.path.join(logdir, profiling.TRACE_FILE)))
    names = {e.get("name") for e in events["traceEvents"]}
    assert "my_range" in names


def _learner(tmp_path, **kw):
    ds = dataset.StrokeDataset3D(
        dataset.SyntheticCaseProvider(n_cases=6, shape_xyz=(24, 24, 24),
                                      seed=4,
                                      cache_dir=str(tmp_path / "cache")),
        [dataset.MOD_CBV, dataset.MOD_TTD],
        [dataset.LABEL_CORE, dataset.LABEL_PENU], resample=0.5,
        pad=(20, 20, 20))
    train, valid = get_stroke_shape_training_data(ds, range(6), 0.34,
                                                  seed=4, batchsize=2)
    model = Unet3D(CHANNELS, generator=torch.Generator().manual_seed(4))
    opt = make_optimizer(model.parameters(), 1e-3, betas=(0.99, 0.999),
                         weight_decay=1e-5)
    return UnetSegmentationLearner(
        train, valid, model, opt, None, n_epochs=3, patch_whd=(44, 44, 44),
        pad_xyz=(20, 20, 20), path_outputs_base=str(tmp_path / "unet"),
        device="cpu", **kw)


def test_learner_logs_throughput(tmp_path, capsys):
    """``log_throughput`` prints ``[throughput] X volumes/sec/chip over N
    timed steps`` before each training epoch line, N the training passes
    after the first (its warm-up); the pass times stay recorded."""
    learner = _learner(tmp_path, log_throughput=True)
    learner.run_training()
    out = capsys.readouterr().out
    found = re.findall(r"\[throughput\] ([0-9.]+) volumes/sec/chip over "
                       r"(\d+) timed steps \nEpoch (\d)/3 training", out)
    assert [(n, e) for _, n, e in found] == [("0", "1"), ("1", "2"),
                                             ("2", "3")]
    assert float(found[0][0]) == 0.0 and float(found[-1][0]) > 0.0
    assert len(learner.train_pass_seconds) == 3
    quiet = _learner(tmp_path)
    quiet.run_training()
    assert "[throughput]" not in capsys.readouterr().out


def test_cli_profile_writes_a_trace_of_the_second_epoch(tmp_path, capsys,
                                                        monkeypatch):
    """``--profile DIR`` on the U-Net training CLI (CPU): a Chrome trace in
    DIR whose ``train_step`` ranges are the second epoch's steps."""
    monkeypatch.setattr(port_common, "synthetic_cache_dir",
                        lambda: str(tmp_path / "port_cache"))
    logdir = str(tmp_path / "prof")
    args = get_args_unet_training(
        [str(tmp_path / "unused.model"), "--synthetic", "--xyoriginal", "24",
         "--zsize", "24", "--epochs", "2", "--batchsize", "2", "--fold",
         "0", "1", "2", "3", "4", "5", "--validsetsize", "0.34",
         "--channels", *map(str, CHANNELS), "--dtype", "float32",
         "--outbasepath", str(tmp_path / "unet"), "--device", "cpu",
         "--profile", logdir])
    assert args.profile == logdir
    learner = cli.train(args)
    assert learner.step_counts["train"] == 4
    events = json.load(open(os.path.join(logdir, profiling.TRACE_FILE)))
    names = [e.get("name") for e in events["traceEvents"]]
    # two training steps of the traced epoch; its validation is not traced
    assert names.count("train_step") == 2
    assert "eval_step" not in names
