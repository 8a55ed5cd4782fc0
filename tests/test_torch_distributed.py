"""Port parity for the process-sharded loader and the data-parallel
training CLIs: ``BatchLoader(process_shard=True)`` against the JAX loader's
rule (``chunk[pid::nproc]``, a last chunk that does not divide dropped),
and the port's U-Net training CLI run on the CPU in two processes,
``--ndevices 2`` (spawned ranks on the device cache) and ``--distributed``
(two commands on the host path), against the same CLI in one process; the
same for the phase-1 CAE CLI (``--ndevices 2``) and the phase-2 CLI
(``--ndevices 2``, and ``--distributed`` with each process writing under a
base of its own: rank 1 writes nothing).  The CAE runs import no
matplotlib (a stand-in package that refuses the import), as on the card:
no PNGs, and no visual forwards.

Each CLI run is a subprocess with a timeout of its own (SPAWN_TIMEOUT).
The curves agree to 1e-5 relative (float32 sums in another order); the
final weights to 1e-5 absolute, 1% of one Adam step (lr 1e-3), since Adam
turns small gradient differences of the entry BN's bias into parameter
differences of that order.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from stroke_prediction_tpu.data import dataset as jax_dataset
from stroke_prediction_tpu.data import loader as jax_loader
from stroke_prediction_tpu_torch.cli import common
from stroke_prediction_tpu_torch.cli import train_unet_segmentation as cli
from stroke_prediction_tpu_torch.data import dataset, loader
from stroke_prediction_tpu_torch.utils import checkpoint
from stroke_prediction_tpu_torch.utils.args import get_args_unet_training

import _torch_cae_parallel_worker as cae_worker
from test_torch_cae_step_learner import write_phase1_cae

REPO = Path(__file__).resolve().parents[1]
SPAWN_TIMEOUT = 180        # seconds per CLI run, both ranks together
CURVE_REL, WEIGHT_ABS = 1e-5, 1e-5
MODULE = "stroke_prediction_tpu_torch.cli.train_unet_segmentation"
ARGS = ["unused.model", "--synthetic", "--xyoriginal", "24", "--zsize",
        "24", "--epochs", "2", "--batchsize", "4", "--channels",
        "2", "4", "6", "8", "6", "4", "6", "2", "--dtype", "float32",
        "--device", "cpu"]
# 9 cases, 2 validate: 7 train at batch 4 -> chunks of 4 (sharded over two
# ranks) and 3 (replicated); 10 cases, 2 validate: 8 train -> 4 and 4
FOLD_7 = ["--fold", *map(str, range(9)), "--validsetsize", "0.23"]
FOLD_8 = ["--fold", *map(str, range(10)), "--validsetsize", "0.2"]


@pytest.mark.parametrize("nproc,pid", [(1, 0), (2, 0), (2, 1), (3, 1),
                                       (3, 2)])
@pytest.mark.parametrize("n_cases,batch", [(11, 4), (12, 4), (9, 3)])
def test_process_shard_chunks_match_jax(monkeypatch, nproc, pid, n_cases,
                                        batch):
    """Every epoch's chunks of process ``pid`` of ``nproc`` are the JAX
    loader's: the same shared-seed order, ``chunk[pid::nproc]``, and the
    epoch ending at the first chunk that does not divide."""
    kw = dict(n_cases=n_cases, shape_xyz=(8, 8, 6), seed=3)
    mods, labels = [dataset.MOD_CBV], [dataset.LABEL_CORE]
    ours = loader.BatchLoader(
        dataset.StrokeDataset3D(dataset.SyntheticCaseProvider(**kw), mods,
                                labels),
        range(n_cases), batch, seed=5, process_shard=True)
    theirs = jax_loader.BatchLoader(
        jax_dataset.StrokeDataset3D(jax_dataset.SyntheticCaseProvider(**kw),
                                    mods, labels),
        range(n_cases), batch, seed=5, process_shard=True)
    monkeypatch.setattr(loader, "process_index", lambda: pid)
    monkeypatch.setattr(loader, "process_count", lambda: nproc)
    monkeypatch.setattr(jax, "process_index", lambda: pid)
    monkeypatch.setattr(jax, "process_count", lambda: nproc)
    for _ in range(3):
        got = ours.epoch_chunks()
        assert got == theirs.epoch_chunks()
        assert all(len(c) == batch // nproc for c in got) or nproc == 1


@pytest.mark.parametrize("n_cases", [8, 9, 11])
def test_drop_last_matches_jax(n_cases):
    kw = dict(n_cases=n_cases, shape_xyz=(8, 8, 6), seed=3)
    mods, labels = [dataset.MOD_CBV], [dataset.LABEL_CORE]
    ours = loader.BatchLoader(
        dataset.StrokeDataset3D(dataset.SyntheticCaseProvider(**kw), mods,
                                labels),
        range(n_cases), 4, seed=2, drop_last=True)
    theirs = jax_loader.BatchLoader(
        jax_dataset.StrokeDataset3D(jax_dataset.SyntheticCaseProvider(**kw),
                                    mods, labels),
        range(n_cases), 4, seed=2, drop_last=True)
    assert len(ours) == len(theirs) == n_cases // 4
    for _ in range(2):
        assert ours.epoch_chunks() == theirs.epoch_chunks()


def _env(tmp_path, no_plots=False):
    """The CLI's environment; ``no_plots``: a ``matplotlib`` that refuses to
    import first on the path."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    path = [str(REPO)]
    if no_plots:
        stub = tmp_path / "no_plots" / "matplotlib"
        stub.mkdir(parents=True, exist_ok=True)
        (stub / "__init__.py").write_text(
            'raise ImportError("no matplotlib in this run")\n')
        path.insert(0, str(stub.parent))
    env.update(PYTHONPATH=os.pathsep.join(path), OMP_NUM_THREADS="1",
               TMPDIR=str(tmp_path))
    return env


def _run(commands, tmp_path, module=MODULE):
    """Run the CLI commands together; (returncode, output) of each."""
    procs = [subprocess.Popen([sys.executable, "-m", module, *c],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              env=_env(tmp_path, module != MODULE),
                              cwd=tmp_path)
             for c in commands]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=SPAWN_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    return outs


def _epoch_lines(out):
    return re.findall(r"^Epoch \d+/\d+ (?:training|validate) loss: .*?"
                      r"DC (?:Penumbra|penu\.):\S+", out, re.M)


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


def _same_training(base, ref, mark="_unet", models=("_unet_final.model",),
                   weight_abs=WEIGHT_ABS):
    """The two runs' files, curves (``<mark>.json``) and final weights (each
    of ``models``, within ``weight_abs``) agree."""
    names = sorted(p.name for p in base.parent.iterdir())
    assert names == sorted(p.name for p in ref.parent.iterdir())
    got = checkpoint.load_curves(str(base) + mark + ".json")
    want = checkpoint.load_curves(str(ref) + mark + ".json")
    for phase in ("training", "validate"):
        assert len(got[phase]) == len(want[phase]) >= 1
        for a, b in zip(got[phase], want[phase]):
            assert set(a) == set(b)
            for k in b:
                if np.isfinite(b[k]):
                    assert abs(a[k] - b[k]) <= CURVE_REL * max(abs(b[k]),
                                                               1e-30), k
                else:
                    assert a[k] == b[k], k
    for name in models:
        a, _ = checkpoint.load_checkpoint(str(base) + name)
        b, _ = checkpoint.load_checkpoint(str(ref) + name)
        want = dict(_leaves(b))
        assert len(want) == len(dict(_leaves(a)))
        for path, leaf in _leaves(a):
            np.testing.assert_allclose(leaf, want[path], atol=weight_abs,
                                       rtol=0, err_msg=f"{name} {path}")


def _bases(tmp_path, *names, stem="unet"):
    out = []
    for name in names:
        (tmp_path / name).mkdir()
        out.append(tmp_path / name / stem)
    return out


def test_ndevices_2_cli_equals_one_process(tmp_path):
    """``--ndevices 2 --device cpu`` for two epochs on 7 training cases at
    batch 4 (a chunk of 4 sharded, one of 3 replicated) against the same
    CLI in one process: the same epoch lines, printed once, the same files,
    curves and final weights."""
    two, one = _bases(tmp_path, "two", "one")
    out_two, out_one = _run([
        ARGS + FOLD_7 + ["--ndevices", "2", "--outbasepath", str(two)],
        ARGS + FOLD_7 + ["--outbasepath", str(one)]], tmp_path)
    assert "# training batches: 2" in out_one
    assert len(_epoch_lines(out_one)) == 4
    assert _epoch_lines(out_two) == _epoch_lines(out_one)
    _same_training(two, one)


def test_distributed_cli_two_processes_equal_one_process(tmp_path):
    """``--distributed`` with two commands (8 training cases at batch 4:
    each process loads two cases a chunk) against one process: rank 1
    prints no epoch line, rank 0 the one-process run's; the same files,
    curves and final weights."""
    two, one = _bases(tmp_path, "two", "one")
    coordinator = f"127.0.0.1:{common.free_port()}"
    rank0, rank1, out_one = _run(
        [ARGS + FOLD_8 + ["--distributed", "--coordinator", coordinator,
                          "--nprocs", "2", "--procid", str(i),
                          "--outbasepath", str(two)] for i in range(2)]
        + [ARGS + FOLD_8 + ["--outbasepath", str(one)]], tmp_path)
    assert len(_epoch_lines(out_one)) == 4
    assert _epoch_lines(rank0) == _epoch_lines(out_one)
    assert _epoch_lines(rank1) == []
    _same_training(two, one)


def test_parallel_flags_refuse_what_is_not_there(monkeypatch, capsys):
    """``--distributed`` with an ``--ndevices`` other than ``--nprocs`` is
    refused, by the parser and by ``make_mesh``, naming both flags (a
    process drives one card); ``--ndevices 2`` on the card needs two cards
    (here: none, then one faked) and starts no process otherwise;
    ``--distributed`` needs its three addresses."""
    argv = ["u.model", "--distributed", "--coordinator", "127.0.0.1:1",
            "--nprocs", "2", "--procid", "0", "--ndevices", "3"]
    with pytest.raises(SystemExit):
        get_args_unet_training(argv)
    assert "--ndevices 3 with --distributed" in capsys.readouterr().err
    args = get_args_unet_training(argv[:-1] + ["2"])
    args.ndevices = 3
    with pytest.raises(ValueError, match="--ndevices must equal --nprocs"):
        cli.train(args)
    args = get_args_unet_training(["u.model", "--ndevices", "2"])
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.train(args)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.multiprocessing, "start_processes",
                        lambda *a, **k: pytest.fail("a rank was started"))
    with pytest.raises(RuntimeError, match="needs 2 cards"):
        cli.train(args)
    with pytest.raises(SystemExit):
        get_args_unet_training(["u.model", "--distributed"])


@pytest.mark.parametrize("ndevices", [1, 2])
def test_distributed_ndevices_equal_to_nprocs_spans_the_group(monkeypatch,
                                                              ndevices):
    """``--distributed --ndevices N`` with N equal to ``--nprocs`` (or left
    at 1): the process joins the group and the mesh spans it, as the JAX
    package's spans the global devices; no process is spawned."""
    joined = []

    def initialize(coordinator, nprocs, procid, device=None):
        joined.append((coordinator, nprocs, procid, device))
        return torch.device("cpu")

    monkeypatch.setattr(common.distributed, "initialize", initialize)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: 1)
    monkeypatch.setattr(torch.multiprocessing, "start_processes",
                        lambda *a, **k: pytest.fail("a rank was started"))
    args = get_args_unet_training(
        ["u.model", "--distributed", "--coordinator", "127.0.0.1:1",
         "--nprocs", "2", "--procid", "1", "--ndevices", str(ndevices),
         "--device", "cpu"])
    assert not common.spawned(cli.__name__, args)
    mesh, device = common.make_mesh(args)
    assert joined == [("127.0.0.1:1", 2, 1, "cpu")]
    assert (mesh.rank, mesh.world, device.type) == (1, 2, "cpu")


# ------------------------------------------------------------ the CAE CLIs

CAE1_MODULE = "stroke_prediction_tpu_torch.cli.train_shape_reconstruction"
CAE2_MODULE = "stroke_prediction_tpu_torch.cli.train_shape_prediction"
CAE_WIDTH = [*map(str, cae_worker.CHANNELS)]
CAE_ARGS = ["--synthetic", "--xyoriginal", "128", "--zsize", "28",
            "--epochs", "2", "--batchsize", "4", "--dtype", "float32",
            "--device", "cpu"]
CAE1_MODELS = ("_cae1_final.model",)
# the CAE's final weights: a tenth of one Adam step (lr 1e-3).  Adam's
# m / sqrt(v) normalizes each gradient element, so one that cancels down to
# the float32 sums' rounding moves by up to a step either way; after four
# steps three of the 1728 elements of the decoder's first kernel were 2e-5
# apart.  A step without the gradients' average, or a missing step, moves
# the weights by ~1e-3.
CAE_WEIGHT_ABS = 1e-4
CAE2_MODELS = ("_cae2_final.model", "_cae2_enc_final.model")


def _phase2_args(tmp_path):
    cae = tmp_path / "phase1_cae1.model"
    write_phase1_cae(str(cae))
    return [str(cae), *CAE_ARGS, "--channelsenc", *CAE_WIDTH, "--initbycae"]


@pytest.mark.parametrize("phase", [1, 2])
def test_cae_ndevices_2_cli_equals_one_process(tmp_path, phase):
    """``--ndevices 2 --device cpu`` of the phase-1 and the phase-2 CLI for
    two epochs on 7 training cases at batch 4 (a chunk of 4 sharded, one of
    3 replicated) against the same CLI in one process: the same epoch
    lines, printed once, the same files, curves and final models (phase 2:
    the frozen CAE and the encoder)."""
    two, one = _bases(tmp_path, "two", "one", stem="cae")
    if phase == 1:
        module, mark, models = CAE1_MODULE, "_cae1", CAE1_MODELS
        args = CAE_ARGS + ["--channelscae", *CAE_WIDTH]
    else:
        module, mark, models = CAE2_MODULE, "_cae2", CAE2_MODELS
        args = _phase2_args(tmp_path)
    out_two, out_one = _run([
        args + FOLD_7 + ["--ndevices", "2", "--outbasepath", str(two)],
        args + FOLD_7 + ["--outbasepath", str(one)]], tmp_path, module)
    assert out_one.count("Size training set: 7 samples") == 1
    assert out_two.count("Size training set: 7 samples") == 1
    assert len(_epoch_lines(out_one)) == 4
    assert _epoch_lines(out_two) == _epoch_lines(out_one)
    _same_training(two, one, mark, models, CAE_WEIGHT_ABS)


def test_cae_distributed_cli_two_processes_equal_one_process(tmp_path):
    """Phase 2 with ``--distributed`` in two commands (8 training cases at
    batch 4: each process loads two cases a chunk through the prediction
    loader's ``process_shard``), each with an output base of its own,
    against one process: rank 1 prints no epoch line and writes nothing,
    rank 0 prints the one-process run's lines and writes its files, curves
    and both final models."""
    two, other, one = _bases(tmp_path, "two", "other", "one", stem="cae")
    args = _phase2_args(tmp_path)
    coordinator = f"127.0.0.1:{common.free_port()}"
    rank0, rank1, out_one = _run(
        [args + FOLD_8 + ["--distributed", "--coordinator", coordinator,
                          "--nprocs", "2", "--procid", str(i),
                          "--outbasepath", str(base)]
         for i, base in enumerate((two, other))]
        + [args + FOLD_8 + ["--outbasepath", str(one)]], tmp_path,
        CAE2_MODULE)
    assert len(_epoch_lines(out_one)) == 4
    assert _epoch_lines(rank0) == _epoch_lines(out_one)
    assert _epoch_lines(rank1) == [] and "Size training set" not in rank1
    assert not list(other.parent.iterdir())
    _same_training(two, one, "_cae2", CAE2_MODELS, CAE_WEIGHT_ABS)
