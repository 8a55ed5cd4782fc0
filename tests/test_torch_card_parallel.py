"""Data-parallel training across cards (marker ``card``: needs two or more
CUDA cards, and skips without them).  Imports no JAX, and runs with
``--noconftest`` (tests/conftest.py sets up JAX):

    python -m pytest --noconftest -m card tests/test_torch_card_parallel.py

The U-Net and the phase-1 CAE training CLIs with ``--ndevices N``, N the
machine's cards (one process each, NCCL), against the same CLI in one
process: float32 at the reference width (and the U-Net's patch), a global
batch of 8 (8 / N rows a rank), two epochs.  The
losses agree to 1e-4 relative (float32 sums over other rows in another
order).  The weights are held by their update, final less initial: the
two runs' updates differ by at most 1e-2 of the update's norm over all
parameters.  Element by element they cannot be held tight: Adam's first
steps move a weight by about lr whatever its gradient's size, so an
element whose gradient is near zero can move either way in the two runs
(one element of 6912 was 1.1e-4 apart on four H100s), while a missing or
per-rank reduction changes the update throughout (the criterion of the
JAX package's tests/test_parallel.py).
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from stroke_prediction_tpu_torch.models.cae3d import Cae3D, Dec3D, Enc3D
from stroke_prediction_tpu_torch.models.convert import (
    state_to_jax, unet_state_to_jax)
from stroke_prediction_tpu_torch.models.unet3d import Unet3D
from stroke_prediction_tpu_torch.utils import checkpoint

pytestmark = pytest.mark.card

REPO = Path(__file__).resolve().parents[1]
RUN_TIMEOUT = 900          # seconds per CLI run
LOSS_REL, UPDATE_REL = 1e-4, 1e-2
CHANNELS, SEED = (2, 16, 32, 64, 32, 16, 32, 2), 4   # the CLI's defaults
COMMON = ["--synthetic", "--epochs", "2", "--batchsize", "8", "--fold",
          *map(str, range(10)), "--validsetsize", "0.2", "--dtype", "float32"]
ARGS = ["unused.model", *COMMON]
UNET = "stroke_prediction_tpu_torch.cli.train_unet_segmentation"
CAE = "stroke_prediction_tpu_torch.cli.train_shape_reconstruction"
CAE_CHANNELS = (1, 16, 24, 32, 100, 200, 1)         # the CLI's defaults


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


def _train(tmp_path, name, extra, module=UNET, args=ARGS, stem="unet"):
    (tmp_path / name).mkdir()
    base = tmp_path / name / stem
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(REPO), TMPDIR=str(tmp_path))
    out = subprocess.run(
        [sys.executable, "-m", module, *args, "--outbasepath", str(base),
         *extra], env=env, cwd=tmp_path, capture_output=True, text=True,
        timeout=RUN_TIMEOUT)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
    return base, out.stdout


def _cards():
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        pytest.skip("needs two or more CUDA cards")
    return n


def _check(n, runs, outs, mark, start):
    """The two runs' epoch lines, files, losses and updates from the
    initial parameters ``start`` (a flax params tree)."""
    many, one = runs
    lines = re.findall(r"^Epoch \d+/2 (?:training|validate) loss: \S+",
                       outs[0], re.M)
    assert len(lines) == 4, outs[0][-2000:]
    assert sorted(p.name for p in many.parent.iterdir()) == sorted(
        p.name for p in one.parent.iterdir())
    got = checkpoint.load_curves(f"{many}{mark}.json")
    want = checkpoint.load_curves(f"{one}{mark}.json")
    for phase in ("training", "validate"):
        assert len(got[phase]) == len(want[phase]) >= 1
        for a, b in zip(got[phase], want[phase]):
            print(f"{phase} loss {a['loss']} / {b['loss']}")
            assert abs(a["loss"] - b["loss"]) <= LOSS_REL * b["loss"], phase
    updates = []
    for run in (many, one):
        final, _ = checkpoint.load_checkpoint(f"{run}{mark}_final.model")
        first = dict(_leaves(start))
        updates.append(np.concatenate([
            (leaf - first[path]).ravel()
            for path, leaf in _leaves(final["params"])]))
    ratio = np.linalg.norm(updates[0] - updates[1]) / np.linalg.norm(
        updates[1])
    print(f"{n} cards: update {np.linalg.norm(updates[1]):.4e}, relative "
          f"difference {ratio:.3e}, largest element "
          f"{np.abs(updates[0] - updates[1]).max():.3e}")
    assert ratio <= UPDATE_REL


def test_ndevices_on_the_cards_equals_one_process(tmp_path):
    n = _cards()
    many, out_many = _train(tmp_path, "many", ["--ndevices", str(n)])
    one, out_one = _train(tmp_path, "one", [])
    init = Unet3D(CHANNELS, generator=torch.Generator().manual_seed(SEED))
    _check(n, (many, one), (out_many, out_one), "_unet",
           unet_state_to_jax(init.state_dict())["params"])


def test_cae_ndevices_on_the_cards_equals_one_process(tmp_path):
    """The phase-1 CAE CLI (256 x 256 x 28 cases resampled to 128 x 128 x
    28, channels 1 16 24 32 100 200 1): its global losses, hinges and
    latent means included, and its gradients' average across the cards."""
    n = _cards()
    many, out_many = _train(tmp_path, "many", ["--ndevices", str(n)], CAE,
                            COMMON, "cae")
    one, out_one = _train(tmp_path, "one", [], CAE, COMMON, "cae")
    gen = torch.Generator().manual_seed(SEED)
    init = Cae3D(Enc3D(CAE_CHANNELS, generator=gen),
                 Dec3D(CAE_CHANNELS, generator=gen))
    start = state_to_jax(init.state_dict(), init.config)["params"]
    _check(n, (many, one), (out_many, out_one), "_cae1", start)
