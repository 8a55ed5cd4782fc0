"""Port parity for a data-parallel CAE step with structure batching on:
two gloo processes on the CPU (_torch_cae_grouped_worker.py, which imports
no JAX), each phase 1's float64 step at factor 0.4 on 2 rows of a global
batch of 4, against the port's one-process grouped step on the 4 rows
(computed here while the ranks run), at the limits of
test_torch_cae_parallel.py: the loss and the running statistics 1e-12,
every gradient 1e-7 of its tensor's max|ref|, the measures 1e-12 relative;
the two ranks equal bit for bit.

The ``all_reduce`` calls of a rank-step follow the number of BN layers and
not their widths, so these small channels give the card's counts.  With
the switch off, every BN layer makes one call per structure forward (3
encodes of 10 layers, 4 decodes of 12) and one per structure backward (the
entry BN's moments are of data: 3 x 9 + 4 x 12), 153, beside the 16 calls
of the loss, the measures and the gradients: 169.  With it on, one call a
layer: 22 forward, 21 backward, and the same 16: 59."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from stroke_prediction_tpu_torch.cli.common import free_port

import _torch_cae_grouped_worker as grouped_worker
import _torch_cae_parallel_worker as worker
from test_torch_cae_parallel import (
    CONFIGS, GRAD_REL, LOSS_TOL, REPO, SPAWN_TIMEOUT, STATS_TOL, WORLD,
    _errors, _section, global_batch, worker_inputs)

torch.set_num_threads(1)

ALL_REDUCE = {"on": 22 + 21 + 16, "off": 78 + 75 + 16}


def _run_ranks(outdir, inputs):
    """Both ranks' results; the one-process grouped step computed here
    while they run."""
    path = outdir / "inputs.npz"
    np.savez(path, **inputs)
    coordinator = f"127.0.0.1:{free_port()}"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               TMPDIR=str(outdir))
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests",
                                      "_torch_cae_grouped_worker.py"),
         coordinator, str(WORLD), str(rank), str(path), str(outdir)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for rank in range(WORLD)]
    outs = []
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv(grouped_worker.SWITCH, "1")
            one, _ = worker.step(grouped_worker.CASE, np.load(path), None)
        for p in procs:
            outs.append(p.communicate(timeout=SPAWN_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out}"
        assert f"CAE_GROUPED_WORKER_OK rank={rank}" in out, out
    return one, [dict(np.load(outdir / f"rank{r}.npz"))
                 for r in range(WORLD)]


def test_grouped_rank_step_equals_one_process(tmp_path):
    arrays = global_batch()
    _, states = worker_inputs(["phase1"], arrays)
    one, ranks = _run_ranks(tmp_path, dict(arrays, **states))
    config = CONFIGS["phase1"]
    for rank, got in enumerate(ranks):
        for name, want in ALL_REDUCE.items():
            assert int(got[f"{name}/all_reduce"]) == want, (rank, name)
        for name in ("on", "off"):
            step = _section(got, name)
            errs = _errors(step, float(one["metric/loss"]),
                           lambda p, k: one[f"grad/{k}"],
                           lambda p, k: one[f"stat/{k}"], config)
            assert errs[0] <= LOSS_TOL and errs[1] <= GRAD_REL \
                and errs[2] <= STATS_TOL, (rank, name, errs)
            for key, want in one.items():
                if key.startswith("metric/"):
                    np.testing.assert_allclose(step[key], want, rtol=1e-12,
                                               atol=0, err_msg=key)
    a, b = (_section(got, "on") for got in ranks)
    assert a.keys() == b.keys()
    for key in a:
        if not key.startswith("pregrad/"):        # each rank's own paths
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
