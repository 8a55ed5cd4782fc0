"""One rank of the port's 2-process grouped CAE step test
(test_torch_cae_grouped_parallel.py).

    python tests/_torch_cae_grouped_worker.py HOST:PORT WORLD RANK INPUTS DIR

Imports torch and stroke_prediction_tpu_torch only (checked at the end: no
JAX in this process).  Joins a gloo process group, then runs phase 1's
float64 training step at factor 0.4 (augmentation off) on this rank's 2
rows of the 4-row global batch twice, with structure batching on
(``STROKE_TPU_CAE_BATCH=1``) and off, counting the ``all_reduce`` calls
of each step (``_torch_cae_parallel_worker.step``).  Writes
``DIR/rank<RANK>.npz`` (``on/...``, ``off/...``, ``<switch>/all_reduce``)
and prints ``CAE_GROUPED_WORKER_OK``.
"""

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from stroke_prediction_tpu_torch.parallel import distributed
from stroke_prediction_tpu_torch.parallel.mesh import make_data_mesh

import _torch_cae_parallel_worker as worker

CASE = "phase1_factor"
SWITCH = "STROKE_TPU_CAE_BATCH"


def counted_step(inputs, mesh):
    """(results, all_reduce calls) of one sharded step of CASE."""
    calls = []
    real = dist.all_reduce

    def counting(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    dist.all_reduce = counting
    try:
        got, _ = worker.step(CASE, inputs, mesh)
    finally:
        dist.all_reduce = real
    return got, len(calls)


def main():
    coordinator, world, rank, inputs_path, outdir = sys.argv[1:6]
    torch.set_num_threads(1)
    distributed.initialize(coordinator, int(world), int(rank), device="cpu")
    mesh = make_data_mesh()
    inputs = np.load(inputs_path)
    out = {}
    for name, switch in (("on", "1"), ("off", "0")):
        os.environ[SWITCH] = switch
        got, calls = counted_step(inputs, mesh)
        out.update({f"{name}/{k}": v for k, v in got.items()})
        out[f"{name}/all_reduce"] = np.int64(calls)
    distributed.shutdown()
    jax_loaded = [m for m in sys.modules
                  if m in ("jax", "stroke_prediction_tpu")
                  or m.startswith(("jax.", "stroke_prediction_tpu."))]
    if jax_loaded:
        raise AssertionError(f"a rank imported {jax_loaded[:5]}")
    np.savez(os.path.join(outdir, f"rank{mesh.rank}.npz"), **out)
    print(f"CAE_GROUPED_WORKER_OK rank={mesh.rank}", flush=True)


if __name__ == "__main__":
    main()
