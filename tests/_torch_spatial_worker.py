"""One rank of the port's spatial (H-sharded) CPU tests
(test_torch_spatial.py, test_torch_spatial_unet.py).

    python tests/_torch_spatial_worker.py HOST:PORT DATA SPACE RANK INPUTS OUTDIR

Imports torch and stroke_prediction_tpu_torch only (checked at the end: no
JAX in this process).  Joins a gloo group of DATA * SPACE ranks, builds the
``(DATA, SPACE)`` mesh and runs, on the inputs the test wrote (``INPUTS``,
an .npz), the cases of its mesh:

* one data index (``exchange``): ``exchange_rows`` at each blocking of
  :data:`EXCHANGE_CASES` for its rank count, float64: the rows fetched, the
  gradient of ``<exchange(x), y>`` against the adjoint summed by hand, and
  both inner products summed over the ranks; one bfloat16 case;
* ``conv``: an ELU 3^3 valid conv's gradient of ``sum(y^2)`` on this
  rank's block (the loss summed over the ranks, the kernel and bias
  gradients averaged over them, dx divided by the world: every rank seeds
  the same global loss);
* ``forward64`` (and ``forward32`` at more than one data index): the eval
  forward of ``Unet3D`` on this rank's block;
* ``step`` (more than one data index): one float64 training step of
  ``UnetSegmentationLearner.train_patches`` on this rank's block, and two
  controls: ``no_adjoint`` (the exchanges' gradients never sent back) and
  ``bn_count`` (BN's count this rank's times the world).

Writes ``OUTDIR/rank<RANK>.npz`` and prints ``SPATIAL_WORKER_OK``.
"""

import dataclasses
import os
import subprocess
import sys
import types

import numpy as np
import torch

from stroke_prediction_tpu_torch.cli.common import free_port
from stroke_prediction_tpu_torch.models.unet3d import Unet3D
from stroke_prediction_tpu_torch.ops.conv3x3 import Conv3x3Fn
from stroke_prediction_tpu_torch.parallel import (
    collectives, distributed, spatial)
from stroke_prediction_tpu_torch.parallel.mesh import (
    batch_sharding, block, make_mesh, shard_batch)
from stroke_prediction_tpu_torch.train.optim import make_optimizer
from stroke_prediction_tpu_torch.train.unet_learner import (
    UnetSegmentationLearner)

CHANNELS = (2, 4, 6, 8, 6, 4, 6, 2)
# (global H, each space rank's need [lo, hi)): needs across two or three
# owners, from a non-neighbour, of no rows, and blocks that are empty
# (H < ranks)
EXCHANGE_CASES = {
    2: ((5, ((0, 5), (1, 2))), (1, ((0, 1), (0, 0))),
        (6, ((0, 4), (2, 6))), (3, ((2, 3), (0, 1)))),
    3: ((2, ((0, 2), (0, 2), (0, 1))), (9, ((6, 9), (0, 9), (0, 2))),
        (0, ((0, 0), (0, 0), (0, 0))), (7, ((0, 0), (2, 7), (0, 3))),
        (4, ((3, 4), (0, 1), (1, 3)))),
}
EXCHANGE_SHAPE = (2, 2, 3, 2)      # B, D, W, C around H
SPAWN_TIMEOUT = 180                # seconds, for all ranks together


def start(data, space, inputs, outdir, script=__file__):
    """Start ``script``'s ``data * space`` ranks (this worker's by default)
    on ``inputs`` (written to ``outdir``) -> the processes."""
    path = os.path.join(outdir, "inputs.npz")
    np.savez(path, **inputs)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), OMP_NUM_THREADS="1", TMPDIR=str(outdir))
    coordinator = f"127.0.0.1:{free_port()}"
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(script), coordinator, str(data),
         str(space), str(rank), path, str(outdir)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for rank in range(data * space)]


def join(procs, outdir, timeout=SPAWN_TIMEOUT):
    """Each rank's results, the ranks within ``timeout`` (killed after
    it)."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0 or f"SPATIAL_WORKER_OK rank={rank}" not in out:
            raise AssertionError(f"rank {rank} failed:\n{out}")
    return [dict(np.load(os.path.join(outdir, f"rank{r}.npz")))
            for r in range(len(procs))]


def spawn(data, space, inputs, outdir, script=__file__):
    """:func:`start`, then :func:`join`: each rank's results."""
    return join(start(data, space, inputs, outdir, script), outdir)


def exchange_case(mesh, index, h, needs):
    """{equal, grad_err, lhs, rhs} of one blocking on this rank."""
    rs = np.random.RandomState(100 + index)
    b, d, w, c = EXCHANGE_SHAPE
    x_all = rs.randn(b, d, h, w, c)
    ys = [rs.randn(b, d, hi - lo, w, c) for lo, hi in needs]
    s = mesh.space_index
    o_lo, o_hi = block(h, s, mesh.space)
    x = torch.from_numpy(x_all[:, :, o_lo:o_hi].copy()).requires_grad_()
    lo, hi = needs[s]
    out = collectives.exchange_rows(x, h, needs)
    y = torch.from_numpy(ys[s])
    (out * y).sum().backward()
    adjoint = np.zeros_like(x_all)
    for (a, e), ya in zip(needs, ys):
        adjoint[:, :, a:e] += ya
    inner = torch.stack([(out * y).sum(), (x * x.grad).sum()]).detach()
    torch.distributed.all_reduce(inner)
    return {"equal": np.bool_(torch.equal(
                out.detach(), torch.from_numpy(x_all[:, :, lo:hi]))),
            "grad_err": np.float64(np.abs(
                x.grad.numpy() - adjoint[:, :, o_lo:o_hi]).max(initial=0)),
            "lhs": inner[0].numpy(), "rhs": inner[1].numpy()}


def exchange_cases(mesh):
    out = {}
    with batch_sharding(mesh, spatial=True).active():
        for i, (h, needs) in enumerate(EXCHANGE_CASES[mesh.space]):
            out.update({f"exchange/{i}/{k}": v for k, v in
                        exchange_case(mesh, i, h, needs).items()})
        # a bfloat16 tensor moves as its bytes
        x_all = torch.from_numpy(np.random.RandomState(7).randn(
            2, 1, 9, 2, 3)).to(torch.bfloat16)
        lo, hi = block(9, mesh.space_index, mesh.space)
        got = collectives.exchange_rows(x_all[:, :, lo:hi], 9,
                                        [(0, 9)] * mesh.space)
    out["exchange/bfloat16/equal"] = np.bool_(torch.equal(got, x_all))
    return out


def local(mesh, inputs, key):
    return torch.from_numpy(np.ascontiguousarray(
        shard_batch(mesh, {key: inputs[key]}, spatial=True)[key]))


def conv_grads(inputs, mesh):
    """(dx of this rank's block, dk, db) of ``sum(elu(conv(x))^2)``."""
    x = local(mesh, inputs, "conv_x").requires_grad_()
    kernel = torch.from_numpy(inputs["conv_k"]).requires_grad_()
    bias = torch.from_numpy(inputs["conv_b"]).requires_grad_()
    sharding = batch_sharding(mesh, spatial=True)
    with sharding.active():
        rows, h_out = spatial.conv_rows(x, spatial.height(x))
        y = Conv3x3Fn.apply(rows.contiguous(), kernel, bias, "elu", 1.0, "v")
        loss, = collectives.reduce_sums((y * y).sum())
        loss.backward()
        collectives.average_gradients([kernel, bias])
    world = mesh.world if mesh is not None else 1
    return {"conv/dx": x.grad.numpy() / world, "conv/dk": kernel.grad.numpy(),
            "conv/db": bias.grad.numpy()}


def unet(inputs, dtype):
    model = Unet3D(CHANNELS, compute_dtype=dtype)
    model.load_state_dict({k[len("state/"):]: torch.from_numpy(inputs[k])
                           for k in inputs.keys() if k.startswith("state/")})
    return model.to(torch.promote_types(dtype, torch.float32))


def forward(inputs, mesh, dtype):
    """The eval forward of this rank's block of ``unet_x``."""
    model = unet(inputs, dtype).eval()
    x = local(mesh, inputs, "unet_x")
    with batch_sharding(mesh, spatial=True).active(), torch.no_grad():
        return model(x).numpy()


def step(inputs, mesh):
    """{loss, grad/<name>, stat/<name>, metric/<key>, exchange counts} of
    one float64 training step on this rank's block of ``step_x``."""
    model = unet(inputs, torch.float64)
    optimizer = make_optimizer(model.parameters(), 1e-3, betas=(0.99, 0.999),
                               weight_decay=1e-5)
    learner = UnetSegmentationLearner(
        types.SimpleNamespace(batch_size=len(inputs["step_x"])), None, model,
        optimizer, None, 1, patch_whd=inputs["step_x"].shape[1:4][::-1],
        device="cpu", mesh=mesh)
    collectives.reset_exchange_counts()
    with batch_sharding(mesh, spatial=True).active():
        metrics = learner.train_patches(local(mesh, inputs, "step_x"),
                                        local(mesh, inputs, "step_y"))
    out = {f"metric/{k}": v.double().numpy() for k, v in metrics.items()}
    out.update({f"grad/{k}": p.grad.numpy()
                for k, p in model.named_parameters()})
    out.update({f"stat/{k}": b.numpy() for k, b in model.named_buffers()})
    out.update({f"count/{k}": np.int64(v)
                for k, v in collectives.EXCHANGE_COUNTS.items()})
    return out


def controls(inputs, mesh):
    """The step with the exchanges' adjoint dropped, and with BN counting
    this rank's positions times the world."""
    out = {}
    scatter = collectives._scatter_add
    collectives._scatter_add = lambda g, plan, shape: scatter(
        g, dataclasses.replace(plan, send=(), recv=()), shape)
    try:
        out.update({f"no_adjoint/{k}": v
                    for k, v in step(inputs, mesh).items()})
    finally:
        collectives._scatter_add = scatter
    count = spatial.global_count
    spatial.global_count = lambda x: x.numel() // x.shape[-1] * mesh.world
    try:
        out.update({f"bn_count/{k}": v
                    for k, v in step(inputs, mesh).items()})
    finally:
        spatial.global_count = count
    return out


def main():
    coordinator, data, space, rank, inputs_path, outdir = sys.argv[1:7]
    data, space, rank = int(data), int(space), int(rank)
    torch.set_num_threads(1)
    distributed.initialize(coordinator, data * space, rank, device="cpu")
    mesh = make_mesh(data, space)
    inputs = np.load(inputs_path)
    out = {"rank": np.int64(mesh.rank)}
    if "conv_x" not in inputs:
        out.update(exchange_cases(mesh))
    else:
        out.update(conv_grads(inputs, mesh))
        out["forward64"] = forward(inputs, mesh, torch.float64)
    if "step_x" in inputs:
        out["forward32"] = forward(inputs, mesh, torch.float32)
        out.update({f"step/{k}": v for k, v in step(inputs, mesh).items()})
        out.update(controls(inputs, mesh))
    distributed.shutdown()

    jax_loaded = [m for m in sys.modules
                  if m in ("jax", "stroke_prediction_tpu")
                  or m.startswith(("jax.", "stroke_prediction_tpu."))]
    if jax_loaded:
        raise AssertionError(f"a rank imported {jax_loaded[:5]}")
    np.savez(os.path.join(outdir, f"rank{mesh.rank}.npz"), **out)
    print(f"SPATIAL_WORKER_OK rank={mesh.rank}", flush=True)


if __name__ == "__main__":
    main()
