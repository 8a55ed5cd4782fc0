"""One rank of the port's spatial op tests (test_torch_spatial_ops.py).

    python tests/_torch_spatial_ops_worker.py HOST:PORT DATA SPACE RANK INPUTS OUTDIR

Imports torch and stroke_prediction_tpu_torch only (checked at the end: no
JAX in this process).  Joins a gloo group of DATA * SPACE ranks, builds the
``(DATA, SPACE)`` mesh and runs each op of :data:`OPS` on this rank's block
of H of its float64 input (``INPUTS``, an .npz the test wrote): the output
block, the gradient of ``sum(y * ct)`` (``ct`` the test's cotangent, this
rank's block of it) with respect to the input block and, summed over the
ranks, to the op's parameters.  A global mean's loss is the same global
value on every rank, so its input gradient is divided by the world.  The
measures (Dice, HD, ASSD, ...) are values only.

:func:`run_op` with no mesh is the one-process reference the test computes.
Writes ``OUTDIR/rank<RANK>.npz`` and prints ``SPATIAL_WORKER_OK``.
"""

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from stroke_prediction_tpu_torch.data.augment import elastic_deform_batch
from stroke_prediction_tpu_torch.eval.metrics import binary_measures
from stroke_prediction_tpu_torch.models.layers import (
    BatchNorm, Conv3d, ConvTranspose3d)
from stroke_prediction_tpu_torch.parallel import (
    collectives, distributed, spatial)
from stroke_prediction_tpu_torch.parallel.mesh import (
    batch_sharding, block, make_mesh)

# name -> (input shape (B, D, H, W, C), op): H chosen so that the four
# space ranks' blocks of the input, the output or both are unequal, and a
# halo or the global padding crosses ranks
OPS = {
    "conv_s2_pad1": ((2, 5, 13, 6, 2), dict(kind="conv", c_out=3,
                                            strides=2, padding=(1, 1, 1))),
    "conv_s2_valid": ((2, 5, 15, 7, 2), dict(kind="conv", c_out=3,
                                             strides=2, padding="VALID")),
    "conv_pad122": ((2, 4, 7, 5, 2), dict(kind="conv", c_out=3, strides=1,
                                          padding=(1, 2, 2))),
    "ct_k3_s1": ((2, 3, 6, 4, 2), dict(kind="ct", c_out=3, k=3, s=1)),
    "ct_k3_s2": ((2, 3, 5, 4, 2), dict(kind="ct", c_out=3, k=3, s=2)),
    "ct_k2_s2": ((2, 3, 5, 4, 2), dict(kind="ct", c_out=3, k=2, s=2)),
    "crop": ((2, 3, 13, 4, 2), dict(kind="crop", p=2)),
    "bn_grouped": ((4, 3, 9, 4, 3), dict(kind="bn", groups=2)),
    "mean": ((2, 3, 9, 4, 2), dict(kind="mean")),
    "mean_flat": ((2, 3), dict(kind="mean")),
    "warp": ((2, 4, 13, 6, 1), dict(kind="warp")),
    "measures": ((2, 6, 13, 8, 1), dict(kind="measures")),
}
MEASURES = ("dc", "hd", "assd", "precision", "sensitivity", "specificity")


def out_height(name):
    """The global H of ``name``'s output (None: not a volume)."""
    shape, op = OPS[name]
    if len(shape) < 5 or op["kind"] in ("mean", "measures"):
        return None
    h = shape[2]
    if op["kind"] == "conv":
        pad = 0 if op["padding"] == "VALID" else op["padding"][1]
        return (h + 2 * pad - 3) // op["strides"] + 1
    if op["kind"] == "ct":
        return (h - 1) * op["s"] + op["k"]
    if op["kind"] == "crop":
        return h - 2 * op["p"]
    return h


def _module(name, inputs):
    shape, op = OPS[name]
    c_in = shape[-1]
    if op["kind"] == "conv":
        m = Conv3d(c_in, op["c_out"], strides=(op["strides"],) * 3,
                   padding=op["padding"])
    elif op["kind"] == "ct":
        m = ConvTranspose3d(c_in, op["c_out"], (op["k"],) * 3,
                            (op["s"],) * 3)
    else:
        m = BatchNorm(c_in)
    m.load_state_dict({k: torch.from_numpy(inputs[f"{name}/{k}"])
                       for k in m.state_dict()})
    return m.double()


def _apply(name, inputs, x, extra):
    """The op of ``name`` on ``x`` (this rank's block under a spatial step)
    -> (output, module or None)."""
    op = OPS[name][1]
    kind = op["kind"]
    if kind in ("conv", "ct", "bn"):
        m = _module(name, inputs)
        if kind == "conv":
            return m(x, "elu", 1.0), m
        if kind == "ct":
            return m(x), m
        return m(x, op["groups"]), m
    if kind == "crop":
        h, p = x.shape[2], op["p"]
        if spatial.active():
            h = spatial.height(x)
            return spatial.crop_rows(x, h, h - 2 * p, p), None
        return x[:, :, p:h - p], None
    if kind == "mean":
        return collectives.global_mean(x), None
    if kind == "warp":
        return elastic_deform_batch(x, extra), None
    m = binary_measures(x, extra, with_distances=True)
    return torch.stack([getattr(m, f).double() for f in MEASURES]), None


def output_shape(name, inputs):
    """The shape of ``name``'s one-process output."""
    extra = None
    if OPS[name][1]["kind"] == "warp":
        extra = torch.from_numpy(inputs[f"{name}/fields"])
    with torch.no_grad():
        y, _ = _apply(name, inputs, torch.from_numpy(inputs[f"{name}/x"]),
                      extra)
    return tuple(y.shape)


def run_op(name, inputs, mesh=None):
    """{y, dx, dp/<param>, stat/<buffer>} of ``name`` on this rank's block
    (the whole input without a mesh)."""
    shape, op = OPS[name]
    kind = op["kind"]

    def local(key, h=None):
        a = inputs[key]
        if mesh is None:
            return torch.from_numpy(a.copy())
        if a.ndim >= 5:
            lo, hi = block(a.shape[2] if h is None else h, mesh.space_index,
                           mesh.space)
            a = a[:, :, lo:hi]
        return torch.from_numpy(np.ascontiguousarray(a))

    x = local(f"{name}/x")
    extra = None
    if kind == "warp":
        # the fields (B, 3, D, H, W): this rank's block of their H
        f = inputs[f"{name}/fields"]
        if mesh is not None:
            lo, hi = block(f.shape[3], mesh.space_index, mesh.space)
            f = f[:, :, :, lo:hi]
        extra = torch.from_numpy(np.ascontiguousarray(f))
    elif kind == "measures":
        extra = local(f"{name}/target")
    grad = kind != "measures"
    x.requires_grad_(grad)
    sharding = batch_sharding(mesh, spatial=True)
    out = {}
    with sharding.active():
        y, m = _apply(name, inputs, x, extra)
        if grad:
            if kind == "mean":
                y.backward()
            else:
                (y * local(f"{name}/ct", out_height(name))).sum().backward()
    out["y"] = y.detach().numpy()
    if grad:
        world = mesh.world if mesh is not None else 1
        out["dx"] = x.grad.numpy() / (world if kind == "mean" else 1)
    if m is not None:
        for k, p in m.named_parameters():
            g = p.grad.clone()
            if mesh is not None:
                dist.all_reduce(g)
            out[f"dp/{k}"] = g.numpy()
        out.update({f"stat/{k}": b.numpy() for k, b in m.named_buffers()})
    return out


def main():
    coordinator, data, space, rank, inputs_path, outdir = sys.argv[1:7]
    data, space, rank = int(data), int(space), int(rank)
    torch.set_num_threads(1)
    distributed.initialize(coordinator, data * space, rank, device="cpu")
    mesh = make_mesh(data, space)
    inputs = np.load(inputs_path)
    out = {"rank": np.int64(mesh.rank)}
    for name in OPS:
        collectives.reset_exchange_counts()
        out.update({f"{name}/{k}": v
                    for k, v in run_op(name, inputs, mesh).items()})
        out.update({f"{name}/count/{k}": np.int64(v)
                    for k, v in collectives.EXCHANGE_COUNTS.items()})
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
