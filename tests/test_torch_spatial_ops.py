"""Port parity for the ops that the rest of the ``space`` axis adds (H
sharded over the ranks, ``parallel/spatial.py``): the CAE's stride-2 convs
(padding 1 and VALID), its decoder's (1, 2, 2)-padded stride-1 conv, the
three transposed convs (k 3 stride 1, k 3 stride 2, k 2 stride 2), the CTP
crop, grouped BN, ``global_mean`` (over a volume, and over a tensor without
H, which every space rank holds), the elastic warp with given fields, and
HD / ASSD.  Four gloo processes on the CPU (_torch_spatial_ops_worker.py,
which imports no JAX) at ``{data: 1, space: 4}``, each on its block of H;
the H of every case makes the four blocks of its input or its output
unequal, and its halos or the global padding cross ranks.

Limits: each rank's output block, its input gradient block and the
parameter gradients summed over the ranks against the port's one-process
float64 op at 1e-12 of the tensor's largest (HD bit for bit: the EDT is
exact); against the JAX package's op under ``jit`` on the 8-device CPU
mesh, its input constrained inside ``jit`` to ``batch_sharding(make_mesh(
data=1, space=4), spatial=True)`` (GSPMD partitions it, padding the uneven
H; ``device_put`` refuses an H that four devices do not divide), in float32, at 1e-6 of the tensor's
largest, the float32 limit of test_torch_spatial_unet.py (1e-5 for the
gradients, whose float32 sums run over more terms).  The controls of the
padding and of the draws' H are test_torch_spatial_cae.py's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stroke_prediction_tpu.eval import metrics as jax_metrics
from stroke_prediction_tpu.models import layers as jax_layers
from stroke_prediction_tpu.ops.warp import map_coordinates_linear
from stroke_prediction_tpu.parallel import mesh as jax_mesh
from stroke_prediction_tpu_torch.parallel import mesh

import _torch_spatial_ops_worker as worker
import _torch_spatial_worker as spawner

torch.set_num_threads(1)

DATA, SPACE = 1, 4
ONE_PROCESS_REL = 1e-12
JAX_REL, JAX_GRAD_REL = 1e-6, 1e-5


def op_inputs():
    """Every op's float64 input, parameters and cotangent, from one
    seed."""
    rs = np.random.RandomState(11)
    out = {}
    for name, (shape, op) in worker.OPS.items():
        kind = op["kind"]
        out[f"{name}/x"] = rs.randn(*shape)
        if kind in ("conv", "ct"):
            k = (3,) * 3 if kind == "conv" else (op["k"],) * 3
            out[f"{name}/kernel"] = rs.randn(*k, shape[-1], op["c_out"]) * 0.3
            out[f"{name}/bias"] = rs.randn(op["c_out"]) * 0.1
        elif kind == "bn":
            out[f"{name}/x"] = out[f"{name}/x"] * 2.0 + 0.5
            out[f"{name}/scale"] = 1.0 + rs.rand(shape[-1])
            out[f"{name}/bias"] = rs.randn(shape[-1]) * 0.1
            out[f"{name}/mean"] = rs.rand(shape[-1])
            out[f"{name}/var"] = 1.0 + rs.rand(shape[-1])
        elif kind == "warp":
            # displacements of a few rows: points cross the ranks' blocks
            # and some leave the volume
            b, d, h, w, _ = shape
            out[f"{name}/x"] = rs.rand(*shape)
            out[f"{name}/fields"] = rs.randn(b, 3, d, h, w) * np.array(
                [0.6, 3.0, 1.5]).reshape(1, 3, 1, 1, 1)
        elif kind == "measures":
            out[f"{name}/x"] = rs.rand(*shape)
            out[f"{name}/target"] = rs.rand(*shape)
        if kind not in ("mean", "measures"):
            out[f"{name}/ct"] = rs.randn(*worker.output_shape(name, out))
    return out


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(inputs, each rank's results, the one-process results)."""
    inputs = op_inputs()
    outdir = tmp_path_factory.mktemp("spatial_ops")
    procs = spawner.start(DATA, SPACE, inputs, str(outdir),
                          script=worker.__file__)
    one = {name: worker.run_op(name, inputs) for name in worker.OPS}
    ranks = spawner.join(procs, str(outdir))
    return inputs, ranks, one


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _block(a, s, h=None):
    lo, hi = mesh.block(a.shape[2] if h is None else h, s, SPACE)
    return a[:, :, lo:hi]


def _is_volume(name):
    return worker.out_height(name) is not None


@pytest.mark.parametrize("name", list(worker.OPS))
def test_op_at_space4_matches_one_process(setup, name):
    """Each rank's output block and input gradient block, and the parameter
    gradients and running statistics, against the one-process float64 op;
    the measures equal on every rank, HD bit for bit."""
    inputs, ranks, one = setup
    for r, got in enumerate(ranks):
        y, ref = got[f"{name}/y"], one[name]["y"]
        if _is_volume(name):
            ref = _block(ref, r)
        if name == "measures":
            assert got[f"{name}/y"][1] == one[name]["y"][1], (r, "hd")
        assert y.shape == ref.shape, (r, y.shape, ref.shape)
        assert _rel(y, ref) <= ONE_PROCESS_REL, (r, "y", _rel(y, ref))
        if "dx" in one[name]:
            dx, want = got[f"{name}/dx"], one[name]["dx"]
            if name == "mean_flat":
                continue                 # summed over the ranks below
            want = _block(want, r)
            assert _rel(dx, want) <= ONE_PROCESS_REL, (r, "dx", _rel(dx,
                                                                      want))
        for key in one[name]:
            if key.startswith(("dp/", "stat/")):
                assert _rel(got[f"{name}/{key}"], one[name][key]) \
                    <= ONE_PROCESS_REL, (r, key)
        if name.startswith(("conv", "ct", "crop", "warp")):
            assert got[f"{name}/count/exchanges"] >= 1, r
    if name == "mean_flat":
        dx = sum(got[f"{name}/dx"] for got in ranks)
        assert _rel(dx, one[name]["dx"]) <= ONE_PROCESS_REL


# --------------------------------------------------------------- JAX's ops

def _jax_op(name, inputs):
    """(f(x) in float32 under the JAX package, args besides x)."""
    shape, op = worker.OPS[name]
    kind = op["kind"]
    f32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    if kind == "conv":
        m = jax_layers.Conv3d(op["c_out"], strides=(op["strides"],) * 3,
                              padding=op["padding"])
        params = {"params": {"kernel": f32(inputs[f"{name}/kernel"]),
                             "bias": f32(inputs[f"{name}/bias"])}}
        return lambda x: jax.nn.elu(m.apply(params, x))
    if kind == "ct":
        m = jax_layers.ConvTranspose3d(op["c_out"], (op["k"],) * 3,
                                       (op["s"],) * 3)
        params = {"params": {"ConvTranspose_0": {
            "kernel": f32(inputs[f"{name}/kernel"]),
            "bias": f32(inputs[f"{name}/bias"])}}}
        return lambda x: m.apply(params, x)
    if kind == "crop":
        p = op["p"]
        return lambda x: x[:, :, p:x.shape[2] - p]
    if kind == "bn":
        m = jax_layers.BatchNorm()
        variables = {
            "params": {"BatchNorm_0": {"scale": f32(inputs[f"{name}/scale"]),
                                       "bias": f32(inputs[f"{name}/bias"])}},
            "batch_stats": {"BatchNorm_0": {
                "mean": f32(inputs[f"{name}/mean"]),
                "var": f32(inputs[f"{name}/var"])}}}
        return lambda x: m.apply(variables, x, groups=op["groups"],
                                 mutable=["batch_stats"])[0]
    if kind == "mean":
        return jnp.mean
    if kind == "warp":
        fields = f32(inputs[f"{name}/fields"])
        _, d, h, w, _ = shape
        grid = jnp.stack(jnp.meshgrid(*(jnp.arange(n, dtype=jnp.float32)
                                        for n in (d, h, w)), indexing="ij"))
        return lambda x: jax.vmap(map_coordinates_linear)(
            x[..., 0], grid[None] + fields)[..., None]
    target = f32(inputs[f"{name}/target"])

    def measures(x):
        m = jax_metrics.binary_measures(x, target, with_distances=True)
        return jnp.stack([getattr(m, f) for f in worker.MEASURES])
    return measures


@pytest.fixture(scope="module")
def jax_results(setup):
    """{name: (y, dx)} of JAX's float32 op under jit, the input sharded
    along H over a {data: 1, space: 4} mesh of the 8-device CPU backend."""
    inputs = setup[0]
    sharding = jax_mesh.batch_sharding(
        jax_mesh.make_mesh(data=DATA, space=SPACE), spatial=True)
    out = {}
    for name, (shape, op) in worker.OPS.items():
        op_f = _jax_op(name, inputs)
        x = jnp.asarray(inputs[f"{name}/x"], jnp.float32)

        def f(v, op_f=op_f):
            # H of an uneven size cannot be placed on the devices with
            # device_put; inside jit GSPMD partitions it (padded)
            if v.ndim == 5:
                v = jax.lax.with_sharding_constraint(v, sharding)
            return op_f(v)

        y = jax.jit(f)(x)
        dx = None
        if op["kind"] == "mean":
            dx = jax.jit(jax.grad(f))(x)
        elif op["kind"] != "measures":
            ct = jnp.asarray(inputs[f"{name}/ct"], jnp.float32)
            dx = jax.jit(jax.grad(lambda v: jnp.sum(f(v) * ct)))(x)
        out[name] = (np.asarray(y, np.float64),
                     None if dx is None else np.asarray(dx, np.float64))
    return out


@pytest.mark.parametrize("name", list(worker.OPS))
def test_op_at_space4_matches_jax(setup, jax_results, name):
    """Each rank's output block and input gradient block against the JAX
    package's float32 op run under jit with H sharded over four devices."""
    _, ranks, _ = setup
    y_ref, dx_ref = jax_results[name]
    dxs = []
    for r, got in enumerate(ranks):
        ref = _block(y_ref, r) if _is_volume(name) else y_ref
        y = got[f"{name}/y"]
        if name == "measures":
            # Dice .. specificity and HD / ASSD (finite: both masks hold
            # voxels)
            assert np.all(np.isfinite(y)), y
        assert _rel(y, ref) <= JAX_REL, (r, "y", _rel(y, ref))
        if dx_ref is not None:
            dxs.append(got[f"{name}/dx"])
    if dx_ref is None:
        return
    dx = sum(dxs) if name == "mean_flat" else np.concatenate(dxs, axis=2)
    assert _rel(dx, dx_ref) <= JAX_GRAD_REL, ("dx", _rel(dx, dx_ref))
