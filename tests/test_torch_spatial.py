"""Port parity for the ``space`` mesh axis (H sharded over the ranks):
``parallel/mesh.py``'s 2-D mesh, block rule and spatial ``shard_batch``,
``parallel/collectives.py::exchange_rows`` and its adjoint, and the ops of
``parallel/spatial.py``.  The ranks are gloo processes on the CPU
(_torch_spatial_worker.py, which imports no JAX), one spawn per mesh shape:
two and three ranks for the exchange, ``{data: 1, space: 4}`` for the
conv's gradient (the counterpart of tests/test_parallel.py's spatially
sharded s2d gradient, there at ``{data: 2, space: 4}``) and the U-Net's
eval forward with one output row a rank.

Tolerances: the exchange's rows bit for bit and its adjoint against the
rows' gradients summed by hand exactly (each row gets at most one term per
rank, added in rank order on both sides); ``<E x, y> = <x, E^T y>`` over
the ranks to 1e-12 relative; the conv's float64 dx, dk and db against
JAX's one-device float64 gradient (``lax.conv_general_dilated``: the s2d
kernel keeps float32 arithmetic inside) at 1e-7 * max |ref|; the forward
against the port's one-process float64 forward at 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stroke_prediction_tpu_torch.eval.metrics import binary_measures
from stroke_prediction_tpu_torch.models.layers import (
    BatchNorm, ConvTranspose3d)
from stroke_prediction_tpu_torch.parallel import collectives, mesh
from stroke_prediction_tpu_torch.train.unet_learner import (
    UnetSegmentationLearner)

import _torch_spatial_worker as worker

torch.set_num_threads(1)

GRAD_REL, FORWARD_TOL, INNER_REL = 1e-7, 1e-12, 1e-12


def conv_inputs():
    """The shapes and draws of tests/test_parallel.py's spatially sharded
    s2d gradient: x (4, 6, 16, 12, 2), k (3, 3, 3, 2, 4), b (4)."""
    rng = np.random.RandomState(1)
    return {"conv_x": rng.rand(4, 6, 16, 12, 2),
            "conv_k": rng.rand(3, 3, 3, 2, 4) - 0.5,
            "conv_b": rng.rand(4)}


def jax_conv_grads(inputs):
    """JAX's one-device float64 (dx, dk, db) of ``sum(elu(conv(x))^2)``."""
    def f(x, k, b):
        y = jax.lax.conv_general_dilated(
            x, k, (1, 1, 1), "VALID",
            dimension_numbers=("NDHWC", "DHWIO", "NDHWC"),
            precision=jax.lax.Precision.HIGHEST) + b
        return jnp.sum(jax.nn.elu(y) ** 2)

    jax.config.update("jax_enable_x64", True)
    try:
        return [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2))(
            *(jnp.asarray(inputs[k], jnp.float64)
              for k in ("conv_x", "conv_k", "conv_b")))]
    finally:
        jax.config.update("jax_enable_x64", False)


def check_conv(ranks, m_data, m_space, inputs, grads=None):
    """Each rank's dx against its rows and block of JAX's (``grads``, or
    computed here), dk and db whole, at GRAD_REL of the tensor's
    largest."""
    dx, dk, db = grads if grads is not None else jax_conv_grads(inputs)
    for r, got in enumerate(ranks):
        m = mesh.Mesh(r, m_data * m_space, m_space)
        lo, hi = mesh.block(dx.shape[2], m.space_index, m_space)
        want = {"dx": dx[m.data_index::m_data, :, lo:hi], "dk": dk, "db": db}
        for name, ref in want.items():
            scale = np.abs(ref if name != "dx" else dx).max()
            err = np.abs(got[f"conv/{name}"] - ref).max() / scale
            assert err <= GRAD_REL, (r, name, err)


def unet_variables():
    """The weights of tests/test_parallel.py's fixture (``model.init`` at
    PRNGKey(0)) in the port's layout, and its (8, 44, 44, 44, 2) batch."""
    from stroke_prediction_tpu.models.unet3d import Unet3D as JaxUnet3D
    from stroke_prediction_tpu_torch.models.convert import (
        unet_state_from_jax)

    rng = np.random.RandomState(0)
    x = rng.rand(8, 44, 44, 44, 2).astype(np.float32)
    model = JaxUnet3D(channels=worker.CHANNELS)
    variables = model.init(jax.random.PRNGKey(0), jnp.asarray(x[:2]),
                           train=False)
    state = {f"state/{k}": v.double().numpy()
             for k, v in unet_state_from_jax(variables).items()}
    return model, variables, x, state


@pytest.fixture(scope="module")
def exchanges(tmp_path_factory):
    """{rank count: each rank's exchange results}, the two groups run side
    by side."""
    dirs = {n: tmp_path_factory.mktemp(f"exchange{n}") for n in (2, 3)}
    procs = {n: worker.start(1, n, {"none": np.zeros(1)}, d)
             for n, d in dirs.items()}
    try:
        return {n: worker.join(p, dirs[n]) for n, p in procs.items()}
    finally:
        for p in (q for group in procs.values() for q in group):
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def space4(tmp_path_factory):
    """(inputs, each rank's results, the references: JAX's conv gradients
    and the port's one-process float64 forward, computed while the ranks
    run) at {data: 1, space: 4}."""
    _, _, x, state = unet_variables()
    inputs = dict(conv_inputs(), unet_x=x.astype(np.float64), **state)
    outdir = tmp_path_factory.mktemp("space4")
    procs = worker.start(1, 4, inputs, outdir)
    try:
        refs = {"conv": jax_conv_grads(inputs),
                "one64": worker.forward(inputs, None, torch.float64)}
    finally:
        ranks = worker.join(procs, outdir)
    return inputs, ranks, refs


@pytest.mark.parametrize("n", [2, 3])
def test_exchange_rows_and_adjoint(exchanges, n):
    """Every blocking of EXCHANGE_CASES (needs over several owners, from a
    non-neighbour, of no rows; empty blocks): the rows fetched bit for bit,
    the gradient of ``<E x, y>`` the adjoint summed by hand, and
    ``<E x, y> = <x, E^T y>`` over the ranks; a bfloat16 tensor moves
    intact."""
    cases = len(worker.EXCHANGE_CASES[n])
    for r, got in enumerate(exchanges[n]):
        assert got["exchange/bfloat16/equal"], r
        for i in range(cases):
            key = f"exchange/{i}/"
            assert got[key + "equal"], (r, i)
            assert got[key + "grad_err"] == 0.0, (r, i)
            lhs, rhs = float(got[key + "lhs"]), float(got[key + "rhs"])
            assert abs(lhs - rhs) <= INNER_REL * max(abs(lhs), 1.0), (r, i)


def test_conv_gradient_at_space4_matches_jax(space4):
    """The counterpart of tests/test_parallel.py's spatially sharded s2d
    gradient at {data: 1, space: 4}: H 16 -> 14, output blocks of 3 and 4
    rows, each reading rows of two or three owners."""
    inputs, ranks, refs = space4
    check_conv(ranks, 1, 4, inputs, refs["conv"])


def test_forward_at_space4_matches_one_process(space4):
    """The fixture's eval forward at {data: 1, space: 4}: the output's H 4
    is one row a rank, and each rank's row is that of the port's
    one-process float64 forward."""
    _, ranks, refs = space4
    one = refs["one64"]
    for r, got in enumerate(ranks):
        assert got["forward64"].shape == (8, 4, 1, 4, 2)
        np.testing.assert_allclose(got["forward64"], one[:, :, r:r + 1],
                                   rtol=0, atol=FORWARD_TOL)


def test_block_rule_and_two_d_mesh():
    """Rank ``d * space + s`` holds data index ``d`` and space index ``s``
    (JAX's ``reshape(data, space)``); blocks balanced by the global H,
    empty where H < space; rows ``[d::data]``; ``shard_batch`` cuts arrays
    of five axes along H as well."""
    m = mesh.Mesh(rank=5, world=6, space=3)
    assert (m.data, m.data_index, m.space_index) == (2, 1, 2)
    assert m.space_rank(0) == 3
    assert [mesh.block(104, s, 4) for s in range(4)] == [
        (0, 26), (26, 52), (52, 78), (78, 104)]
    assert [mesh.block(19, s, 4) for s in range(4)] == [
        (0, 4), (4, 9), (9, 14), (14, 19)]
    assert [mesh.block(2, s, 3) for s in range(3)] == [(0, 0), (0, 1), (1, 2)]
    sharding = mesh.batch_sharding(m, spatial=True)
    assert sharding.spatial and sharding.reduces
    assert list(sharding.take(np.arange(6))) == [1, 3, 5]
    assert sharding.global_size(3) == 6
    tree = {"x": np.arange(4 * 7).reshape(4, 1, 7, 1, 1), "y": np.zeros(4),
            "odd": np.zeros((3, 1, 7, 1, 1)), "none": None}
    local = mesh.shard_batch(m, tree, spatial=True)
    assert local["x"].shape == (2, 1, 3, 1, 1)
    assert list(local["x"][:, 0, :, 0, 0].ravel()) == [11, 12, 13, 25, 26, 27]
    assert local["y"].shape == (2,) and local["odd"].shape == (3, 1, 7, 1, 1)
    assert local["none"] is None
    rows_only = mesh.shard_batch(m, tree)
    assert rows_only["x"].shape == (2, 1, 7, 1, 1)


def test_spatial_sharding_refusals():
    """A mesh must fit the group; a 2-D mesh shards H (rows alone would be
    counted once per space rank); an exchange needs a spatial step, rows by
    the block rule, needs inside H, and NCCL or gloo."""
    with pytest.raises(ValueError):
        mesh.Mesh(rank=0, world=4, space=3)
    with pytest.raises(ValueError):
        mesh.make_mesh(data=2, space=2)
    with pytest.raises(ValueError):
        mesh.batch_sharding(mesh.Mesh(0, 4, 2))
    with pytest.raises(ValueError):
        mesh.row_sharding(mesh.Mesh(0, 4, 2), 4)
    x = torch.zeros(1, 1, 2, 1, 1)
    with pytest.raises(ValueError, match="no spatial"):
        collectives.exchange_rows(x, 4, [(0, 2), (2, 4)])
    with mesh.batch_sharding(mesh.Mesh(0, 2, 2), spatial=True).active():
        with pytest.raises(ValueError, match="block rule"):
            collectives.exchange_rows(x, 6, [(0, 3), (3, 6)])
        with pytest.raises(ValueError, match="outside"):
            collectives.exchange_rows(x, 4, [(0, 5), (2, 4)])
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(collectives.dist, "get_backend", lambda: "ucc")
            with pytest.raises(NotImplementedError):
                collectives.exchange_rows(x, 4, [(0, 2), (2, 4)])
            mp.setattr(collectives.dist, "get_backend", lambda: "nccl")
            with pytest.raises(ValueError, match="CUDA"):
                collectives.exchange_rows(x, 4, [(0, 2), (2, 4)])


class _Reached(Exception):
    """A collective was reached."""


@pytest.mark.parametrize("what", ["global_mean", "distances", "grouped_bn",
                                  "transposed_conv", "learner_crop"])
def test_unported_paths_refuse_h_sharding(what):
    """The learner's crop of whole patches raises under a spatial step,
    before any collective.  The CAE's pieces that this refused before they
    were ported (a global mean over unequal blocks, grouped BN, transposed
    convs) and HD / ASSD (the EDT along H) now run there up to their first
    collective (their values: tests/test_torch_spatial_ops.py)."""
    x = torch.rand(2, 3, 4, 3, 1)

    def reached(*args, **kw):
        raise _Reached

    with mesh.batch_sharding(mesh.Mesh(0, 2, 2), spatial=True).active(), \
            pytest.MonkeyPatch.context() as mp:
        mp.setattr(collectives.dist, "get_backend", lambda: "gloo")
        mp.setattr(collectives.dist, "all_reduce", reached)
        with pytest.raises(NotImplementedError if what == "learner_crop"
                           else _Reached):
            if what == "global_mean":
                collectives.global_mean(x)
            elif what == "distances":
                binary_measures(x, x, with_distances=True)
            elif what == "grouped_bn":
                BatchNorm(1).affine(x, groups=2)
            elif what == "transposed_conv":
                ConvTranspose3d(1, 1, strides=(2, 2, 2))(x)
            else:
                UnetSegmentationLearner.crop(
                    None, {"images": x, "labels": x})
