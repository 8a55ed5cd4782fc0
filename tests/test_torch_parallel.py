"""Port parity for data-parallel U-Net training (parallel/mesh.py,
parallel/collectives.py, global BN moments, the global Dice and measures,
the learner's sharded step): two gloo processes on the CPU
(_torch_parallel_worker.py, which imports no JAX) against the JAX step on a
2-device data mesh and against the port's one-process step.

Tolerances, those of test_torch_train.py's float64 step: loss and running
statistics 1e-12, every gradient 1e-7 * max |ref| of its tensor; the
measures as test_torch_metrics.py (1e-6, HD / ASSD 1e-4) against JAX, and
against the port's one-process measures the counts and HD exactly and ASSD
to 1e-6 relative (a float32 sum of distances, added in another order).  A
replicated chunk runs the one-process step on each rank, so it must equal
that step bit for bit.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stroke_prediction_tpu.eval import metrics as jax_metrics
from stroke_prediction_tpu.eval.metrics import (
    batch_dice_loss as jax_batch_dice_loss)
from stroke_prediction_tpu.models import layers as jax_layers
from stroke_prediction_tpu.models import unet3d as jax_unet3d
from stroke_prediction_tpu.models.unet3d import Unet3D as JaxUnet3D
from stroke_prediction_tpu.parallel import mesh as jax_mesh
from stroke_prediction_tpu_torch.cli.common import free_port
from stroke_prediction_tpu_torch.eval.metrics import (
    batch_dice_loss, binary_measures)
from stroke_prediction_tpu_torch.models.convert import (
    _unet_key_map, unet_state_from_jax)
from stroke_prediction_tpu_torch.parallel import collectives
from stroke_prediction_tpu_torch.parallel import mesh

import _torch_parallel_worker as worker

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CHANNELS = worker.CHANNELS
PATCH = worker.PATCH
WORLD = 2
SPAWN_TIMEOUT = 180          # seconds, for both ranks together
LOSS_TOL, GRAD_REL, STATS_TOL = 1e-12, 1e-7, 1e-12
DICE_EPS = 1e-7
ASSD_REL = 1e-6


def _random_variables(tree, rs, path=()):
    """Random flax variables: uniform conv weights and non-trivial BN
    parameters and running statistics (as test_torch_train.py)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _random_variables(v, rs, path + (k,))
            continue
        if k == "var":
            a = rs.uniform(0.5, 1.5, v.shape)
        elif k == "scale":
            a = rs.uniform(0.7, 1.3, v.shape)
        elif "BatchNorm_0" in path:
            a = rs.uniform(-0.3, 0.3, v.shape)
        else:
            a = rs.uniform(-1, 1, v.shape) / np.sqrt(
                np.prod(tree["kernel"].shape[:-1]))
        out[k] = a.astype(np.float32)
    return out


def _leaf(tree, path):
    for p in path:
        tree = tree[p]
    return np.asarray(tree)


class _Float64Numpy:
    """``jax.numpy`` with ``float32`` read as ``float64`` (see
    test_torch_train.py): the JAX modules' float32 casts run in float64."""

    def __getattr__(self, name):
        return getattr(jnp, "float64" if name == "float32" else name)


def _blob(shape, center, r, rs):
    grids = np.ogrid[tuple(slice(0, s) for s in shape)]
    d2 = sum((g - c) ** 2 for g, c in zip(grids, center))
    return np.clip((d2 <= r * r) + 0.25 * rs.randn(*shape), 0, 1)


def _inputs(rs, variables):
    """The worker's inputs: float64 weights as the port's state dict, a
    4-row and a 3-row batch of patches, the Dice and the measures' data."""
    state = unet_state_from_jax(variables)
    out = {f"state/{k}": v.double().numpy() for k, v in state.items()}
    for key, b in (("", 4), ("_odd", 3)):
        out["images" + key] = rs.rand(b, *PATCH[::-1], 2) * 4
        out["labels" + key] = (rs.rand(b, 4, 4, 4, 2) > 0.5).astype(
            np.float64)
    # sums of ~1e-6, so epsilon (1e-7) moves the ratio
    out["dice_o"] = rs.rand(4, 3, 3, 3, 1) * 1e-4
    out["dice_t"] = (rs.rand(4, 3, 3, 3, 1) > 0.7) * 1e-4
    shape = (10, 12, 14)
    r = np.stack([_blob(shape, (5, 6, 7), 4 - i / 2, rs) for i in range(4)])
    t = np.stack([_blob(shape, (4, 6, 8), 3 + i / 2, rs) for i in range(4)])
    out["measures_blobs_r"] = r[..., None].astype(np.float32)
    out["measures_blobs_t"] = t[..., None].astype(np.float32)
    out["measures_empty_r"] = np.zeros_like(out["measures_blobs_r"])
    out["measures_empty_t"] = out["measures_blobs_t"]
    return out


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(inputs, [rank 0 results, rank 1 results], outdir): the two ranks
    spawned once, with a timeout of their own."""
    shapes = jax.eval_shape(lambda: JaxUnet3D(channels=CHANNELS).init(
        jax.random.PRNGKey(0), jnp.zeros((1,) + PATCH + (2,)), train=False))
    variables = _random_variables(shapes, np.random.RandomState(0))
    inputs = _inputs(np.random.RandomState(1), variables)
    outdir = tmp_path_factory.mktemp("parallel")
    path = outdir / "inputs.npz"
    np.savez(path, **inputs)
    coordinator = f"127.0.0.1:{free_port()}"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               TMPDIR=str(outdir))
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests",
                                      "_torch_parallel_worker.py"),
         coordinator, str(WORLD), str(rank), str(path), str(outdir)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for rank in range(WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=SPAWN_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out}"
        assert f"PARALLEL_WORKER_OK rank={rank}" in out, out
    ranks = [dict(np.load(outdir / f"rank{r}.npz")) for r in range(WORLD)]
    return np.load(path), variables, ranks, outdir


@pytest.fixture(scope="module")
def jax_step(setup):
    """JAX's float64 step on the 4-row batch sharded over a 2-device data
    mesh: (loss, grads, new batch_stats, {metric key: value})."""
    inputs, variables = setup[0], setup[1]
    model = JaxUnet3D(channels=CHANNELS, compute_dtype=jnp.float64)

    def loss(seg, labels):
        return (jax_batch_dice_loss(seg[..., 0:1], labels[..., 0:1])
                + jax_batch_dice_loss(seg[..., 1:2], labels[..., 1:2])) / 2

    @jax.jit
    def step(params, batch_stats, images, labels):
        def loss_fn(p):
            seg, mut = model.apply({"params": p, "batch_stats": batch_stats},
                                   images, train=True,
                                   mutable=["batch_stats"])
            return loss(seg, labels), (mut, seg)
        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    with pytest.MonkeyPatch.context() as mp:
        for mod in (jax_layers, jax_unet3d, jax_metrics):
            mp.setattr(mod, "jnp", _Float64Numpy())
        jax.config.update("jax_enable_x64", True)
        try:
            data_mesh = jax_mesh.make_data_mesh(WORLD)
            rows = jax_mesh.batch_sharding(data_mesh)
            rep = jax_mesh.replicate(data_mesh)
            put = jax.tree_util.tree_map
            (value, (mut, seg)), grads = step(
                put(lambda a: jax.device_put(jnp.asarray(a, jnp.float64),
                                             rep), variables["params"]),
                put(lambda a: jax.device_put(jnp.asarray(a, jnp.float64),
                                             rep), variables["batch_stats"]),
                jax.device_put(jnp.asarray(inputs["images"]), rows),
                jax.device_put(jnp.asarray(inputs["labels"]), rows))
            value, seg = float(value), np.asarray(seg)
            grads = jax.tree_util.tree_map(np.asarray, grads)
            stats = jax.tree_util.tree_map(np.asarray, mut["batch_stats"])
        finally:
            jax.config.update("jax_enable_x64", False)
    labels = inputs["labels"]
    metrics = {"loss": value}
    for c, name in enumerate(("core", "penu")):
        m = jax_metrics.binary_measures(
            jnp.asarray(seg[..., c:c + 1], jnp.float32),
            jnp.asarray(labels[..., c:c + 1], jnp.float32))
        metrics.update({f"{name}_{f}": float(getattr(m, f))
                        for f in worker.MEASURES})
    return value, grads, stats, metrics


def _one_process(inputs, images="images", labels="labels"):
    """The port's step in this process, no mesh."""
    return {f"step/{k}": v for k, v in
            worker.step(inputs, None, images, labels).items()}


def _check_step(got, loss, grads, stats):
    """Hold one rank's ``step/`` results to (loss, grads, stats) in the
    port's key space; returns the worst (loss, grad, stats) errors."""
    errs = [abs(float(got["step/metric/loss"]) - loss), 0.0, 0.0]
    for path, key in _unet_key_map():
        if path[0] == "params":
            ref = grads(path, key)
            err = np.abs(got[f"step/grad/{key}"] - ref).max() / np.abs(
                ref).max()
            errs[1] = max(errs[1], err)
        else:
            errs[2] = max(errs[2], np.abs(got[f"step/stat/{key}"]
                                          - stats(path, key)).max())
    return errs


def test_two_rank_step_matches_jax_mesh_step(setup, jax_step):
    """The 2-rank float64 step on each rank: the loss, all 44 gradients,
    the running statistics and the measures of the global batch, against
    JAX's step with the batch sharded over a 2-device data mesh."""
    loss, grads, stats, metrics = jax_step
    for rank, got in enumerate(setup[2]):
        errs = _check_step(got, loss, lambda p, k: _leaf(grads, p[1:]),
                           lambda p, k: _leaf(stats, p[1:]))
        assert errs[0] <= LOSS_TOL, (rank, errs)
        assert errs[1] <= GRAD_REL, (rank, errs)
        assert errs[2] <= STATS_TOL, (rank, errs)
        assert sum(k.startswith("step/grad/") for k in got) == 44
        for key, want in metrics.items():
            value = float(got[f"step/metric/{key}"])
            tol = 1e-4 if key.endswith(("_hd", "_assd")) else 1e-6
            assert np.isfinite(value) == np.isfinite(want), key
            if np.isfinite(want):
                assert abs(value - want) <= tol, (rank, key, value, want)


def test_two_rank_step_matches_one_process_step(setup):
    """The same step against the port's one-process step on the whole
    batch, and the two ranks against each other."""
    inputs, _, ranks, _ = setup
    one = _one_process(inputs)
    for rank, got in enumerate(ranks):
        errs = _check_step(got, float(one["step/metric/loss"]),
                           lambda p, k: one[f"step/grad/{k}"],
                           lambda p, k: one[f"step/stat/{k}"])
        assert errs[0] <= LOSS_TOL and errs[1] <= GRAD_REL \
            and errs[2] <= STATS_TOL, (rank, errs)
        for key in one:
            if key.startswith("step/metric/"):
                np.testing.assert_allclose(
                    got[key], one[key], atol=0, err_msg=key,
                    rtol=ASSD_REL if key.endswith("_assd") else 1e-12)
    for key in ranks[0]:
        if key.startswith("step/"):
            np.testing.assert_array_equal(ranks[0][key], ranks[1][key],
                                          err_msg=key)


def test_per_rank_bn_moments_fail_the_limits(setup, jax_step):
    """Control: the same step with each rank's BN moments its own (no
    reduction) is off JAX's mesh step by far more than the limits, in the
    loss and the gradients."""
    loss, grads, stats, _ = jax_step
    for rank, got in enumerate(setup[2]):
        control = {k.replace("control/", "step/", 1): v
                   for k, v in got.items() if k.startswith("control/")}
        errs = _check_step(control, loss, lambda p, k: _leaf(grads, p[1:]),
                           lambda p, k: _leaf(stats, p[1:]))
        assert errs[0] > 1e3 * LOSS_TOL and errs[1] > 1e3 * GRAD_REL, errs


def test_replicated_chunk_equals_one_process_step(setup):
    """A 3-row batch does not divide over 2 ranks: each rank runs it whole,
    with no collective, so each equals the one-process step bit for bit."""
    inputs, _, ranks, _ = setup
    one = _one_process(inputs, "images_odd", "labels_odd")
    for got in ranks:
        for key, want in one.items():
            np.testing.assert_array_equal(
                got[key.replace("step/", "replicated/", 1)], want,
                err_msg=key)


def test_dice_adds_epsilon_once(setup):
    """The Dice loss of each rank's rows under a sharded step is that of
    the whole batch: the three sums are reduced and epsilon added once.
    Adding it on each rank before the sum moves the loss far beyond the
    limit on these small sums."""
    inputs, _, ranks, _ = setup
    o, t = inputs["dice_o"], inputs["dice_t"]
    want = float(batch_dice_loss(torch.from_numpy(o), torch.from_numpy(t)))
    for got in ranks:
        assert abs(float(got["dice"]) - want) <= 1e-12 * abs(want)
    halves = [(o[r::WORLD], t[r::WORLD]) for r in range(WORLD)]
    inter = sum((a * b).sum() for a, b in halves)
    denom = sum((a * a).sum() + (b * b).sum() for a, b in halves)
    per_rank_eps = 1 - (2 * inter + WORLD * DICE_EPS) / (denom
                                                          + WORLD * DICE_EPS)
    assert abs(per_rank_eps - want) > 1e6 * 1e-12 * abs(want)


@pytest.mark.parametrize("case", ["blobs", "empty"])
def test_reduced_measures_equal_global(setup, case):
    """``binary_measures`` of each rank's rows under a sharded step equals
    the measures of the whole batch, HD and ASSD included (inf where the
    result is empty)."""
    inputs, _, ranks, _ = setup
    want = binary_measures(torch.from_numpy(inputs[f"measures_{case}_r"]),
                           torch.from_numpy(inputs[f"measures_{case}_t"]))
    for got in ranks:
        for f in worker.MEASURES:
            value, ref = float(got[f"measures_{case}/{f}"]), float(
                getattr(want, f))
            if f == "assd" and np.isfinite(ref):
                assert abs(value - ref) <= ASSD_REL * ref, (f, value, ref)
            else:
                assert value == ref, (f, value, ref)
        if case == "blobs":
            assert 0 < float(got["measures_blobs/hd"]) < 20
        else:
            assert np.isinf(float(got["measures_empty/hd"]))


def test_only_the_lead_writes(setup):
    """Two epochs of ``run_training`` on both ranks, each with an output
    base of its own: rank 0 wrote the checkpoints and curves, rank 1
    nothing; both trained on the same global loss."""
    _, _, ranks, outdir = setup
    lead = {p.name for p in (outdir / "files0").iterdir()}
    assert {"unet_unet.model", "unet_unet.optim", "unet_unet.json",
            "unet_unet_final.model"} <= lead, lead
    assert not list((outdir / "files1").iterdir())
    assert ranks[0]["learner_loss"] == ranks[1]["learner_loss"]


def test_timer_counts_the_global_batch_over_the_chips(setup):
    """Each rank's ``StepTimer`` counts the global batch (two volumes a
    pass, one on each rank) over the mesh's two chips."""
    for got in setup[2]:
        assert list(got["timer"]) == [2, WORLD]


def test_row_rule_and_shard_batch():
    """Rows ``[rank::world]`` where the batch divides over the mesh, the
    whole batch elsewhere (JAX ``shard_batch``'s rule); the global batch
    of a sharded step and the identity of the collectives outside one."""
    m = mesh.Mesh(rank=1, world=2)
    rows = np.arange(6)
    sharded = mesh.row_sharding(m, 6)
    assert sharded.reduces and list(sharded.take(rows)) == [1, 3, 5]
    assert sharded.global_size(3) == 6
    replicated = mesh.row_sharding(m, 5)
    assert not replicated.reduces and replicated.take(rows) is rows
    assert replicated.global_size(5) == 5
    assert not mesh.row_sharding(None, 6).reduces
    assert not mesh.batch_sharding(mesh.Mesh(0, 1)).reduces
    tree = {"images": np.zeros((4, 2)), "scalar": np.float64(3),
            "odd": np.zeros((3,)), "none": None}
    local = mesh.shard_batch(m, tree)
    assert local["images"].shape == (2, 2) and local["odd"].shape == (3,)
    assert local["scalar"] == 3 and local["none"] is None
    assert mesh.current() is mesh.LOCAL
    with sharded.active():
        assert mesh.current() is sharded
    assert mesh.current() is mesh.LOCAL
    x = torch.ones(3)
    assert collectives.reduce_sums(x)[0] is x
    assert collectives.reduce_max(x) is x


def test_mesh_refuses_what_is_not_ported():
    """No mesh wider than the process group (here one process), with or
    without a ``space`` axis; spatial sharding without a mesh is the local
    sharding."""
    with pytest.raises(ValueError):
        mesh.make_mesh(data=1, space=2)
    local = mesh.batch_sharding(None, spatial=True)
    assert local == mesh.batch_sharding(None)
    assert not local.reduces and not local.spatial
    with pytest.raises(ValueError):
        mesh.make_data_mesh(2)
    assert mesh.make_data_mesh() == mesh.Mesh(0, 1)
