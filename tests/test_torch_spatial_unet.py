"""Port parity for the U-Net with H sharded over the ranks, at
``{data: 2, space: 2}``: four gloo processes on the CPU
(_torch_spatial_worker.py, which imports no JAX) in one spawn, each on its
rows of the batch (``[d::2]``) and its block of H.

* The counterpart of tests/test_parallel.py's 2-D mesh forward: the eval
  forward of ``Unet3D(2 4 6 8 6 4 6 2)`` at (8, 44, 44, 44, 2) with the
  fixture's weights (``model.init`` at PRNGKey(0), through
  ``models/convert.py::unet_state_from_jax``): float32 against JAX's
  one-device float32 output at 1e-6, float64 against the port's
  one-process float64 output at 1e-12 (bit for bit on the CPU where it
  was written, but not asserted so: a rank's GEMMs have other shapes, the
  upsample's slice of rows and the head's, and a BLAS may sum them in
  another order).
* One float64 training step (``UnetSegmentationLearner.train_patches``,
  the fixture's model and loss, ``(Dice core + Dice penu) / 2``, BN in
  train mode) on a batch of H 45, so that the first layers' blocks differ
  in size (23 and 22 rows, then 22 and 21) and the first pool drops a row:
  the loss, every gradient and the running statistics against the port's
  one-process step at 1e-9 of their tensor's largest, and against JAX's
  one-device float64 step at test_torch_parallel.py's limits (loss and
  statistics 1e-12, gradients 1e-7 of the tensor's largest).  Two
  controls must fail the one-process limits by far: the exchanges'
  gradients never sent back to their owners, and BN's count taken as a
  rank's positions times the world.
* The conv gradient of test_torch_spatial.py at this mesh.
"""

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
from stroke_prediction_tpu_torch.models.convert import _unet_key_map
from stroke_prediction_tpu_torch.parallel import mesh

import _torch_spatial_worker as worker
from test_torch_parallel import (
    GRAD_REL, LOSS_TOL, STATS_TOL, _Float64Numpy, _leaf)
from test_torch_spatial import (
    check_conv, conv_inputs, jax_conv_grads, unet_variables)

torch.set_num_threads(1)

DATA, SPACE = 2, 2
JAX_FORWARD_TOL, FORWARD_TOL = 1e-6, 1e-12
ONE_PROCESS_REL = 1e-9
STEP_X = (8, 44, 45, 44, 2)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(inputs, JAX model, variables, each rank's results, the references:
    the port's one-process step and forward and JAX's float64 step and
    float32 forward, computed while the ranks run)."""
    model, variables, x, state = unet_variables()
    rs = np.random.RandomState(2)
    inputs = dict(conv_inputs(), unet_x=x.astype(np.float64), **state,
                  step_x=rs.rand(*STEP_X) * 4,
                  step_y=(rs.rand(8, 4, 4, 4, 2) > 0.5).astype(np.float64))
    outdir = tmp_path_factory.mktemp("spatial_unet")
    procs = worker.start(DATA, SPACE, inputs, outdir)
    try:
        refs = {"ref32": np.asarray(model.apply(
                    variables, jnp.asarray(inputs["unet_x"], jnp.float32),
                    train=False)),
                "one64": worker.forward(inputs, None, torch.float64),
                "one_process": worker.step(inputs, None),
                "jax_step": _jax_step(inputs, variables),
                "conv": jax_conv_grads(inputs)}
    finally:
        ranks = worker.join(procs, outdir)
    return inputs, model, variables, ranks, refs


def _rank_block(got, r, one):
    """Rank ``r``'s rows and block of H of the one-process ``one``."""
    m = mesh.Mesh(r, DATA * SPACE, SPACE)
    lo, hi = mesh.block(one.shape[2], m.space_index, SPACE)
    return one[m.data_index::DATA, :, lo:hi]


def _errors(got, prefix, loss, grads, stats, relative=True):
    """Worst (loss, gradient relative to its tensor's largest, statistics)
    of ``prefix``'s step; the loss and statistics relative to their largest
    with ``relative``, else absolute (test_torch_parallel.py's limits)."""
    scale = (lambda a: max(np.abs(a).max(), 1e-300)) if relative else (
        lambda a: 1.0)
    errs = [abs(float(got[prefix + "metric/loss"]) - loss) / scale(loss),
            0.0, 0.0]
    for path, key in _unet_key_map():
        if path[0] == "params":
            ref = grads(path, key)
            errs[1] = max(errs[1], np.abs(got[f"{prefix}grad/{key}"]
                                          - ref).max() / np.abs(ref).max())
        else:
            ref = stats(path, key)
            errs[2] = max(errs[2], np.abs(got[f"{prefix}stat/{key}"]
                                          - ref).max() / scale(ref))
    return errs


@pytest.fixture(scope="module")
def one_process(setup):
    """The port's one-process float64 step on the whole batch."""
    return setup[4]["one_process"]


@pytest.fixture(scope="module")
def jax_step(setup):
    """JAX's one-device float64 step: (loss, grads, new batch_stats)."""
    return setup[4]["jax_step"]


def _jax_step(inputs, variables):
    """JAX's one-device float64 step: (loss, grads, new batch_stats)."""
    model = JaxUnet3D(channels=worker.CHANNELS, compute_dtype=jnp.float64)

    def loss(seg, labels):
        return (jax_batch_dice_loss(seg[..., 0:1], labels[..., 0:1])
                + jax_batch_dice_loss(seg[..., 1:2], labels[..., 1:2])) / 2

    @jax.jit
    def step(params, batch_stats, images, labels):
        def loss_fn(p):
            seg, mut = model.apply({"params": p, "batch_stats": batch_stats},
                                   images, train=True,
                                   mutable=["batch_stats"])
            return loss(seg, labels), mut
        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    with pytest.MonkeyPatch.context() as mp:
        for mod in (jax_layers, jax_unet3d, jax_metrics):
            mp.setattr(mod, "jnp", _Float64Numpy())
        jax.config.update("jax_enable_x64", True)
        try:
            cast = lambda t: jax.tree_util.tree_map(  # noqa: E731
                lambda a: jnp.asarray(a, jnp.float64), t)
            (value, mut), grads = step(
                cast(variables["params"]), cast(variables["batch_stats"]),
                jnp.asarray(inputs["step_x"]), jnp.asarray(inputs["step_y"]))
            return (float(value), jax.tree_util.tree_map(np.asarray, grads),
                    jax.tree_util.tree_map(np.asarray, mut["batch_stats"]))
        finally:
            jax.config.update("jax_enable_x64", False)


def test_forward_matches_jax_and_one_process(setup):
    """The 2-D mesh forward of tests/test_parallel.py: each rank's (4, 4, 2,
    4, 2) block of the (8, 4, 4, 4, 2) output, float32 against JAX's
    one-device output, float64 against the port's one-process forward."""
    ranks, refs = setup[3], setup[4]
    ref32, one64 = refs["ref32"], refs["one64"]
    assert ref32.shape == one64.shape == (8, 4, 4, 4, 2)
    for r, got in enumerate(ranks):
        assert got["forward32"].shape == (4, 4, 2, 4, 2)
        np.testing.assert_allclose(got["forward32"],
                                   _rank_block(got, r, ref32), rtol=0,
                                   atol=JAX_FORWARD_TOL, err_msg=str(r))
        np.testing.assert_allclose(got["forward64"],
                                   _rank_block(got, r, one64), rtol=0,
                                   atol=FORWARD_TOL, err_msg=str(r))


def test_step_matches_one_process_step(setup, one_process):
    """The float64 step on each rank against the port's one-process step:
    loss, all 44 gradients, the running statistics and the counted
    measures; the ranks fetched rows and moved fewer bytes than an
    all-gather of the same tensors."""
    ranks = setup[3]
    for r, got in enumerate(ranks):
        errs = _errors(got, "step/", float(one_process["metric/loss"]),
                       lambda p, k: one_process[f"grad/{k}"],
                       lambda p, k: one_process[f"stat/{k}"])
        assert max(errs) <= ONE_PROCESS_REL, (r, errs)
        assert sum(k.startswith("step/grad/") for k in got) == 44
        for key in one_process:
            if key.startswith("metric/"):
                np.testing.assert_allclose(got["step/" + key],
                                           one_process[key], rtol=1e-12,
                                           err_msg=key)
        assert got["step/count/exchanges"] > 0, r
        assert 0 < got["step/count/bytes"] < got["step/count/all_gather_bytes"]


def test_step_matches_jax_step(setup, jax_step):
    """The same step on each rank against JAX's one-device float64 step."""
    loss, grads, stats = jax_step
    for r, got in enumerate(setup[3]):
        errs = _errors(got, "step/", loss,
                       lambda p, k: _leaf(grads, p[1:]),
                       lambda p, k: _leaf(stats, p[1:]), relative=False)
        assert errs[0] <= LOSS_TOL and errs[1] <= GRAD_REL \
            and errs[2] <= STATS_TOL, (r, errs)


@pytest.mark.parametrize("control", ["no_adjoint", "bn_count"])
def test_controls_fail_the_limits(setup, one_process, control):
    """Without the exchanges' adjoint the gradients are off; with BN's
    count a rank's times the world (the blocks of H 45 and 43 are unequal)
    the loss, the gradients and the statistics are off: each by more than
    1e3 times the one-process limit."""
    for r, got in enumerate(setup[3]):
        errs = _errors(got, control + "/", float(one_process["metric/loss"]),
                       lambda p, k: one_process[f"grad/{k}"],
                       lambda p, k: one_process[f"stat/{k}"])
        assert errs[1] > 1e3 * ONE_PROCESS_REL, (r, errs)
        if control == "bn_count":
            assert min(errs[0], errs[2]) > 1e3 * ONE_PROCESS_REL, (r, errs)


def test_conv_gradient_at_data2_space2_matches_jax(setup):
    """The conv gradient of test_torch_spatial.py at {data: 2, space: 2}:
    each rank's two rows and 7 of H 14."""
    inputs, _, _, ranks, refs = setup
    check_conv(ranks, DATA, SPACE, inputs, refs["conv"])
