"""Port parity for the CTP CAE (the mask with the CBV and TTD images,
padded to H 72, each cut by its own block rule; the crop takes the masks'
blocks of the images' rows) and for ``LargeUnet3D`` with H sharded over the
ranks, at ``{data: 2, space: 2}``: the spawn, batch, widths and limits of
test_torch_spatial_cae.py.  The CTP learner's float64 ``train_step``
against the port's one-process step (1e-9) and JAX's float64 step; one
float64 ``LargeUnet3D`` step (``UnetSegmentationLearner.train_patches``,
channels 2 3 4 5 6 5 4 3 4 2, a (4, 92, 93, 92, 2) batch: the smallest
4-scale geometry with an H whose first blocks differ, the first pool
dropping a row) against the port's one-process step at 1e-9."""

import numpy as np
import pytest
import torch

import _torch_spatial_cae_worker as worker
from stroke_prediction_tpu_torch.models.unet3d import LargeUnet3D
from test_torch_spatial_cae import (
    ONE_PROCESS_REL, check_vs_jax, check_vs_one_process, make_setup)

CASES = ("step/ctp", "step/large")
ONE_PROCESS = {0: ("step/ctp",), 1: ("step/large",)}


def large_inputs():
    """Seeded ``LargeUnet3D`` weights and a batch for the ranks."""
    model = LargeUnet3D(worker.LARGE_CHANNELS,
                        generator=torch.Generator().manual_seed(4))
    rs = np.random.RandomState(8)
    out = {f"large/{k}": v.double().numpy()
           for k, v in model.state_dict().items()}
    out["large_x"] = rs.rand(*worker.LARGE_X) * 4
    out["large_y"] = (rs.rand(*worker.LARGE_Y) > 0.5).astype(np.float64)
    return out


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    return make_setup(tmp_path_factory, CASES, ONE_PROCESS, ("ctp",),
                      extra=large_inputs())


def test_spatial_ctp_step_matches_one_process_step(setup):
    check_vs_one_process(setup, "step", "ctp")


def test_spatial_ctp_step_matches_jax_step(setup):
    check_vs_jax(setup, "ctp")


def test_large_unet_spatial_step_matches_one_process(setup):
    """``LargeUnet3D``'s float64 step: the loss, all of its gradients and
    running statistics and the measures against one process at 1e-9; the
    ranks' gradients equal; fewer bytes moved than an all-gather's."""
    _, ranks, one = setup
    ref = one["step/large"]
    grads = [k for k in ref if k.startswith("grad/")]
    assert len(grads) == 2 * 2 * 7 * 2 + 4        # 14 layers' 4, the head's
    for rank, got in enumerate(ranks):
        step = {k[len("step/large/"):]: v for k, v in got.items()
                if k.startswith("step/large/")}
        for key, want in ref.items():
            if key.startswith("count/"):
                continue
            if not np.all(np.isfinite(want)):       # HD / ASSD off
                np.testing.assert_array_equal(step[key], want, err_msg=key)
                continue
            scale = max(np.abs(want).max(), 1e-300)
            err = np.abs(step[key] - want).max() / scale
            assert err <= ONE_PROCESS_REL, (rank, key, err)
        assert 0 < step["count/bytes"] < step["count/all_gather_bytes"]
        for key in grads:
            np.testing.assert_array_equal(step[key], ranks[0][
                "step/large/" + key], err_msg=key)
