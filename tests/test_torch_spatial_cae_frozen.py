"""Port parity for the two CAE learners on a frozen phase-1 CAE (step
learning; phase 2, whose frozen CAE runs H-sharded in evaluation mode)
with H sharded over the ranks, at ``{data: 2, space: 2}``: the spawn,
batch, widths and limits of test_torch_spatial_cae.py.  Each learner's
float64 ``train_step`` against the port's one-process step (1e-9) and
JAX's float64 step."""

import pytest

from test_torch_spatial_cae import (
    check_vs_jax, check_vs_one_process, make_setup)

CASES = ("step/step", "step/prediction")
ONE_PROCESS = {0: ("step/prediction",), 1: ("step/step",)}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    return make_setup(tmp_path_factory, CASES, ONE_PROCESS,
                      ("step", "prediction"))


@pytest.mark.parametrize("case", ["step", "prediction"])
def test_spatial_step_matches_one_process_step(setup, case):
    check_vs_one_process(setup, "step", case)


@pytest.mark.parametrize("case", ["step", "prediction"])
def test_spatial_step_matches_jax_step(setup, case):
    check_vs_jax(setup, case)
