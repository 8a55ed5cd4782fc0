"""Port parity for data-parallel training of the two CAE learners on a
frozen phase-1 CAE: step learning (``Enc3DStep``, the head regressing the
step, the whole CAE in training mode, its frozen trunk's BN moments
reduced too) and phase 2 (a new encoder behind the frozen CAE in
evaluation mode, the lead rank alone writing both ``.model`` files).  The
checks and limits are test_torch_cae_parallel.py's, on ranks of their own
(_torch_cae_parallel_worker.py)."""

import pytest

import test_torch_cae_parallel as common

CASES = ("step", "prediction")
REPLICATED = ("prediction",)
ONE_PROCESS = {"test": ("step:4",), 0: ("prediction:4",),
               1: ("prediction:3",)}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    return common.make_setup(tmp_path_factory, list(CASES), list(REPLICATED),
                             ONE_PROCESS)


@pytest.mark.parametrize("case", CASES)
def test_two_rank_step_matches_jax_mesh_step(setup, case):
    common.check_vs_jax(setup, case)


@pytest.mark.parametrize("case", CASES)
def test_two_rank_step_matches_one_process_step(setup, case):
    common.check_vs_one_process(setup, case)


@pytest.mark.parametrize("case", CASES)
def test_controls_fail_the_limits(setup, case):
    common.check_controls(setup, case)


@pytest.mark.parametrize("case", REPLICATED)
def test_replicated_chunk_equals_one_process_step(setup, case):
    common.check_replicated(setup, case)


def test_only_the_lead_writes_both_models(setup):
    """Phase 2's ``save_model`` (the frozen CAE and the encoder) and
    ``save_training`` on both ranks, each into a directory of its own: rank
    0 wrote all four files, rank 1 nothing."""
    outdir = setup[3]
    lead = {p.name for p in (outdir / "files0").iterdir()}
    assert {"prediction_cae2.model", "prediction_cae2_enc.model",
            "prediction_cae2.optim", "prediction_cae2.json"} <= lead, lead
    assert not list((outdir / "files1").iterdir())
