"""Port parity for the CAE learners with H sharded over the ranks, at
``{data: 2, space: 2}``: four gloo processes on the CPU
(_torch_spatial_cae_worker.py, which imports no JAX) in one spawn, each on
its row of a global batch of 2 (``[d::2]``) and its block of H, at the
widths and on the first two rows of the batch of test_torch_cae_parallel.py
(28x64x64 masks, the
smallest volume the CAE takes: the encoder's H 13, 11 and 9 split
unequally over two ranks; the CTP CBV and TTD padded to H 72, cut by their
own block rule and cropped to the masks' blocks).

This file holds phase 1 (the latent L1 term on);
test_torch_spatial_cae_frozen.py the two learners on a frozen phase-1 CAE
(step learning, phase 2), test_torch_spatial_cae_ctp.py the CTP CAE and
``LargeUnet3D`` (three files, so that test workers share the JAX steps'
compiles).  Each rank's float64
``train_step`` against the port's one-process step on the whole batch (the
loss, every trained gradient and the running statistics at 1e-9, the
limit of test_torch_spatial_unet.py, and the measures), and against the JAX package's float64 step at
test_torch_cae_parallel.py's limits (those of test_torch_parallel.py);
phase 1 also with its augmentation on (every rank draws the noise of the
global volume and warps its block), and its ``eval_step`` (HD bit for bit,
the EDT being exact, on the masks' whole H; ASSD, a float32 sum of
distances that the ranks add in another order, at 1e-6).  Two controls must miss the
one-process limit by more than 1e3 times: the padded convs padding each
rank's block (zero rows inside the volume), and the elastic noise drawn
over a rank's block of H alone (the loss of a training-mode forward).
"""

import numpy as np
import pytest

import _torch_spatial_cae_worker as worker
import _torch_spatial_worker as spawner
from test_torch_cae_parallel import (
    CONFIGS, GRAD_REL, LOSS_TOL, MEASURES_TOL, STATS_TOL, _errors, _section,
    _vs_jax, global_batch, jax_mesh_steps, n_trained, worker_inputs)

DATA, SPACE = 2, 2
BATCH = 2                      # one row a data index
ONE_PROCESS_REL = 1e-9
ASSD_REL = 1e-6
CONTROL_FACTOR = 1e3
SPAWN_TIMEOUT = 400            # seconds, for all ranks together
# the ranks' sections of this file, and who computes each one-process
# reference: a rank, after its own sections
CASES = ("step/phase1_factor", "aug/phase1_factor", "pad/phase1_factor",
         "draws/phase1_factor", "eval/phase1_factor")
ONE_PROCESS = {0: ("step/phase1_factor",), 1: ("aug/phase1_factor",),
               2: ("eval/phase1_factor",)}
KINDS = ("phase1", "ctp", "step", "prediction")


def make_setup(tmp_path_factory, cases, one_process, jax_cases, extra=None):
    """Spawn the ranks on ``cases``, compute JAX's float64 steps of
    ``jax_cases`` while they run -> (JAX steps, each rank's results, {
    section/case: the one-process results})."""
    arrays = {k: v[:BATCH] for k, v in global_batch().items()}
    # the weights' seeds follow the kinds' order: phase 1 first, so that
    # its random CAE's eval-mode reconstructions hold voxels (finite HD)
    kinds = [k for k in KINDS
             if k in {worker.cae.CASES[c][0] for c in jax_cases}]
    variables, states = worker_inputs(kinds, arrays)
    inputs = dict(arrays, **states, **(extra or {}), cases=np.array(cases),
                  **{f"one/{r}": np.array(one_process.get(r, ()), dtype=str)
                     for r in range(DATA * SPACE)})
    outdir = str(tmp_path_factory.mktemp("spatial_cae"))
    procs = spawner.start(DATA, SPACE, inputs, outdir, script=worker.__file__)
    try:
        witness = jax_mesh_steps(list(jax_cases), variables, arrays)
    finally:
        ranks = spawner.join(procs, outdir, SPAWN_TIMEOUT)
    one = {}
    for got in ranks:
        for entry in one_process.get(int(got["rank"]), ()):
            one[entry] = _section(got, f"one/{entry}")
    return witness, ranks, one


def one_process_errors(got, ref, case):
    """(loss, worst gradient / max|ref|, worst statistic) of a rank's
    section against a one-process section."""
    config = CONFIGS[worker.cae.CASES[case][0]]
    return _errors(got, float(ref["metric/loss"]),
                   lambda p, k: ref[f"grad/{k}"],
                   lambda p, k: ref[f"stat/{k}"], config)


def check_vs_one_process(setup, section, case):
    """Each rank's section against the one-process one: loss, gradients
    and statistics at ONE_PROCESS_REL, the measures of the global batch
    (relative); the ranks' losses and gradients equal bit for bit; the rows
    moved fewer bytes than an all-gather of the same tensors."""
    _, ranks, one = setup
    ref = one[f"{section}/{case}"]
    steps = [_section(got, f"{section}/{case}") for got in ranks]
    for rank, got in enumerate(steps):
        errs = one_process_errors(got, ref, case)
        assert max(errs) <= ONE_PROCESS_REL, (rank, errs)
        for key, want in ref.items():
            if key.startswith("metric/"):
                np.testing.assert_allclose(got[key], want, rtol=1e-12,
                                           atol=0, err_msg=key)
        assert 0 < got["count/bytes"] < got["count/all_gather_bytes"], rank
    for got in steps[1:]:
        for key in got:
            if key.startswith(("metric/loss", "grad/")):
                np.testing.assert_array_equal(got[key], steps[0][key],
                                              err_msg=key)


def check_vs_jax(setup, case):
    """Each rank's step against JAX's float64 step of the global batch."""
    witness, ranks, _ = setup
    metrics = witness[case][3]
    for rank, got in enumerate(ranks):
        step = _section(got, f"step/{case}")
        errs = _vs_jax(step, witness, case)
        assert errs[0] <= LOSS_TOL and errs[1] <= GRAD_REL \
            and errs[2] <= STATS_TOL, (rank, errs)
        assert sum(k.startswith("grad/") for k in step) == n_trained(case)
        for key, want in metrics.items():
            value = float(step[f"metric/{key}"])
            assert abs(value - want) <= (LOSS_TOL if key == "loss"
                                         else MEASURES_TOL), (rank, key)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    return make_setup(tmp_path_factory, CASES, ONE_PROCESS,
                      ("phase1_factor",))


def test_spatial_step_matches_one_process_step(setup):
    check_vs_one_process(setup, "step", "phase1_factor")


def test_spatial_step_matches_jax_step(setup):
    check_vs_jax(setup, "phase1_factor")


def test_spatial_augmented_step_matches_one_process(setup):
    """Phase 1 with its flip and elastic deformation on: the noise of the
    global volume, each rank's block of the blurred fields, the warp's rows
    from their owners."""
    check_vs_one_process(setup, "aug", "phase1_factor")


def test_spatial_eval_step_matches_one_process(setup):
    """``eval_step``'s loss and measures, HD and ASSD among them (the
    thresholded masks' whole H gathered on each rank), HD bit for bit."""
    _, ranks, one = setup
    ref = one["eval/phase1_factor"]
    for rank, got in enumerate(ranks):
        ev = _section(got, "eval/phase1_factor")
        for key, want in ref.items():
            if not key.startswith("metric/"):
                continue
            if key.endswith("_hd"):
                assert np.isfinite(want), key
                np.testing.assert_array_equal(ev[key], want, err_msg=key)
            else:
                # ASSD: a float32 sum of distances that the ranks add in
                # another order (chip_smoke.py's DP_ASSD_REL)
                np.testing.assert_allclose(
                    ev[key], want, rtol=ASSD_REL if key.endswith("_assd")
                    else 1e-12, atol=0, err_msg=key)
        assert ev["count/exchanges"] > 0, rank


@pytest.mark.parametrize("control, reference", [("pad", "step"),
                                                ("draws", "aug")])
def test_controls_fail_the_limits(setup, control, reference):
    """Padded convs that pad each rank's block, and elastic noise over a
    rank's block of H: the loss of the training-mode forward misses the
    one-process step's by more than 1e3 times the limit."""
    _, ranks, one = setup
    want = float(one[f"{reference}/phase1_factor"]["metric/loss"])
    for rank, got in enumerate(ranks):
        loss = float(got[f"{control}/phase1_factor/metric/loss"])
        assert abs(loss - want) > CONTROL_FACTOR * ONE_PROCESS_REL, (
            rank, loss, want)
