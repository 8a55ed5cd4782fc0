"""Port parity for data-parallel training of the CAE learners (global hinge
and latent means, ``parallel.collectives.global_mean``; the augmentation
drawn for the global batch; the gradients averaged after backward): two
gloo processes on the CPU (_torch_cae_parallel_worker.py, which imports no
JAX), each one float64 step on 2 rows of a global batch of 4, against the
JAX package's learner loss under ``value_and_grad`` with the batch sharded
over a 2-device data mesh and against the port's one-process step.

This file holds phase 1 (``Enc3D`` at factor 0 and 0.4) and the CTP CAE
(C_in 3, factor 0.4), the augmentation draws and the lead-only writes;
test_torch_cae_parallel_frozen.py the two learners on a frozen phase-1 CAE
(step learning, phase 2), with the same checks.  The two files run their
own ranks, so that two test workers share the work.

Limits, those of test_torch_cae_train_step.py's float64 step: the loss and
the running statistics 1e-12 (of the statistic where it exceeds 1), every
gradient 1e-7 of its tensor's max|ref|;
the measures 1e-6 against JAX, 1e-12 relative against the one-process
step; the two ranks equal bit for bit.  Three controls must fail them: BN's
moments per rank, the hinges' means per rank (the ranks' losses then
differ) and the gradients without the all-reduce.  A 3-row batch does not
divide over two ranks: each rank runs it whole, equal bit for bit to one
process.  Each rank's augmented rows equal, bit for bit, its rows of one
process's draws from the same seed, and its generator's next numbers equal
one process's.  Stochastic parts are held port to port only: ``jax.random``
and torch generators differ."""

import concurrent.futures
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stroke_prediction_tpu import inference as jax_inference
from stroke_prediction_tpu.core.dto import BRANCH_GTRUTH as JAX_GTRUTH
from stroke_prediction_tpu.core.dto import BRANCH_INPUTS as JAX_INPUTS
from stroke_prediction_tpu.eval import metrics as jax_metrics
from stroke_prediction_tpu.models import cae3d as jax_cae3d
from stroke_prediction_tpu.models import layers as jax_layers
from stroke_prediction_tpu.parallel import mesh as jax_mesh
from stroke_prediction_tpu.train import cae_learners as jax_cae_learners
from stroke_prediction_tpu_torch.cli.common import free_port
from stroke_prediction_tpu_torch.data import augment
from stroke_prediction_tpu_torch.models.convert import _key_map, state_from_jax

import _torch_cae_parallel_worker as worker
from test_torch_train import TRAIN_STEP_TOL, _Float64Numpy, _leaf
from test_torch_unet import _random_variables

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
WORLD = 2
SPAWN_TIMEOUT = 400          # seconds, for both ranks together
LOSS_TOL, GRAD_REL, STATS_TOL = TRAIN_STEP_TOL["float64"]
MEASURES_TOL = 1e-6
MEASURES = ("dc", "precision", "sensitivity", "specificity")
CONTROL_FACTOR = 1e3         # a control must miss a limit by this factor
CHANNELS, CTP_CHANNELS = worker.CHANNELS, worker.CTP_CHANNELS
PAD, SPATIAL, HEAD = worker.PAD, worker.SPATIAL, worker.HEAD
CONFIGS = {
    "phase1": {"kind": "cae3d", "channels": list(CHANNELS),
               "n_ch_global": 5, "step": False},
    "step": {"kind": "cae3d", "channels": list(CHANNELS), "n_ch_global": 5,
             "step": True},
    "ctp": {"kind": "cae3d_ctp", "channels": list(CTP_CHANNELS),
            "n_ch_global": 5, "step": False, "padding": list(PAD)},
    "prediction": {"kind": "enc3d", "channels": list(CHANNELS),
                   "n_ch_global": 5}}


# ------------------------------------------------------------- the inputs

def global_batch():
    """The global batch of 4: soft core, penumbra and lesion masks, a
    clinical vector per sample, the CTP learner's padded CBV and TTD (made
    from the masks as the synthetic cases make them) and phase 2's U-Net
    core and penumbra probabilities."""
    rs = np.random.RandomState(5)
    labels = np.clip(rs.rand(4, *SPATIAL, 3) * 1.6 - 0.3, 0.0, 1.0)
    clinical = np.array([[2.5, 3.0, 0.2, 0.4, 0.6], [1.0, 5.5, 0.7, 0.1, 0.3],
                         [4.0, 1.5, 0.5, 0.9, 0.2], [0.5, 8.0, 0.3, 0.6, 0.8]])
    core, penu, lesion = (labels[..., i] for i in range(3))
    noise = rs.randn(4, *SPATIAL)
    cbv = 4.0 + 2.0 * noise - 3.0 * core + penu
    ttd = 5.0 + 3.0 * np.abs(noise) + 20.0 * penu + 5.0 * lesion
    pad = ((0, 0),) + tuple((p, p) for p in PAD) + ((0, 0),)
    ctp_images = np.pad(np.stack([cbv, ttd], -1), pad)
    pred_images = np.clip(rs.rand(4, *SPATIAL, 2) * 1.4 - 0.2, 0.0, 1.0)
    arrays = dict(labels=labels, clinical=clinical, ctp_images=ctp_images,
                  pred_images=pred_images)
    return {k: v.astype(np.float32).astype(np.float64)
            for k, v in arrays.items()}


def _jax_cae(kind, dtype=jnp.float32):
    if kind == "ctp":
        return jax_cae3d.Cae3DCtp(
            enc=jax_cae3d.Enc3DCtp(channels=CTP_CHANNELS, n_ch_global=5,
                                   padding=PAD, compute_dtype=dtype),
            dec=jax_cae3d.Dec3D(channels=CTP_CHANNELS, n_ch_global=5,
                                compute_dtype=dtype))
    enc = jax_cae3d.Enc3DStep if kind == "step" else jax_cae3d.Enc3D
    return jax_cae3d.Cae3D(
        enc=enc(channels=CHANNELS, n_ch_global=5, compute_dtype=dtype),
        dec=jax_cae3d.Dec3D(channels=CHANNELS, n_ch_global=5,
                            compute_dtype=dtype))


def _jax_enc(dtype=jnp.float32):
    return jax_cae3d.Enc3D(channels=CHANNELS, n_ch_global=5,
                           compute_dtype=dtype)


def _dto(kind, arrays, cast=jnp.asarray):
    images = {"ctp": "ctp_images", "prediction": "pred_images"}.get(kind)
    return jax_inference.cae_dto_from_batch(
        None if images is None else cast(arrays[images]),
        cast(arrays["labels"]), cast(arrays["clinical"]),
        learn_step=kind == "step", inputs_from_images=images is not None)


def learner_variables(kind, arrays, seed):
    """Random variables of ``kind``'s trained model (phase 2: (the frozen
    CAE's, the encoder's)); the CTP entry BN's running statistics are the
    moments of the masks and images it sees, as test_torch_cae_ctp.py sets
    them."""
    dto = _dto(kind, {k: v.astype(np.float32) for k, v in arrays.items()})
    rs = np.random.RandomState(seed)
    if kind == "prediction":
        cae = learner_variables("phase1", arrays, seed + 1)
        shapes = jax.eval_shape(lambda: _jax_enc().init(
            jax.random.PRNGKey(0), dto, JAX_INPUTS, False))
        return cae, _random_variables(shapes, rs)
    shapes = jax.eval_shape(lambda: _jax_cae(kind).init(
        jax.random.PRNGKey(0), dto, JAX_GTRUTH, False))
    v = _random_variables(shapes, rs)
    if kind == "ctp":
        crop = arrays["ctp_images"][:, PAD[0]:-PAD[0], PAD[1]:-PAD[1],
                                    PAD[2]:-PAD[2]]
        x = np.concatenate([arrays["labels"][..., 1:2], crop], -1)
        entry = v["batch_stats"]["enc"]["encoder"]["BnConvActBlock_0"][
            "BatchNorm_0"]["BatchNorm_0"]
        entry["mean"] = x.mean((0, 1, 2, 3)).astype(np.float32)
        entry["var"] = x.var((0, 1, 2, 3)).astype(np.float32)
    return v


def worker_inputs(kinds, arrays):
    """{model name: variables} and the worker's state dicts (float64)."""
    variables, states = {}, {}
    for i, kind in enumerate(kinds):
        v = learner_variables(kind, arrays, 10 * i)
        variables[kind] = v
        if kind == "prediction":
            states["cae"] = state_from_jax(v[0], CONFIGS["phase1"])
            states["enc"] = state_from_jax(v[1], CONFIGS["prediction"])
        else:
            states[kind] = state_from_jax(v, CONFIGS[kind])
    flat = {f"state/{name}/{k}": t.double().numpy()
            for name, state in states.items() for k, t in state.items()}
    return variables, flat


# ------------------------------------------------------------- the ranks

def spawn(outdir, inputs):
    """Start the two ranks on ``inputs`` (written to ``outdir``)."""
    path = outdir / "inputs.npz"
    np.savez(path, **inputs)
    coordinator = f"127.0.0.1:{free_port()}"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               TMPDIR=str(outdir))
    return [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests",
                                      "_torch_cae_parallel_worker.py"),
         coordinator, str(WORLD), str(rank), str(path), str(outdir)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for rank in range(WORLD)]


def join(procs, outdir):
    """Both ranks' results, each rank within SPAWN_TIMEOUT."""
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
        assert f"CAE_PARALLEL_WORKER_OK rank={rank}" in out, out
    return [dict(np.load(outdir / f"rank{r}.npz")) for r in range(WORLD)]


# --------------------------------------------------------------- JAX's step

def _jax_fn(kind):
    """(fn(params, batch_stats, labels, clinical, images, factor) -> (loss,
    (new batch_stats, measured pairs)), grads) of ``kind``'s learner loss at
    train=True, grads over the trained model's parameters."""
    loss_self = types.SimpleNamespace(_label_weights=(1.0,))
    learner = {"phase1": jax_cae_learners.CaeReconstructionLearner,
               "ctp": jax_cae_learners.CaeReconstructionLearner,
               "step": jax_cae_learners.CaeStepLearner,
               "prediction": jax_cae_learners.CaePredictionLearner}[kind]
    model = _jax_enc(jnp.float64) if kind == "prediction" else _jax_cae(
        kind, jnp.float64)
    cae = _jax_cae("phase1", jnp.float64)

    def fn(params, batch_stats, cae_vars, arrays, factor):
        def loss_fn(p):
            dto = _dto(kind, arrays, cast=lambda a: a)
            variables = {"params": p, "batch_stats": batch_stats}
            if kind == "prediction":
                out, mut = jax_inference.cae_enc_inference(
                    cae, cae_vars, model, variables, dto, train=True,
                    enc_mutable=["batch_stats"])
            else:
                out, mut = model.apply(variables, dto, JAX_GTRUTH, True,
                                       mutable=["batch_stats"])
            rec, gt = out.reconstructions.gtruth, out.given_variables.gtruth
            pairs = {"lesion": (rec.interpolation, gt.lesion),
                     "core": (rec.core, gt.core), "penu": (rec.penu, gt.penu)}
            return learner._loss(loss_self, out, factor), (
                mut["batch_stats"], pairs)
        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    return fn


def jax_mesh_steps(cases, variables, arrays):
    """{case: (loss, grads, new batch_stats, {metric key: value})} of JAX's
    float64 step with the global batch sharded over a 2-device data mesh,
    its parameters replicated.  The programs are traced one after another
    and compiled side by side."""
    kinds = sorted({worker.CASES[c][0] for c in cases})
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jax_layers, jax_cae3d, jax_metrics, jax_inference,
                    jax_cae_learners):
            mp.setattr(mod, "jnp", _Float64Numpy())
        jax.config.update("jax_enable_x64", True)
        try:
            data_mesh = jax_mesh.make_data_mesh(WORLD)
            rows = jax_mesh.batch_sharding(data_mesh)
            rep = jax_mesh.replicate(data_mesh)

            def put(tree, sharding):
                return jax.tree_util.tree_map(
                    lambda a: jax.device_put(jnp.asarray(a, jnp.float64),
                                             sharding), tree)

            batch = put(arrays, rows)
            args = {}
            for kind in kinds:
                v = variables[kind]
                cae_vars, v = (v if kind == "prediction" else (None, v))
                args[kind] = (put(v["params"], rep),
                              put(v["batch_stats"], rep),
                              put(cae_vars, rep), batch)
            lowered = {kind: jax.jit(_jax_fn(kind)).lower(
                *args[kind], jnp.asarray(0.0, jnp.float64)) for kind in kinds}
            with concurrent.futures.ThreadPoolExecutor(len(kinds)) as ex:
                compiled = dict(zip(kinds, ex.map(lambda lo: lo.compile(),
                                                  lowered.values())))
            for case in cases:
                kind, factor = worker.CASES[case]
                (loss, (stats, pairs)), grads = compiled[kind](
                    *args[kind], jnp.asarray(factor, jnp.float64))
                out[case] = (float(loss),
                             jax.tree_util.tree_map(np.asarray, grads),
                             jax.tree_util.tree_map(np.asarray, stats),
                             jax.tree_util.tree_map(np.asarray, pairs))
        finally:
            jax.config.update("jax_enable_x64", False)
    for case, (loss, grads, stats, pairs) in out.items():
        metrics = {"loss": loss}
        for name, (got, want) in pairs.items():
            m = jax_metrics.binary_measures(
                jnp.asarray(got, jnp.float32), jnp.asarray(want, jnp.float32),
                with_distances=False)
            metrics.update({f"{name}_{f}": float(getattr(m, f))
                            for f in MEASURES})
        out[case] = (loss, grads, stats, metrics)
    return out


# ------------------------------------------------------------ the checks

def make_setup(tmp_path_factory, cases, replicated, one_process):
    """Spawn the ranks on ``cases`` (``replicated``: those that also run the
    3-row step), compute JAX's mesh steps while they run, then the
    one-process steps of ``one_process["test"]`` (``"<case>:<rows>"``)
    while the ranks compute theirs (``one_process[rank]``) -> (arrays,
    {case: JAX step}, [rank 0, rank 1], outdir, {one-process sections})."""
    arrays = global_batch()
    kinds = sorted({worker.CASES[c][0] for c in cases})
    variables, states = worker_inputs(kinds, arrays)
    outdir = tmp_path_factory.mktemp("cae_parallel")
    inputs = dict(arrays, **states, cases=np.array(cases),
                  replicated=np.array(replicated, dtype=str),
                  **{f"one/{r}": np.array(one_process[r], dtype=str)
                     for r in range(WORLD)})
    procs = spawn(outdir, inputs)
    one = {}
    try:
        witness = jax_mesh_steps(cases, variables, arrays)
        loaded = np.load(outdir / "inputs.npz")
        for entry in one_process["test"]:
            one.update(worker.one_process(entry, loaded))
    finally:
        ranks = join(procs, outdir)
    for got in ranks:
        one.update({k: v for k, v in got.items()
                    if k.startswith(("one/", "one3/"))})
    return arrays, witness, ranks, outdir, one


def _section(got, prefix):
    """The ``prefix/`` entries of a rank's results, the prefix removed."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in got.items() if k.startswith(prefix + "/")}


def _one_process(setup, case, key="one"):
    section = _section(setup[4], f"{key}/{case}")
    assert section, f"no one-process {key}/{case}"
    return section


def _errors(got, loss, grads, stats, config):
    """(loss, worst gradient / max|ref|, worst statistic / max(1, |ref|))
    of one rank's step section against the reference's, in the port's key
    space; the reference gradients ``grads(path, key)`` of the parameters
    the rank has gradients of.  A statistic's error is relative above 1:
    the CTP entry BN's moments of the CT intensities reach ~1e2, and their
    float64 sums, added over the ranks in another order, ~1e-13 of that."""
    errs = [abs(float(got["metric/loss"]) - loss), 0.0, 0.0]
    n_grads = 0
    for path, key in _key_map(config):
        if path[0] == "params":
            if f"grad/{key}" not in got:
                continue
            n_grads += 1
            ref = grads(path, key)
            errs[1] = max(errs[1], np.abs(got[f"grad/{key}"] - ref).max()
                          / np.abs(ref).max())
        else:
            ref = stats(path, key)
            errs[2] = max(errs[2], (np.abs(got[f"stat/{key}"] - ref)
                                    / np.maximum(1.0, np.abs(ref))).max())
    assert n_grads == sum(k.startswith("grad/") for k in got) > 0
    return errs


def _vs_jax(got, witness, case):
    loss, grads, stats, _ = witness[case]
    return _errors(got, loss, lambda p, k: _leaf(grads, p[1:]),
                   lambda p, k: _leaf(stats, p[1:]),
                   CONFIGS[worker.CASES[case][0]])


def n_trained(case):
    """The trained parameters: every one of the model, the step head's six
    (the rest frozen) or phase 2's encoder's."""
    kind = worker.CASES[case][0]
    keys = [k for path, k in _key_map(CONFIGS[kind]) if path[0] == "params"]
    if kind == "step":
        keys = [k for k in keys if k.split(".")[1] in HEAD]
    return len(keys)


def check_vs_jax(setup, case):
    """Each rank's step: the loss, every trained gradient, the running
    statistics and the measures of the global batch, against JAX's step
    on the 2-device data mesh."""
    witness, ranks = setup[1:3]
    metrics = witness[case][3]
    for rank, got in enumerate(ranks):
        step = _section(got, f"step/{case}")
        errs = _vs_jax(step, witness, case)
        assert errs[0] <= LOSS_TOL, (rank, errs)
        assert errs[1] <= GRAD_REL, (rank, errs)
        assert errs[2] <= STATS_TOL, (rank, errs)
        assert sum(k.startswith("grad/") for k in step) == n_trained(case)
        for key, want in metrics.items():
            value = float(step[f"metric/{key}"])
            assert abs(value - want) <= (LOSS_TOL if key == "loss"
                                         else MEASURES_TOL), (rank, key)


def check_vs_one_process(setup, case):
    """Each rank's step against the port's one-process step on the whole
    batch; the two ranks equal bit for bit."""
    ranks = setup[2]
    one = _one_process(setup, case)
    config = CONFIGS[worker.CASES[case][0]]
    for rank, got in enumerate(ranks):
        step = _section(got, f"step/{case}")
        errs = _errors(step, float(one["metric/loss"]),
                       lambda p, k: one[f"grad/{k}"],
                       lambda p, k: one[f"stat/{k}"], config)
        assert errs[0] <= LOSS_TOL and errs[1] <= GRAD_REL \
            and errs[2] <= STATS_TOL, (rank, errs)
        for key, want in one.items():
            if key.startswith("metric/"):
                np.testing.assert_allclose(step[key], want, rtol=1e-12,
                                           atol=0, err_msg=key)
    a, b = (_section(got, f"step/{case}") for got in ranks)
    assert a.keys() == b.keys()
    for key in a:
        if not key.startswith("pregrad/"):        # each rank's own paths
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def check_controls(setup, case):
    """The three controls miss JAX's mesh step by far more than the limits:
    BN's moments per rank (the loss and the gradients), the hinges' means
    per rank (the ranks' losses differ) and the gradients left without the
    all-reduce."""
    witness, ranks = setup[1:3]
    loss = witness[case][0]
    hinge = [float(got[f"hinge/{case}"]) for got in ranks]
    assert hinge[0] != hinge[1], hinge
    for rank, got in enumerate(ranks):
        errs = _vs_jax(_section(got, f"bn/{case}"), witness, case)
        assert errs[0] > CONTROL_FACTOR * LOSS_TOL, (rank, errs)
        assert errs[1] > CONTROL_FACTOR * GRAD_REL, (rank, errs)
        assert abs(hinge[rank] - loss) > CONTROL_FACTOR * LOSS_TOL
        step = _section(got, f"step/{case}")
        unreduced = {k: v for k, v in step.items() if not k.startswith(
            ("grad/", "pregrad/"))}
        unreduced.update({"grad/" + k[len("pregrad/"):]: v
                          for k, v in step.items()
                          if k.startswith("pregrad/")})
        errs = _vs_jax(unreduced, witness, case)
        assert errs[1] > CONTROL_FACTOR * GRAD_REL, (rank, errs)


def check_replicated(setup, case):
    """Each rank's 3-row step equals the one-process 3-row step bit for
    bit."""
    ranks = setup[2]
    one = _one_process(setup, case, "one3")
    for got in ranks:
        rep = _section(got, f"replicated/{case}")
        assert rep.keys() == one.keys()
        for key, want in one.items():
            np.testing.assert_array_equal(rep[key], want, err_msg=key)


# ---------------------------------------------------------------- phase 1

CASES = ("phase1", "phase1_factor", "ctp")
REPLICATED = ("phase1_factor",)
# who computes each one-process reference: this process or a rank
ONE_PROCESS = {"test": ("phase1:4", "ctp:4"), 0: ("phase1_factor:4",),
               1: ("phase1_factor:3",)}
AUGMENT = {"labels": (augment.random_cae_augment, ("labels",)),
           "images": (augment.random_cae_augment_images,
                      ("pred_images", "labels")),
           "ctp": (augment.random_cae_augment_ctp, ("ctp_images", "labels"))}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    return make_setup(tmp_path_factory, list(CASES), list(REPLICATED),
                      ONE_PROCESS)


@pytest.mark.parametrize("case", CASES)
def test_two_rank_step_matches_jax_mesh_step(setup, case):
    check_vs_jax(setup, case)


@pytest.mark.parametrize("case", CASES)
def test_two_rank_step_matches_one_process_step(setup, case):
    check_vs_one_process(setup, case)


@pytest.mark.parametrize("case", ["phase1", "ctp"])
def test_controls_fail_the_limits(setup, case):
    check_controls(setup, case)


@pytest.mark.parametrize("case", REPLICATED)
def test_replicated_chunk_equals_one_process_step(setup, case):
    check_replicated(setup, case)


@pytest.mark.parametrize("name", sorted(AUGMENT))
def test_augmented_rows_equal_one_process_rows(setup, name):
    """Each rank's augmentation of its rows under a sharded step: its rows
    of one process's draws on the whole batch from the same seed, bit for
    bit, with the generator left where one process leaves it."""
    arrays, ranks = setup[0], setup[2]
    fn, keys = AUGMENT[name]
    gen = torch.Generator().manual_seed(worker.AUGMENT_SEED)
    want = fn(gen, *(torch.from_numpy(arrays[k]) for k in keys))
    want = want if isinstance(want, tuple) else (want,)
    after = torch.rand(4, generator=gen).numpy()
    for rank, got in enumerate(ranks):
        for i, w in enumerate(want):
            np.testing.assert_array_equal(got[f"augment/{name}/{i}"],
                                          w[rank::WORLD].numpy())
        np.testing.assert_array_equal(got[f"augment/{name}/next"], after)
    # the draws move the masks: a deformed row differs from its input
    assert not np.array_equal(ranks[0][f"augment/{name}/{len(want) - 1}"],
                              arrays["labels"][0::WORLD])


def test_only_the_lead_writes(setup):
    """Phase 1's ``save_model`` and ``save_training`` on both ranks, each
    into a directory of its own: rank 0 wrote, rank 1 nothing."""
    outdir = setup[3]
    lead = {p.name for p in (outdir / "files0").iterdir()}
    assert {"phase1_cae1.model", "phase1_cae1.optim",
            "phase1_cae1.json"} <= lead, lead
    assert not list((outdir / "files1").iterdir())
