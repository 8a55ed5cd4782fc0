"""Port parity for one training step of the CTP-conditioned CAE
(``Cae3DCtp`` in training mode over the gtruth branch, the masks
concatenated with the cropped CBV and TTD images, ``cae_loss``, backward)
against the JAX package's model and ``CaeReconstructionLearner._loss`` run
in float64 on the CPU, in float64, float32 and bfloat16.

The step is held at the phase-1 step's limits
(``tests/test_torch_cae_train_step.py``), the entry BN's scale and bias and
the entry kernel's gradients among them (on CT intensities, where the
folded BN's kernel gradient ``dk' s + t db'`` cancels), with one addition: a
float32 kernel gradient's limit is at least 1.5x JAX's own float32 step's
error there.  Here the gradients that reach the decoder cancel far below
their terms, and JAX's float32 step is 1.9e-4 to 5.1e-4 of a decoder
kernel's max|grad| off float64 (the port's 0.9e-4 to 2.2e-4, at most 0.99x
JAX's error at every parameter), above the 5e-5 that the masks' step
meets.  Controls with a wrong entry gradient must fail those limits.  With
structure batching on, the grouped step is held to JAX's float64 step in
float64 and bfloat16 at the same limits, bfloat16 without the latent L1
term (``GROUPED_BF16_FACTOR``)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_cae_train_step as phase1_step
from stroke_prediction_tpu import inference as jax_inference
from stroke_prediction_tpu.core.dto import BRANCH_GTRUTH as JAX_GTRUTH
from stroke_prediction_tpu.train import cae_learners as jax_cae_learners
from stroke_prediction_tpu_torch.models.convert import _key_map
from stroke_prediction_tpu_torch.train.cae_learners import cae_loss

from test_torch_cae_ctp import (
    CONFIG, ENTRY, _batch, _cast64, _jax64, _jax_dto, _jax_model, _port_dto,
    _port_model, _variables)
from test_torch_train import _leaf

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def variables():
    return _variables()


def _jax_step64(variables, factors):
    """value_and_grad of ``CaeReconstructionLearner._loss`` at train=True in
    float64, per factor (one trace: the factor is an argument) -> [(loss,
    grads, new batch_stats)]."""
    images, labels, clinical = _batch()
    loss_self = types.SimpleNamespace(_label_weights=(1.0,))

    def run():
        model = _jax_model(jnp.float64)

        def loss_fn(p, factor):
            dto = jax_inference.cae_dto_from_batch(
                *(jnp.asarray(a, jnp.float64) for a in (images, labels,
                                                         clinical)),
                inputs_from_images=True)
            out, mut = model.apply(
                {"params": p, "batch_stats": _cast64(
                    variables["batch_stats"])},
                dto, JAX_GTRUTH, True, mutable=["batch_stats"])
            return jax_cae_learners.CaeReconstructionLearner._loss(
                loss_self, out, factor), mut

        fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
        out = []
        for factor in factors:
            (loss, mut), grads = fn(_cast64(variables["params"]),
                                    jnp.asarray(factor, jnp.float64))
            out.append((float(loss),
                        jax.tree_util.tree_map(np.asarray, grads),
                        jax.tree_util.tree_map(np.asarray,
                                               mut["batch_stats"])))
        return out

    return _jax64(run)


def _port_step(variables, factor, dtype):
    """The port's CTP model from ``variables`` at ``dtype``: one forward in
    training mode, ``cae_loss``, backward -> (loss, model)."""
    images, labels, clinical = _batch()
    model = _port_model(variables, dtype).train()
    dto = model(_port_dto(images, labels, clinical,
                          torch.promote_types(dtype, torch.float32)))
    loss = cae_loss(dto, factor)
    loss.backward()
    return float(loss.detach()), model


FACTOR = 0.4                     # the latent L1 term on
# a float32 kernel gradient's limit where JAX's own float32 step is further
# off float64 than TRAIN_STEP_TOL: this factor times JAX's error there (as
# tests/test_torch_unet_bf16_step.py holds the U-Net's bfloat16 step)
JAX32_FACTOR = 1.5


def _jax_step32(variables, factor):
    """JAX's own float32 step's gradients (its lax path on the CPU)."""
    images, labels, clinical = _batch()
    model = _jax_model()
    loss_self = types.SimpleNamespace(_label_weights=(1.0,))

    def loss_fn(p):
        out, mut = model.apply(
            {"params": p, "batch_stats": variables["batch_stats"]},
            _jax_dto(images, labels, clinical), JAX_GTRUTH, True,
            mutable=["batch_stats"])
        return jax_cae_learners.CaeReconstructionLearner._loss(
            loss_self, out, factor)

    grads = jax.jit(jax.grad(loss_fn))(variables["params"])
    return jax.tree_util.tree_map(np.asarray, grads)


# the grouped bfloat16 step's curriculum factor: the latent L1 term off.
# Its gradient is a sign, and the CTP encoder's latents nearly coincide:
# the grouped bfloat16 step's rounding put one of the interpolation
# latent's 96 elements on the other side of the lesion latent's than
# float64 (the sequential step's rounding none), which moves every encoder
# gradient by up to 0.16 of its max (ROADMAP §3: a non-smooth loss term,
# not a fault of either side; chip_smoke.py's CTP card-vs-CPU step is at
# factor 0 for it).  The grouped float64 step holds the term at FACTOR.
GROUPED_BF16_FACTOR = 0.0


def _sum_terms(variables, factor):
    """The phase-1 step test's ``_sum_terms`` on this model."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(phase1_step, "_port_step",
                   lambda v, step, f, dt: _port_step(v, f, dt))
        return phase1_step._sum_terms(variables, False, factor)


@pytest.fixture(scope="module")
def witnesses(variables):
    """By factor (FACTOR and GROUPED_BF16_FACTOR, one trace): JAX's
    float64 step (loss, gradients, statistics), the size of each bias-like
    gradient's sum and, at FACTOR, JAX's float32 gradients."""
    steps = _jax_step64(variables, [FACTOR, GROUPED_BF16_FACTOR])
    return {FACTOR: (*steps[0], _sum_terms(variables, FACTOR),
                     _jax_step32(variables, FACTOR)),
            GROUPED_BF16_FACTOR: (*steps[1], _sum_terms(
                variables, GROUPED_BF16_FACTOR), None)}


@pytest.fixture(scope="module")
def witness(witnesses):
    return witnesses[FACTOR]


def _check(dtype, grads, witness):
    """The phase-1 step's gradient rules (``_check_grads``): a kernel's
    gradient within the type's limit of its own max|ref|, a bias's or a BN
    scale's within the sum limit of its terms' size, element by element.
    In float32 a kernel's limit is at least JAX32_FACTOR times JAX's own
    float32 step's max|err| there."""
    _, grads64, _, terms, grads32 = witness
    _, tol, sum_tol, _ = phase1_step._tols(dtype)
    params = [(path[1:], key) for path, key in _key_map(CONFIG)
              if path[0] == "params"]
    assert len(params) == len(grads)
    for path, key in params:
        ref = _leaf(grads64, path)
        err = np.abs(grads[key] - ref)
        if key in terms:
            bad = err > sum_tol * terms[key]
            assert not bad.any(), (key, float((err / terms[key])[bad].max()))
            continue
        limit = tol * np.abs(ref).max()
        if dtype == "float32":
            limit = max(limit, JAX32_FACTOR * np.abs(
                _leaf(grads32, path) - ref).max())
        assert err.max() <= limit, (key, err.max() / np.abs(ref).max())


def _check_step(variables, witness, dtype, factor=FACTOR):
    want_loss, _, want_stats, terms, _ = witness
    tol_loss, _, _, tol_stats = phase1_step._tols(dtype)
    loss, model = _port_step(variables, factor, getattr(torch, dtype))
    assert abs(loss - want_loss) <= tol_loss, (loss, want_loss)
    grads = phase1_step._grads(model)
    _check(dtype, grads, witness)
    assert len(terms) == 2 * (10 + 12) + 10 + 12
    for key in ENTRY:
        assert np.abs(grads[key]).max() > 0, key
    # the statistics at the step's limit, relative where a statistic
    # exceeds 1 (the entry BN's TTD variance is ~65)
    buffers = dict(model.named_buffers())
    for path, key in _key_map(CONFIG):
        if path[0] == "batch_stats":
            ref = _leaf(want_stats, path[1:])
            err = np.abs(buffers[key].double().numpy() - ref)
            assert (err <= tol_stats * np.maximum(np.abs(ref), 1.0)).all(), (
                key, err.max())


@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
def test_ctp_train_step_matches_jax(variables, witness, dtype):
    """One CTP training step against JAX float64: the loss, every parameter
    gradient (the entry BN's scale and bias and the entry kernel's among
    them, each non-zero) and the running statistics after the step (at the
    step's limit times max(1, |statistic|))."""
    _check_step(variables, witness, dtype)


@pytest.mark.parametrize("dtype, factor", [("float64", FACTOR),
                                           ("bfloat16", GROUPED_BF16_FACTOR)],
                         ids=["float64", "bfloat16"])
def test_ctp_grouped_train_step_matches_jax(variables, witnesses,
                                            monkeypatch, dtype, factor):
    """The CTP step with structure batching on (one encode of the three
    masks with CBV and TTD, C_in 3, one decode of four) against JAX's
    float64 step (the sequential one: JAX's grouped step is the same
    function, test_torch_cae_train_step.py), at the same limits: float64
    at FACTOR, bfloat16 at GROUPED_BF16_FACTOR; the entry BN's gradients
    arrive through the entry conv's dx and are non-zero."""
    monkeypatch.setenv(phase1_step.SWITCH, "1")
    _check_step(variables, witnesses[factor], dtype, factor)


@pytest.mark.parametrize("dtype, key", [
    *(("float32", k) for k in ENTRY), ("bfloat16", ENTRY[2])])
def test_ctp_train_step_check_sees_a_wrong_entry_gradient(variables, witness,
                                                          dtype, key):
    """Controls: the step passes the gradient check, and the same step with
    one entry gradient (the BN's scale or bias, or the conv's kernel, on CT
    intensities) zeroed or sign-flipped fails it.  In bfloat16 the kernel
    only: the entry BN's scale and bias sums cancel to 1.4e-2 and 6.6e-4 of
    their terms' size here, below what bfloat16's rounding resolves."""
    _, model = _port_step(variables, FACTOR, getattr(torch, dtype))
    grads = phase1_step._grads(model)
    _check(dtype, grads, witness)
    for wrong in (np.zeros_like(grads[key]), -grads[key]):
        with pytest.raises(AssertionError, match=key):
            _check(dtype, {**grads, key: wrong}, witness)
