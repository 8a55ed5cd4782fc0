"""Port parity for one CAE phase-1 training step: ``Cae3D`` in training mode
over the gtruth branch (three encodes, the latent interpolation, four
decodes), the learner's loss (``cae_loss``), backward, against the JAX
package's model and ``CaeReconstructionLearner._loss`` on the CPU (the lax
conv path), from the same random variables and the same batch.

Compared: the loss, every parameter gradient (the entry BatchNorm's scale
and bias among them, which must be non-zero: its affine reaches the loss
only through the folded kernel and bias table of a conv whose input needs
no gradient) and the running statistics after the step, which chain over
the three encodes and four decodes in call order.  ``Enc3D`` at factor 0
and at factor 0.4 (the latent L1 term), and ``Enc3DStep`` with the time
given (its head off the loss's path: zero gradients).

Every compute type is held to JAX run in float64 (``_Float64Numpy`` in
place of the JAX modules' ``jnp``), for the reason
``tests/test_torch_train.py`` gives: float64 and float32 at the U-Net
step's ``TRAIN_STEP_TOL``; bfloat16 at ``BF16_STEP_TOL`` and
``BF16_SUM_TOL``.  A kernel's gradient error is taken relative to its own
max|ref|, as the U-Net step's is.  A bias's or a BN scale's gradient is a
sum over every voxel of the step's passes, which cancels to ~1e-4 of its
terms' size here while its rounding error follows that size: its error
is taken relative to the sum of |terms| (:func:`_sum_terms`), element by
element.  (Relative to its own value the float32 step put the entry BN's
bias 5.9e-5 off float64, above TRAIN_STEP_TOL's 5e-5; bfloat16 a decoder
bias 0.76 off, where JAX's own bfloat16 step is 19.5 off.)  A gradient that
cancels below what a type's rounding resolves passes whatever its value;
the controls show a wrong one that the type resolves failing.

With structure batching on (``STROKE_TPU_CAE_BATCH=1``, set before the
JAX function is traced, which must then ask the switch and stack) the
same step runs as one grouped encode and one grouped decode, and is held
to JAX's grouped step in float64 and bfloat16 at the same limits.  JAX's
grouped step is the same function as its sequential one (its
``tests/test_models.py`` equivalence; here equal to 1e-12 at both
factors), so the grouped ``Enc3DStep``, and the CTP and phase-2 steps in
their own files, are held to JAX's sequential float64 steps, which cost no
second trace.  The entry BN's affine is applied to the entry conv's
input, so its gradients arrive through that conv's dx: a control that
drops that dx (the JAX s2d path's grouped fault) must fail the check."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stroke_prediction_tpu import inference as jax_inference
from stroke_prediction_tpu.core.dto import BRANCH_GTRUTH as JAX_GTRUTH
from stroke_prediction_tpu.eval import metrics as jax_metrics
from stroke_prediction_tpu.models import cae3d as jax_cae3d
from stroke_prediction_tpu.models import layers as jax_layers
from stroke_prediction_tpu.train import cae_learners as jax_cae_learners
from stroke_prediction_tpu_torch.inference import cae_dto_from_batch
from stroke_prediction_tpu_torch.models import layers
from stroke_prediction_tpu_torch.models.cae3d import (
    Cae3D, Dec3D, Enc3D, Enc3DStep)
from stroke_prediction_tpu_torch.models.convert import (
    _key_map, state_from_jax)
from stroke_prediction_tpu_torch.ops import conv3x3
from stroke_prediction_tpu_torch.ops.conv3x3 import activation
from stroke_prediction_tpu_torch.train.cae_learners import cae_loss

from test_torch_train import TRAIN_STEP_TOL, _Float64Numpy, _leaf
from test_torch_unet import _random_variables

torch.set_num_threads(1)

CHANNELS = (1, 4, 6, 8, 10, 12, 1)
SPATIAL = (28, 64, 64)          # the smallest (D, H, W) the CAE takes
BATCH = 2
# (loss, grad / max|ref|, running statistics) of the bfloat16 step against
# JAX float64, set before the first comparison: the port rounds to
# bfloat16 where the JAX package's s2d path does (each layer's input and
# output, g' at every conv), 2^-9 of the value a rounding, over 24 layers
# forward and back; the loss at the U-Net bf16 forward test's 2e-2
BF16_STEP_TOL = (2e-2, 1e-1, 2e-2)
# a bias's or a BN scale's bfloat16 gradient against the sum of |terms|:
# each term carries the 24 layers' roundings, 2^-9 each, at most
BF16_SUM_TOL = 5e-2
ENTRY_BN = ("enc.encoder.blocks.0.bn.scale", "enc.encoder.blocks.0.bn.bias")


def _batch():
    """Soft (elastically deformed-like) core, penumbra and lesion masks and
    a clinical vector per sample (tO -> tA, tA -> tR in hours)."""
    rs = np.random.RandomState(5)
    labels = np.clip(rs.rand(BATCH, *SPATIAL, 3) * 1.6 - 0.3, 0.0,
                     1.0).astype(np.float32)
    clinical = np.array([[2.5, 3.0, 0.2, 0.4, 0.6],
                         [1.0, 5.5, 0.7, 0.1, 0.3]], np.float32)
    return labels, clinical


def _config(step):
    return {"kind": "cae3d", "channels": list(CHANNELS), "n_ch_global": 5,
            "step": step}


def _jax_model(step, dtype):
    enc = (jax_cae3d.Enc3DStep if step else jax_cae3d.Enc3D)(
        channels=CHANNELS, n_ch_global=5, compute_dtype=dtype)
    return jax_cae3d.Cae3D(enc=enc, dec=jax_cae3d.Dec3D(
        channels=CHANNELS, n_ch_global=5, compute_dtype=dtype))


def _variables(step, seed):
    """Random variables; the step model's tree is made with no time given,
    so that its head exists, as the JAX learner makes it."""
    labels, clinical = _batch()
    dto = jax_inference.cae_dto_from_batch(
        None, jnp.asarray(labels), jnp.asarray(clinical), learn_step=step)
    shapes = jax.eval_shape(lambda: _jax_model(step, jnp.float32).init(
        jax.random.PRNGKey(0), dto, JAX_GTRUTH, False))
    return _random_variables(shapes, np.random.RandomState(seed))


def _jax_step64(variables, step, factors):
    """value_and_grad of ``CaeReconstructionLearner._loss`` at train=True in
    float64, per factor -> [(loss, grads, new batch_stats)]."""
    labels, clinical = _batch()
    model = _jax_model(step, jnp.float64)
    loss_self = types.SimpleNamespace(_label_weights=(1.0,))

    def run(params, batch_stats, labels, clinical, factor):
        def loss_fn(p):
            dto = jax_inference.cae_dto_from_batch(None, labels, clinical)
            out, mut = model.apply({"params": p, "batch_stats": batch_stats},
                                   dto, JAX_GTRUTH, True,
                                   mutable=["batch_stats"])
            return jax_cae_learners.CaeReconstructionLearner._loss(
                loss_self, out, factor), mut
        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    with pytest.MonkeyPatch.context() as mp:
        for mod in (jax_layers, jax_cae3d, jax_metrics, jax_inference,
                    jax_cae_learners):
            mp.setattr(mod, "jnp", _Float64Numpy())
        jax.config.update("jax_enable_x64", True)
        try:
            cast = lambda t: jax.tree_util.tree_map(  # noqa: E731
                lambda a: jnp.asarray(a, jnp.float64), t)
            fn = jax.jit(run)
            out = []
            for factor in factors:
                (loss, mut), grads = fn(
                    cast(variables["params"]),
                    cast(variables["batch_stats"]),
                    jnp.asarray(labels, jnp.float64),
                    jnp.asarray(clinical, jnp.float64),
                    jnp.asarray(factor, jnp.float64))
                out.append((float(loss),
                            jax.tree_util.tree_map(np.asarray, grads),
                            jax.tree_util.tree_map(np.asarray,
                                                   mut["batch_stats"])))
            return out
        finally:
            jax.config.update("jax_enable_x64", False)


FACTORS = (0.0, 0.4)


def _witness(step, seed, factors):
    """Random variables and, per factor, JAX's float64 step (loss,
    gradients, running statistics) with the port's sums' sizes."""
    variables = _variables(step, seed)
    return variables, {
        f: (*out, _sum_terms(variables, step, f))
        for f, out in zip(factors, _jax_step64(variables, step, factors))}


@pytest.fixture(scope="module")
def jax_enc3d():
    return _witness(False, 0, FACTORS)


@pytest.fixture(scope="module")
def jax_enc3d_step():
    return _witness(True, 1, FACTORS[:1])


def _port_step(variables, step, factor, dtype):
    """The port's model from ``variables`` at ``dtype``: one forward in
    training mode, ``cae_loss``, backward -> (loss, model)."""
    labels, clinical = _batch()
    enc_cls = Enc3DStep if step else Enc3D
    model = Cae3D(enc_cls(CHANNELS, 5, compute_dtype=dtype),
                  Dec3D(CHANNELS, 5, compute_dtype=dtype))
    model.load_state_dict(state_from_jax(variables, _config(step)))
    if dtype == torch.float64:
        model.to(dtype)
    model.train()
    wide = torch.promote_types(dtype, torch.float32)
    dto = model(cae_dto_from_batch(None, torch.from_numpy(labels).to(wide),
                                   torch.from_numpy(clinical).to(wide)))
    loss = cae_loss(dto, factor)
    loss.backward()
    return float(loss.detach()), model


def _sum_terms(variables, step, factor):
    """The size of the sum behind each bias-like gradient: one float64 step
    of the port with BN applied rather than folded, every BN output and
    pre-activation kept -> {parameter: sum over the voxels and the calls of
    |g| (a bias) or |g * x_hat| (a BN scale)}, g the loss's gradient at the
    layer's output."""
    kept = []

    def bn_forward(self, x, groups=1):
        assert groups == 1       # the passes one structure each
        s, t = self.affine(x)
        out = x * s + t
        out.retain_grad()
        with torch.no_grad():
            axes = tuple(range(x.ndim - 1))
            mean = x.mean(axes)
            var = torch.clamp((x * x).mean(axes) - mean * mean, min=0.0)
            x_hat = (x - mean) * torch.rsqrt(var + self.epsilon)
        kept.extend([(self.bias, out, None), (self.scale, out, x_hat)])
        return out

    def keep_bias(forward):
        def run(self, x, *args):
            out = forward(self, x)
            out.retain_grad()
            kept.append((self.bias, out, None))
            return activation(out, *args) if args else out
        return run

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(layers.BatchNorm, "forward", bn_forward)
        mp.setattr(layers.BnConvActBlock, "forward",
                   lambda self, x, groups=1: self.conv(
                       self.bn(x, groups), self.act, self.act_param))
        for cls in (layers.Conv3d, layers.ConvTranspose3d, layers.Dense):
            mp.setattr(cls, "forward", keep_bias(cls.forward))
        _, model = _port_step(variables, step, factor, torch.float64)
    terms = {}
    for param, out, x_hat in kept:
        if out.grad is not None:
            g = out.grad if x_hat is None else out.grad * x_hat
            s = g.abs().sum(tuple(range(g.ndim - 1)))
            terms[param] = terms.get(param, 0.0) + s
    return {k: terms[p].numpy() for k, p in model.named_parameters()
            if p in terms}


def _tols(dtype):
    """(loss, kernel gradient, summed gradient, running statistics)."""
    if dtype == "bfloat16":
        loss, grad, stats = BF16_STEP_TOL
        return loss, grad, BF16_SUM_TOL, stats
    loss, grad, stats = TRAIN_STEP_TOL[dtype]
    return loss, grad, grad, stats


def _check_grads(step, grads, grads64, terms, tol, sum_tol):
    """Every parameter gradient of the port (``grads``: name -> array, or
    None off the loss's path) against JAX's float64 one: a kernel's within
    ``tol`` of its own max|ref|, a bias's or a BN scale's within
    ``sum_tol`` of its sum's size (``terms``), element by element."""
    params = [(key, _leaf(grads64, path[1:]))
              for path, key in _key_map(_config(step)) if path[0] == "params"]
    assert len(params) == len(grads)
    for key, ref in params:
        got = np.zeros(ref.shape) if grads[key] is None else grads[key]
        err = np.abs(got - ref)
        if key in terms:
            bad = err > sum_tol * terms[key]
            assert not bad.any(), (key, float((err / terms[key])[bad].max()))
        else:
            assert err.max() <= tol * np.abs(ref).max(), (key, err.max())


def _grads(model):
    return {k: None if p.grad is None else p.grad.double().numpy()
            for k, p in model.named_parameters()}


def _check_step(witness, variant, dtype):
    """The port's step of ``variant`` at ``dtype`` against ``witness``
    (JAX's float64 steps by factor): the loss, every gradient, the entry
    BN's non-zero, the step head's off the path, and the running
    statistics."""
    step = variant == "enc3d_step"
    factor = 0.4 if variant == "enc3d_factor" else 0.0
    variables, by_factor = witness
    want_loss, grads64, want_stats, terms = by_factor[factor]
    tol_loss, tol_grad, tol_sum, tol_stats = _tols(dtype)

    loss, model = _port_step(variables, step, factor, getattr(torch, dtype))
    assert abs(loss - want_loss) <= tol_loss, (loss, want_loss)
    named = dict(model.named_parameters())
    buffers = dict(model.named_buffers())
    _check_grads(step, _grads(model), grads64, terms, tol_grad, tol_sum)
    # every BN's scale and bias, and every conv's bias (the step head's
    # dense layers are off the path: no sums)
    assert len(terms) == 2 * (10 + 12) + 10 + 12
    for path, key in _key_map(_config(step)):
        if path[0] != "params":
            np.testing.assert_allclose(buffers[key].double().numpy(),
                                       _leaf(want_stats, path[1:]),
                                       atol=tol_stats, rtol=0, err_msg=key)
    for key in ENTRY_BN:
        assert float(named[key].grad.abs().max()) > 0, key
    head = [k for k in named if k.split(".")[1] in
            ("reduce1", "reduce2", "step_head")]
    assert len(head) == (6 if step else 0)
    for key in head:              # off the path with the time given
        assert named[key].grad is None, key


@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["enc3d", "enc3d_factor", "enc3d_step"])
def test_cae_train_step_matches_jax(jax_enc3d, jax_enc3d_step, variant,
                                    dtype):
    _check_step(jax_enc3d_step if variant == "enc3d_step" else jax_enc3d,
                variant, dtype)


SWITCH = "STROKE_TPU_CAE_BATCH"


def grouped_jax(run):
    """``run()`` with the JAX package's structure batching switched on;
    fails unless its models asked the switch and were told to stack."""
    asked = []
    real = jax_cae3d.structure_batching

    def spy():
        asked.append(real())
        return asked[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(SWITCH, "1")
        mp.setattr(jax_cae3d, "structure_batching", spy)
        out = run()
    assert asked and all(asked), asked
    return out


@pytest.fixture(scope="module")
def jax_enc3d_grouped(jax_enc3d):
    """JAX's grouped float64 steps from ``jax_enc3d``'s variables, with
    its sums' sizes: the grouped step is the same function as the
    sequential one, so the sizes of its sums are those of the sequential
    passes."""
    variables, by_factor = jax_enc3d
    out = grouped_jax(lambda: _jax_step64(variables, False, FACTORS))
    return variables, {f: (*o, by_factor[f][3]) for f, o in zip(FACTORS,
                                                                out)}


# JAX's grouped step against its sequential one (float64): the loss and a
# statistic relative to max(1, |value|), a gradient to its tensor's max
JAX_GROUPED_TOL = 1e-12


@pytest.mark.parametrize("factor", FACTORS)
def test_jax_grouped_step_equals_its_sequential_step(jax_enc3d,
                                                     jax_enc3d_grouped,
                                                     factor):
    """JAX's grouped float64 step is its sequential step: the witness that
    the grouped ``Enc3DStep``, CTP and phase-2 steps are held to."""
    (loss, grads, stats, _), (loss_g, grads_g, stats_g, _) = (
        w[1][factor] for w in (jax_enc3d, jax_enc3d_grouped))
    assert abs(loss_g - loss) <= JAX_GROUPED_TOL * max(1.0, abs(loss))
    for tree, tree_g, rel in ((grads, grads_g, True),
                              (stats, stats_g, False)):
        flat = jax.tree_util.tree_leaves_with_path(tree)
        flat_g = jax.tree_util.tree_leaves(tree_g)
        assert len(flat) == len(flat_g)
        for (path, ref), got in zip(flat, flat_g):
            scale = np.abs(ref).max() if rel else max(1.0,
                                                      np.abs(ref).max())
            err = np.abs(got - ref).max()
            assert err <= JAX_GROUPED_TOL * scale, (path, err / scale)


@pytest.mark.parametrize("dtype", ["float64", "bfloat16"])
@pytest.mark.parametrize("variant", ["enc3d", "enc3d_factor", "enc3d_step"])
def test_cae_grouped_train_step_matches_jax(jax_enc3d_grouped,
                                            jax_enc3d_step,
                                            monkeypatch, variant, dtype):
    """The step with structure batching on (one encode of three groups,
    one decode of four, grouped BN) against JAX's grouped step (the
    ``Enc3DStep``: JAX's sequential step, the same function), at the
    sequential step's limits: the loss, every gradient (the entry BN's
    non-zero: its affine now reaches the loss through the entry conv's dx)
    and the running statistics, chained over the groups."""
    monkeypatch.setenv(SWITCH, "1")
    _check_step(jax_enc3d_step if variant == "enc3d_step"
                else jax_enc3d_grouped, variant, dtype)


class _EntryWithoutDx:
    """``Conv3x3Fn`` with the input of a C_in-1 conv (the entry) detached:
    its backward takes K4 alone, as the folded entry conv on data does."""

    @staticmethod
    def apply(x, *args):
        return conv3x3.Conv3x3Fn.apply(
            x.detach() if x.shape[-1] == CHANNELS[0] else x, *args)


def test_cae_grouped_step_check_sees_a_dropped_entry_dx(jax_enc3d_grouped,
                                                        monkeypatch):
    """Control: the grouped float32 step with the entry conv's dx dropped
    (the JAX s2d path's grouped fault) gives the entry BN zero gradients,
    and the gradient check fails on them."""
    monkeypatch.setenv(SWITCH, "1")
    monkeypatch.setattr(layers, "Conv3x3Fn", _EntryWithoutDx)
    variables, by_factor = jax_enc3d_grouped
    _, grads64, _, terms = by_factor[0.0]
    _, model = _port_step(variables, False, 0.0, torch.float32)
    grads = _grads(model)
    for key in ENTRY_BN:        # off the graph: no gradient at all
        assert grads[key] is None, key
    with pytest.raises(AssertionError, match="enc.encoder.blocks.0.bn"):
        _check_grads(False, grads, grads64, terms, *_tols("float32")[1:3])


@pytest.mark.parametrize("dtype, key", [
    ("bfloat16", "dec.decoder.convs.7.bias"),
    ("float32", "enc.encoder.blocks.0.bn.bias")])
def test_cae_train_step_check_sees_a_wrong_bias_gradient(jax_enc3d, dtype,
                                                         key):
    """Controls of the gradient check: the port's step passes it, and the
    same step with one bias gradient zeroed or sign-flipped fails it.  In
    bfloat16 the output conv's bias (a sum over the voxels that keeps ~0.2
    of its terms' size); in float32 the entry BN's bias, whose sum cancels
    to ~3e-4 of its terms' size, below what bfloat16's rounding resolves."""
    variables, by_factor = jax_enc3d
    _, grads64, _, terms = by_factor[0.0]
    tols = _tols(dtype)[1:3]
    _, model = _port_step(variables, False, 0.0, getattr(torch, dtype))
    grads = _grads(model)
    _check_grads(False, grads, grads64, terms, *tols)
    for wrong in (np.zeros_like(grads[key]), -grads[key]):
        with pytest.raises(AssertionError, match=key):
            _check_grads(False, {**grads, key: wrong}, grads64, terms, *tols)
