"""Port parity for the U-Net's bfloat16 training step: ``Unet3D`` in
bfloat16 on the crop, the learner's loss and backward, held to the JAX
package's step run in float64 (``tests/test_torch_train.py``'s
``jax_step64``) beside the JAX package's own bfloat16 step on the same
variables and crop (its lax path).

At these widths the bfloat16 step does not resolve its gradients: JAX's
own bfloat16 step is 0.02-2.5 of each gradient's norm off float64 (the
entry conv's kernel 0.65, its BN bias 1.6), the port's 0.0007-0.88.  The
CAE step's rule (``tests/test_torch_cae_train_step.py``: a kernel within
1e-1 of its own max|ref|, a bias or BN scale within 5e-2 of its terms'
sum) was tried first and failed at the entry conv's kernel (0.226 of its
max, JAX's own bfloat16 step 0.63).  So each gradient tensor is held to
float64 relative to what bfloat16 resolves there: its relative L2 error
at most ``BF16_VS_JAX`` = 1.5 times the JAX bfloat16 step's plus 1e-2
(the port's largest ratio 1.22, at the first head conv's kernel).  A
wrong gradient fails where bfloat16 resolves it: the controls zero or
flip the output conv's bias and kernel and the last block's conv bias.
The loss and the running statistics within ``BF16_STEP_TOL``'s 2e-2.

The bfloat16 1^3 head's backward is held to the JAX package's bfloat16
``s2d_conv1x1`` (its TPU path): x's gradient rounded once to bfloat16 as
there, equal but for at most 0.1% of elements one bfloat16 step apart (the
forward test's rule); the kernel's and bias's gradients within 2^-7 of
max|ref| (JAX rounds the kernel gradient of each of the 8 s2d cell
positions to bfloat16 before their sum, the port the sum once)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stroke_prediction_tpu.ops.pallas.s2d import (
    s2d_conv1x1, s2d_pack, s2d_unpack)
from stroke_prediction_tpu_torch.data.augment import crop_patch
from stroke_prediction_tpu_torch.models.convert import (
    _unet_key_map, unet_state_from_jax)
from stroke_prediction_tpu_torch.models.layers import Conv3d
from stroke_prediction_tpu_torch.models.unet3d import Unet3D

from test_torch_cae_train_step import BF16_STEP_TOL
from test_torch_train import (  # noqa: F401  (fixtures)
    CHANNELS, PAD, PATCH, _batch, _jax_offsets, _jax_train_step, _leaf,
    _port_loss, jax_step, jax_step64, variables)

torch.set_num_threads(1)


def _crop():
    images, labels, key = _batch()
    return crop_patch(torch.from_numpy(images), torch.from_numpy(labels),
                      _jax_offsets(key, images, PATCH), PATCH, PAD)


def _port_step(variables, dtype):
    """The port's U-Net from ``variables`` at ``dtype``: one forward in
    training mode on the crop, the learner's loss, backward -> (loss,
    model)."""
    imgs, labs = _crop()
    model = Unet3D(CHANNELS, compute_dtype=dtype).train()
    model.load_state_dict(unet_state_from_jax(variables))
    wide = torch.promote_types(dtype, torch.float32)
    loss = _port_loss(model(imgs.to(wide)), labs.to(wide))
    loss.backward()
    return float(loss.detach()), model


# a gradient's relative L2 error against float64: at most this factor of
# the JAX bfloat16 step's, plus the floor
BF16_VS_JAX = (1.5, 1e-2)


@pytest.fixture(scope="module")
def jax_step_bf16(variables, jax_step):
    """JAX's own bfloat16 step on the same crop: (loss, grads, stats)."""
    return _jax_train_step(variables, jax_step[0], jax_step[1],
                           jnp.bfloat16)


def _rel_l2(got, ref):
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def _check_grads(grads, grads64, grads_jax_bf16):
    """Each gradient's relative L2 error against float64 within
    ``BF16_VS_JAX`` of the JAX bfloat16 step's."""
    factor, floor = BF16_VS_JAX
    n = 0
    for path, key in _unet_key_map():
        if path[0] != "params":
            continue
        ref = _leaf(grads64, path[1:])
        err = _rel_l2(grads[key], ref)
        limit = factor * _rel_l2(np.asarray(_leaf(grads_jax_bf16, path[1:]),
                                            np.float64), ref) + floor
        assert err <= limit, (key, err, limit)
        n += 1
    assert n == len(grads) == 44


def test_unet_bfloat16_train_step_matches_jax(variables, jax_step64,
                                              jax_step_bf16):
    """The loss, all 44 gradients (the head's among them) and the running
    statistics of the bfloat16 step against JAX's float64 step."""
    want_loss, grads64, want_stats = jax_step64
    tol_loss, _, tol_stats = BF16_STEP_TOL
    loss, model = _port_step(variables, torch.bfloat16)
    assert abs(loss - want_loss) <= tol_loss, (loss, want_loss)
    _check_grads({k: p.grad.double().numpy()
                  for k, p in model.named_parameters()}, grads64,
                 jax_step_bf16[1])
    buffers = dict(model.named_buffers())
    for path, key in _unet_key_map():
        if path[0] != "params":
            np.testing.assert_allclose(buffers[key].double().numpy(),
                                       _leaf(want_stats, path[1:]),
                                       atol=tol_stats, rtol=0, err_msg=key)


@pytest.mark.parametrize("key", ["head.1.bias", "head.1.kernel",
                                 "blocks.4.layers.1.conv.bias"])
def test_unet_bfloat16_step_check_sees_a_wrong_gradient(
        variables, jax_step64, jax_step_bf16, key):
    """Controls: the bfloat16 step's gradients pass the check, and with one
    gradient that bfloat16 resolves zeroed or sign-flipped fail it."""
    grads64 = jax_step64[1]
    _, model = _port_step(variables, torch.bfloat16)
    grads = {k: p.grad.double().numpy() for k, p in model.named_parameters()}
    _check_grads(grads, grads64, jax_step_bf16[1])
    for wrong in (np.zeros_like(grads[key]), -grads[key]):
        with pytest.raises(AssertionError, match=key):
            _check_grads({**grads, key: wrong}, grads64, jax_step_bf16[1])


@pytest.mark.parametrize("act", ["leaky_relu", "none"])
def test_conv1x1_head_bfloat16_backward_matches_s2d(act):
    rs = np.random.RandomState(0)
    x = jnp.asarray(rs.standard_normal((2, 6, 8, 10, 16)), jnp.bfloat16)
    k = (rs.standard_normal((1, 1, 1, 16, 32)) * 0.25).astype(np.float32)
    b = (rs.standard_normal(32) * 0.5).astype(np.float32)
    g = jnp.asarray(rs.standard_normal((2, 6, 8, 10, 32)), jnp.bfloat16)
    _, vjp = jax.vjp(lambda x, k, b: s2d_unpack(s2d_conv1x1(
        s2d_pack(x, dtype=jnp.bfloat16), k, b, act=act, alpha=0.01)),
        x.astype(jnp.float32), jnp.asarray(k), jnp.asarray(b))
    dx, dk, db = (np.asarray(v, np.float32) for v in vjp(g))

    head = Conv3d(16, 32, (1, 1, 1))
    with torch.no_grad():
        head.kernel.copy_(torch.from_numpy(k))
        head.bias.copy_(torch.from_numpy(b))
    xt = torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16).requires_grad_(True)
    head(xt, act=act, alpha=0.01).backward(
        torch.from_numpy(np.asarray(g, np.float32)).to(torch.bfloat16))
    assert xt.grad.dtype == torch.bfloat16
    off = np.abs(xt.grad.float().numpy() - dx)
    assert (off > 0).mean() <= 1e-3, ("elements off", (off > 0).mean())
    assert np.all(off <= 2.0 ** -7 * np.abs(dx)), off.max()
    for got, want in ((head.kernel.grad, dk), (head.bias.grad, db)):
        assert got.dtype == torch.float32
        err = np.abs(got.numpy() - want).max()
        assert err <= 2.0 ** -7 * np.abs(want).max(), err
