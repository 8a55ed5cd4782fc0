"""Port parity: the fused 3x3x3 conv (K1, ops/conv3x3.py) and the BN folds
against the JAX package's s2d conv engine (Pallas kernel in interpret mode).

Tolerance 1e-5 (atol and rtol): both sides accumulate in float32; the two
differ only in summation order over at most 27 * C_in terms."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stroke_prediction_tpu.ops.pallas.s2d import fold_bn as jax_fold_bn
from stroke_prediction_tpu.ops.pallas.s2d import (
    fold_bn_zsame as jax_fold_bn_zsame)
from stroke_prediction_tpu.ops.pallas.s2d import s2d_conv, s2d_pack, s2d_unpack
from stroke_prediction_tpu_torch.ops import conv3x3 as conv_mod
from stroke_prediction_tpu_torch.ops.conv3x3 import (
    conv3x3, conv3x3_plain, fold_bn, fold_bn_zsame)

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)
ALPHA = {"none": 0.01, "leaky_relu": 0.01, "elu": 0.7}


def _case(seed, b, d, h, w, ci, co):
    rs = np.random.RandomState(seed)
    x = (rs.rand(b, d, h, w, ci) - 0.5).astype(np.float32)
    k = ((rs.rand(3, 3, 3, ci, co) - 0.5) * 0.4).astype(np.float32)
    bias = (rs.rand(co) - 0.5).astype(np.float32)
    scale = (0.5 + rs.rand(ci)).astype(np.float32)
    shift = (rs.rand(ci) - 0.5).astype(np.float32)
    return x, k, bias, scale, shift


@pytest.mark.parametrize("bias_kind", ["vector", "plane_table"])
@pytest.mark.parametrize("act", ["none", "leaky_relu", "elu"])
@pytest.mark.parametrize("mode", ["v", "s"])
def test_conv3x3_matches_s2d_conv(mode, act, bias_kind):
    b, d, h, w, ci, co = 1, 6, 9, 10, 3, 5
    x, k, bias, scale, shift = _case(7, b, d, h, w, ci, co)
    if bias_kind == "plane_table":
        d_out = d if mode == "s" else d - 2
        k, bias = (np.array(a) for a in jax_fold_bn_zsame(
            jnp.asarray(k), jnp.asarray(bias), jnp.asarray(scale),
            jnp.asarray(shift), d_out))
    ref = s2d_unpack(s2d_conv(s2d_pack(jnp.asarray(x), dtype=jnp.float32),
                              jnp.asarray(k), jnp.asarray(bias), act=act,
                              alpha=ALPHA[act], modes=(mode, "v", "v")))
    before = conv_mod.conv3x3.launches
    got = conv3x3(torch.from_numpy(x), torch.from_numpy(k),
                  torch.from_numpy(bias), act, ALPHA[act], mode)
    assert conv_mod.conv3x3.launches == before   # CPU: plain path
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_fold_bn_matches_jax():
    x, k, bias, scale, shift = _case(3, 1, 5, 6, 7, 4, 6)
    k2, b2 = fold_bn(*(torch.from_numpy(a) for a in (k, bias, scale, shift)))
    rk, rb = jax_fold_bn(*(jnp.asarray(a) for a in (k, bias, scale, shift)))
    np.testing.assert_allclose(k2.numpy(), np.asarray(rk), **TOL)
    np.testing.assert_allclose(b2.numpy(), np.asarray(rb), **TOL)
    # folding is exact for a VALID conv: conv(bn(x)) == conv_folded(x)
    xt = torch.from_numpy(x)
    bn_x = xt * torch.from_numpy(scale) + torch.from_numpy(shift)
    np.testing.assert_allclose(
        conv3x3_plain(xt, k2, b2).numpy(),
        conv3x3_plain(bn_x, torch.from_numpy(k),
                      torch.from_numpy(bias)).numpy(), **TOL)


@pytest.mark.parametrize("d_out", [1, 5])
def test_fold_bn_zsame_matches_jax(d_out):
    _, k, bias, scale, shift = _case(5, 1, 5, 6, 7, 3, 4)
    k2, bz = fold_bn_zsame(*(torch.from_numpy(a)
                             for a in (k, bias, scale, shift)), d_out)
    rk, rb = jax_fold_bn_zsame(*(jnp.asarray(a)
                                 for a in (k, bias, scale, shift)), d_out)
    np.testing.assert_allclose(k2.numpy(), np.asarray(rk), **TOL)
    np.testing.assert_allclose(bz.numpy(), np.asarray(rb), **TOL)


def test_conv3x3_zsame_fold_equals_padded_bn_conv():
    """The plane table makes the z-SAME fold exact: the reference pads the
    BN OUTPUT with zero planes."""
    x, k, bias, scale, shift = _case(11, 1, 5, 6, 7, 3, 4)
    xt, kt, bt = (torch.from_numpy(a) for a in (x, k, bias))
    st, tt = torch.from_numpy(scale), torch.from_numpy(shift)
    k2, bz = fold_bn_zsame(kt, bt, st, tt, 5)
    got = conv3x3(xt, k2, bz, "elu", 1.0, "s")
    padded = torch.nn.functional.pad(xt * st + tt, (0, 0, 0, 0, 0, 0, 1, 1))
    want = conv3x3_plain(padded, kt, bt, "elu", 1.0, "v")
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("bad", ["kernel_shape", "bias_shape", "act", "mode"])
def test_conv3x3_rejects_bad_arguments(bad):
    x = torch.zeros(1, 5, 5, 5, 2)
    k = torch.zeros(3, 3, 3, 2, 4)
    bias = torch.zeros(4)
    kw = dict(act="none", mode="v")
    if bad == "kernel_shape":
        k = torch.zeros(3, 3, 3, 3, 4)
    elif bad == "bias_shape":
        bias = torch.zeros(5)
    elif bad == "act":
        kw["act"] = "relu"
    else:
        kw["mode"] = "x"
    with pytest.raises(ValueError):
        conv3x3(x, k, bias, **kw)
