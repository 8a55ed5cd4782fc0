"""Port parity: the fused 3x3x3 conv (K1, ops/conv3x3.py) and the BN folds
against the JAX package's s2d conv engine (Pallas kernel in interpret mode).

Float32 tolerance 1e-5 (atol and rtol): both sides accumulate in float32;
the two differ only in summation order over at most 27 * C_in terms.  The
bfloat16 forward is held to one bfloat16 step in at most 0.1% of elements
(see its test).  The 3xTF32 arithmetic of the card's float32 forward is
emulated here and held to the card's float32 limit (see its test)."""

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
# the card's float32 K1 against its plain version (chip_smoke.py K1_TOL):
# float32 sums of up to 27 * 96 terms in another order
K1_TOL = dict(atol=1e-4, rtol=1e-4)
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


@pytest.mark.parametrize("width", ["narrow", "wide"])
@pytest.mark.parametrize("bias_kind", ["vector", "plane_table"])
@pytest.mark.parametrize("act", ["none", "leaky_relu", "elu"])
@pytest.mark.parametrize("mode", ["v", "s"])
def test_conv3x3_bfloat16_matches_s2d_conv(mode, act, bias_kind, width):
    """The bfloat16 forward (the kernel cast to bfloat16 after the BN fold,
    float32 sums, bias and activation in float32, one rounding) against
    ``s2d_conv`` on ``s2d_pack(x, bfloat16)``.  Outputs are equal, or in at
    most 0.1% of elements one bfloat16 step (2^-7 of the value) apart: two
    float32 sums of up to 27 * C_in products in another order may round to
    neighbouring bfloat16 values."""
    b, d, h, w, ci, co = ((1, 6, 9, 10, 2, 16) if width == "narrow"
                          else (1, 5, 8, 9, 24, 8))
    x, k, bias, scale, shift = _case(13, b, d, h, w, ci, co)
    if bias_kind == "plane_table":
        d_out = d if mode == "s" else d - 2
        k, bias = (np.array(a) for a in jax_fold_bn_zsame(
            jnp.asarray(k), jnp.asarray(bias), jnp.asarray(scale),
            jnp.asarray(shift), d_out))
    ref = np.asarray(s2d_unpack(s2d_conv(
        s2d_pack(jnp.asarray(x), dtype=jnp.bfloat16), jnp.asarray(k),
        jnp.asarray(bias), act=act, alpha=ALPHA[act],
        modes=(mode, "v", "v"))), np.float32)
    before = conv_mod.conv3x3.launches
    got = conv3x3(torch.from_numpy(x).to(torch.bfloat16),
                  torch.from_numpy(k).to(torch.bfloat16),
                  torch.from_numpy(bias), act, ALPHA[act], mode)
    assert conv_mod.conv3x3.launches == before   # CPU: plain path
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == ref.shape
    off = np.abs(got.float().numpy() - ref)
    assert (off > 0).mean() <= 1e-3, ("elements off", (off > 0).mean())
    assert np.all(off <= 2.0 ** -7 * np.abs(ref)), off.max()


def _tf32(a):
    """float32 rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: to
    nearest, ties away from zero, to a 10-bit mantissa (on the int32 view,
    ``(i + 0x1000) & ~0x1FFF``)."""
    i = np.ascontiguousarray(a, np.float32).view(np.int32)
    return ((i + 0x1000) & ~0x1FFF).astype(np.int32).view(np.float32)


@pytest.mark.parametrize("ci, co, lo, hi, dhw", [
    (96, 32, -1.0, 1.0, (5, 6, 6)),
    (2, 16, 0.0, 40.0, (6, 8, 8)),     # the entry conv on raw image values
    (64, 64, -1.0, 1.0, (5, 6, 6)),
], ids=["96-32", "2-16-image", "64-64"])
def test_conv3x3_3xtf32_split_matches_s2d_conv(ci, co, lo, hi, dhw):
    """The arithmetic of the card's float32 K1
    (``csrc/conv3x3_fwd_f32_tc.cu``): each operand v split into big =
    tf32(v) and small = tf32(v - big), and x * k taken as small_x * big_k +
    big_x * small_k + big_x * big_k (the products exact, summed in float64
    here).  That conv holds to the JAX package's float32 ``s2d_conv`` within
    the card's float32 limit ``K1_TOL``; one TF32 product (big_x * big_k)
    does not, so the limit tells the two designs apart."""
    rs = np.random.RandomState(17)
    x = rs.uniform(lo, hi, (1, *dhw, ci)).astype(np.float32)
    bnd = (27 * ci) ** -0.5
    k = rs.uniform(-bnd, bnd, (3, 3, 3, ci, co)).astype(np.float32)
    bias = rs.uniform(-bnd, bnd, co).astype(np.float32)
    ref = np.asarray(s2d_unpack(s2d_conv(
        s2d_pack(jnp.asarray(x), dtype=jnp.float32), jnp.asarray(k),
        jnp.asarray(bias), act="leaky_relu", alpha=0.01,
        modes=("v", "v", "v"))))

    x_big, k_big = _tf32(x), _tf32(k)
    x_small, k_small = _tf32(x - x_big), _tf32(k - k_big)
    for v, big, small in ((x, x_big, x_small), (k, k_big, k_small)):
        assert np.all(np.abs(v - big - small) <= 2.0 ** -22 * np.abs(v))
    zero = torch.zeros(co, dtype=torch.float64)

    def conv(*pairs):
        """act(sum of the float64 convs of the (x, k) pairs + bias)."""
        pre = sum(conv3x3_plain(torch.from_numpy(a).double(),
                                torch.from_numpy(b).double(), zero)
                  for a, b in pairs)
        return conv_mod.activation(pre + torch.from_numpy(bias).double(),
                                   "leaky_relu", 0.01).numpy()

    three = conv((x_small, k_big), (x_big, k_small), (x_big, k_big))
    one = conv((x_big, k_big))
    assert three.shape == ref.shape
    np.testing.assert_allclose(three, ref, **K1_TOL)
    assert not np.allclose(one, ref, **K1_TOL), np.abs(one - ref).max()


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
