"""Port parity: the backward of the fused 3x3x3 conv (K2-K4 wrappers and
``Conv3x3Fn``, ops/conv3x3.py) against ``jax.vjp`` of the JAX package's s2d
conv, whose backward is the Pallas ``_bwd_kernel`` / ``_dx_kernel`` /
``_dw_kernel`` run in interpret mode.

Tolerance: max |diff| <= 1e-5 * max |ref| per tensor.  Both sides are
float32 sums of the same terms in another order (dx over 27 * C_out terms,
dW and db over the batch's voxels).  The 3xTF32 arithmetic of the card's
float32 dx (K3) and fused backward (K2) is emulated here and held to the
card's float32 limits (see their tests)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stroke_prediction_tpu.ops.pallas.s2d import (
    fold_bn_zsame as jax_fold_bn_zsame)
from stroke_prediction_tpu.ops.pallas import s2d
from stroke_prediction_tpu.ops.pallas.s2d import s2d_conv, s2d_pack, s2d_unpack
from stroke_prediction_tpu_torch.ops import conv3x3 as conv_mod
from stroke_prediction_tpu_torch.ops.conv3x3 import (
    Conv3x3Fn, bwd_route, conv3x3_bwd_dw, conv3x3_bwd_dx, conv3x3_bwd_fused)

torch.set_num_threads(1)

REL = 1e-5
# the card's float32 dx against its plain version (chip_smoke.py K1_TOL):
# float32 sums of up to 27 * 96 terms in another order
K1_TOL = dict(atol=1e-4, rtol=1e-4)
# the card's float32 dW and db against their plain version (chip_smoke.py
# DW_REL): float32 sums over the batch's voxels, relative to max|ref|
DW_REL = 1e-4
ALPHA = {"none": 0.01, "leaky_relu": 0.01, "elu": 0.7}


def _assert_close(got, ref, name):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, name
    err = np.abs(got - ref).max()
    assert err <= REL * np.abs(ref).max(), (name, err, np.abs(ref).max())


def _case(seed, mode, bias_kind, b=2, d=6, h=8, w=9, ci=3, co=4):
    rs = np.random.RandomState(seed)
    x = (rs.rand(b, d, h, w, ci) - 0.5).astype(np.float32)
    k = ((rs.rand(3, 3, 3, ci, co) - 0.5) * 0.6).astype(np.float32)
    bias = ((rs.rand(co) - 0.5) * 0.4).astype(np.float32)
    d_out = d if mode == "s" else d - 2
    if bias_kind == "plane_table":
        scale = (0.5 + rs.rand(ci)).astype(np.float32)
        shift = (rs.rand(ci) - 0.5).astype(np.float32)
        k, bias = (np.array(a) for a in jax_fold_bn_zsame(
            jnp.asarray(k), jnp.asarray(bias), jnp.asarray(scale),
            jnp.asarray(shift), d_out))
    g = (rs.rand(b, d_out, h - 2, w - 2, co) - 0.5).astype(np.float32)
    return x, k, bias, g


def _jax_grads(x, k, bias, g, mode, act, input_grad=True):
    """(y, dx, dk, db) of the s2d conv, cotangent g (interpret mode)."""
    def f(x, k, bias):
        s = s2d_pack(x, dtype=jnp.float32)
        return s2d_unpack(s2d_conv(s, k, bias, act=act, alpha=ALPHA[act],
                                   modes=(mode, "v", "v"),
                                   input_grad=input_grad))

    y, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias))
    return (np.asarray(y),) + tuple(np.asarray(a)
                                    for a in vjp(jnp.asarray(g)))


@pytest.mark.parametrize("bias_kind", ["vector", "plane_table"])
@pytest.mark.parametrize("act", ["none", "leaky_relu", "elu"])
@pytest.mark.parametrize("mode", ["v", "s"])
def test_conv3x3_backward_matches_s2d_vjp(mode, act, bias_kind):
    x, k, bias, g = _case(3, mode, bias_kind)
    _, rdx, rdk, rdb = _jax_grads(x, k, bias, g, mode, act)

    xt, kt, bt = (torch.from_numpy(a).requires_grad_() for a in (x, k, bias))
    before = [f.launches for f in conv_mod.KERNEL_WRAPPERS]
    y = Conv3x3Fn.apply(xt, kt, bt, act, ALPHA[act], mode)
    y.backward(torch.from_numpy(g))
    assert [f.launches for f in conv_mod.KERNEL_WRAPPERS] == before  # CPU
    for got, ref, name in ((xt.grad, rdx, "dx"), (kt.grad, rdk, "dk"),
                           (bt.grad, rdb, "db")):
        _assert_close(got.numpy(), ref, name)
    # 's' mode: the padded planes take no dx, the first and last input
    # planes only their in-range taps
    if mode == "s":
        _assert_close(xt.grad[:, [0, -1]].numpy(), rdx[:, [0, -1]],
                      "dx edge planes")

    # each wrapper on its own gives the same gradients
    yd, gt, kd = y.detach(), torch.from_numpy(g), torch.from_numpy(k)
    table = bias_kind == "plane_table"
    dx, dk, db = conv3x3_bwd_fused(torch.from_numpy(x), gt, yd, kd, act,
                                   ALPHA[act], mode, table)
    dx3 = conv3x3_bwd_dx(gt, yd, kd, x.shape, act, ALPHA[act], mode)
    dk4, db4 = conv3x3_bwd_dw(torch.from_numpy(x), gt, yd, act, ALPHA[act],
                              mode, table)
    for got, ref, name in ((dx, rdx, "fused dx"), (dk, rdk, "fused dk"),
                           (db, rdb, "fused db"), (dx3, rdx, "dx"),
                           (dk4, rdk, "dw dk"), (db4, rdb, "dw db")):
        _assert_close(got.numpy(), ref, name)


def _check_bfloat16_backward(mode, act, bias_kind, ci, co, dx_floor=0.0):
    """bfloat16 x, float32 parameters (the training default) against the
    s2d conv on ``s2d_pack(..., dtype=bfloat16)``.  Both sides form g' in
    bfloat16 (s2d.py:879-889) and sum it in float32, so dk and db agree to
    float32 reordering (1e-5 of max|ref|).  dx is rounded once to bfloat16
    from float32 sums taken in another order: at most 0.1% of its elements
    may land one bfloat16 step (2^-7 of the value) apart, plus
    ``dx_floor`` * max|ref| for values that float32 reordering alone can
    move by more than a step of their own (sums that nearly cancel)."""
    x, k, bias, g = _case(3, mode, bias_kind, d=6, h=10, w=11, ci=ci, co=co)
    bf = jnp.bfloat16

    def f(x, k, bias):
        s = s2d_pack(x, dtype=bf)
        return s2d_unpack(s2d_conv(s, k, bias, act=act, alpha=ALPHA[act],
                                   modes=(mode, "v", "v")))

    y_ref, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias))
    rdx, rdk, rdb = (np.asarray(a, np.float32)
                     for a in vjp(jnp.asarray(g).astype(bf)))

    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    kt, bt = (torch.from_numpy(a).requires_grad_() for a in (k, bias))
    y = Conv3x3Fn.apply(xt, kt, bt, act, ALPHA[act], mode)
    y.backward(torch.from_numpy(g).to(torch.bfloat16))
    assert xt.grad.dtype == torch.bfloat16
    assert kt.grad.dtype == bt.grad.dtype == torch.float32
    _assert_close(kt.grad.numpy(), rdk, "dk")
    _assert_close(bt.grad.numpy(), rdb, "db")
    dx = xt.grad.float().numpy()
    off = np.abs(dx - rdx)
    assert (off > 0).mean() <= 1e-3, ("dx elements off", (off > 0).mean())
    step = 2.0 ** -7 * np.abs(rdx) + dx_floor * np.abs(rdx).max()
    assert np.all(off <= step), ("dx off by more than one bf16 step",
                                 off.max())


@pytest.mark.parametrize("bias_kind", ["vector", "plane_table"])
@pytest.mark.parametrize("act", ["leaky_relu", "elu"])
@pytest.mark.parametrize("mode", ["v", "s"])
def test_conv3x3_backward_bfloat16_matches_s2d_vjp(mode, act, bias_kind):
    """At 16 -> 16 channels: the fused route (K2) on both sides."""
    _check_bfloat16_backward(mode, act, bias_kind, 16, 16)


@pytest.mark.parametrize("ci, co, mode, act, bias_kind", [
    (48, 16, "v", "leaky_relu", "vector"),       # L9's widths
    (32, 64, "s", "elu", "plane_table")])
def test_conv3x3_backward_bfloat16_split_widths_match_s2d_vjp(
        ci, co, mode, act, bias_kind, monkeypatch):
    """At widths the split route (K3 + K4) takes, against the JAX package
    forced onto its own split path (``_dx_kernel`` / ``_dw_kernel``): its
    fused / split choice reads ``_BWD_FUSED_VMEM_BUDGET`` at trace time,
    so the traces are dropped before and after.  dx: a sum at L9's widths
    cancels to 1e-6 of max|ref|, where the two sides' float32 orders differ
    by a few of its bfloat16 steps (6e-8 in absolute terms), so the step
    bound has a floor of the file's float32 reordering tolerance, REL *
    max|ref|."""
    assert bwd_route(ci, co) == "split"
    monkeypatch.setattr(s2d, "_BWD_FUSED_VMEM_BUDGET", 0)
    jax.clear_caches()
    try:
        _check_bfloat16_backward(mode, act, bias_kind, ci, co, dx_floor=REL)
    finally:
        jax.clear_caches()


def _tf32(a):
    """float32 rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: to
    nearest, ties away from zero, to a 10-bit mantissa (on the int32 view,
    ``(i + 0x1000) & ~0x1FFF``)."""
    i = np.ascontiguousarray(a, np.float32).view(np.int32)
    return ((i + 0x1000) & ~0x1FFF).astype(np.int32).view(np.float32)


@pytest.mark.parametrize("ci, co", [(96, 32), (32, 64), (48, 16), (64, 64)],
                         ids=["96-32", "32-64", "48-16", "64-64"])
def test_conv3x3_bwd_dx_3xtf32_split_matches_s2d_vjp(ci, co, monkeypatch):
    """The arithmetic of the card's float32 K3
    (``csrc/conv3x3_bwd_dx_f32_tc.cu``): g' = g * act'(y) formed in float32,
    g' and k each split into big = tf32(v) and small = tf32(v - big), and
    g' * k taken as small_g * big_k + big_g * small_k + big_g * big_k (the
    products exact, summed in float64 here).  That dx holds to dx of
    ``jax.vjp`` of the JAX package's float32 ``s2d_conv``, forced onto its
    split ``_dx_kernel`` (interpret mode), within the card's float32 limit
    ``K1_TOL``; one TF32 product (big_g * big_k) does not, so the limit
    tells the two designs apart."""
    assert bwd_route(ci, co) == "split"
    rs = np.random.RandomState(19)
    x = rs.uniform(-1.0, 1.0, (1, 5, 6, 6, ci)).astype(np.float32)
    # k at the scale of dx's fan-in (27 * C_out), so that dx is of order
    # one, where K1_TOL's atol is small against one TF32 product's error
    bnd = 2.0 * (27 * co) ** -0.5
    k = rs.uniform(-bnd, bnd, (3, 3, 3, ci, co)).astype(np.float32)
    bias = rs.uniform(-0.1, 0.1, co).astype(np.float32)
    g = rs.uniform(-1.0, 1.0, (1, 3, 4, 4, co)).astype(np.float32)
    monkeypatch.setattr(s2d, "_BWD_FUSED_VMEM_BUDGET", 0)
    jax.clear_caches()
    try:
        y, rdx, _, _ = _jax_grads(x, k, bias, g, "v", "leaky_relu")
    finally:
        jax.clear_caches()

    gp = conv_mod._masked_cotangent(torch.from_numpy(g), torch.tensor(y),
                                    "leaky_relu", 0.01).numpy()
    g_big, k_big = _tf32(gp), _tf32(k)
    g_small, k_small = _tf32(gp - g_big), _tf32(k - k_big)
    for v, big, small in ((gp, g_big, g_small), (k, k_big, k_small)):
        assert np.all(np.abs(v - big - small) <= 2.0 ** -22 * np.abs(v))

    def dx(*pairs):
        """The sum of the float64 input gradients of the (g', k) pairs
        (act 'none': the first factor is g' itself, and y only sets the
        type)."""
        return sum(conv_mod.conv3x3_bwd_dx_plain(
            torch.from_numpy(a).double(), torch.from_numpy(a).double(),
            torch.from_numpy(b).double(), x.shape, "none")
            for a, b in pairs).numpy()

    three = dx((g_small, k_big), (g_big, k_small), (g_big, k_big))
    one = dx((g_big, k_big))
    assert three.shape == rdx.shape
    np.testing.assert_allclose(three, rdx, **K1_TOL)
    assert not np.allclose(one, rdx, **K1_TOL), np.abs(one - rdx).max()


@pytest.mark.parametrize("ci, co, mode, act, bias_kind", [
    (16, 16, "v", "leaky_relu", "vector"),       # L2's and L10's widths
    (16, 32, "v", "leaky_relu", "vector"),       # L3's
    (32, 16, "v", "leaky_relu", "vector"),
    (8, 16, "s", "elu", "plane_table")],
    ids=["16-16", "16-32", "32-16", "8-16-s"])
def test_conv3x3_bwd_fused_3xtf32_matches_s2d_vjp(ci, co, mode, act,
                                                  bias_kind):
    """The arithmetic of the card's float32 K2
    (``csrc/conv3x3_bwd_f32_tc.cu``): g' = g * act'(y) formed in float32;
    g', k and x each split into big = tf32(v) and small = tf32(v - big);
    dx as g' * k and dk as x * g', each product taken as small_a * big_b +
    big_a * small_b + big_a * big_b (the products exact, summed in float64
    here); db the sum of big + small of g' (the CUDA cores' sum, no
    product).  That holds to ``jax.vjp`` of the JAX package's float32
    ``s2d_conv``, whose default budget runs the fused ``_bwd_kernel`` at
    these widths (interpret mode): dx within the card's float32 limit
    ``K1_TOL``, dk and db within ``DW_REL`` of max|ref|.  One TF32 product
    (big_a * big_b) fails both limits at every case (dx by 2-4e-4 past
    ``K1_TOL``, dk 2.6-3.3e-4 of max|ref|), so they tell the two designs
    apart; db has no product, so no such contrast."""
    assert bwd_route(ci, co) == "fused"
    table = bias_kind == "plane_table"
    rs = np.random.RandomState(23)
    x = rs.uniform(-1.0, 1.0, (1, 5, 6, 6, ci)).astype(np.float32)
    # k at the scale of dx's fan-in, so that dx is of order one (as in the
    # K3 test)
    bnd = 2.0 * (27 * co) ** -0.5
    k = rs.uniform(-bnd, bnd, (3, 3, 3, ci, co)).astype(np.float32)
    bias = rs.uniform(-0.1, 0.1, co).astype(np.float32)
    d_out = 5 if mode == "s" else 3
    if table:
        scale = rs.uniform(0.5, 1.5, ci).astype(np.float32)
        shift = rs.uniform(-0.5, 0.5, ci).astype(np.float32)
        k, bias = (np.array(a) for a in jax_fold_bn_zsame(
            jnp.asarray(k), jnp.asarray(bias), jnp.asarray(scale),
            jnp.asarray(shift), d_out))
    g = rs.uniform(-1.0, 1.0, (1, d_out, 4, 4, co)).astype(np.float32)
    y, rdx, rdk, rdb = _jax_grads(x, k, bias, g, mode, act)

    gp = conv_mod._masked_cotangent(torch.from_numpy(g), torch.tensor(y),
                                    act, ALPHA[act]).numpy()
    (g_big, g_small), (k_big, k_small), (x_big, x_small) = (
        (_tf32(v), _tf32(v - _tf32(v))) for v in (gp, k, x))

    def t64(a):
        return torch.from_numpy(np.ascontiguousarray(a)).double()

    def dx(*pairs):
        """The sum of the float64 input gradients of the (g', k) pairs
        (act 'none': the first factor is g' itself)."""
        return sum(conv_mod.conv3x3_bwd_dx_plain(
            t64(a), t64(a), t64(b), x.shape, "none", mode=mode)
            for a, b in pairs).numpy()

    def dk(*pairs):
        """The sum of the float64 kernel gradients of the (x, g') pairs."""
        return sum(conv_mod.conv3x3_bwd_dw_plain(
            t64(a), t64(b), t64(b), "none", mode=mode, bias_table=table)[0]
            for a, b in pairs).numpy()

    gsum = t64(g_big) + t64(g_small)
    db = (gsum.sum(dim=(0, 2, 3)) if table
          else gsum.sum(dim=(0, 1, 2, 3))).numpy()
    three_dx = dx((g_small, k_big), (g_big, k_small), (g_big, k_big))
    three_dk = dk((x_small, g_big), (x_big, g_small), (x_big, g_big))
    assert three_dx.shape == rdx.shape and three_dk.shape == rdk.shape
    assert db.shape == rdb.shape
    np.testing.assert_allclose(three_dx, rdx, **K1_TOL)
    for got, ref in ((three_dk, rdk), (db, rdb)):
        assert np.abs(got - ref).max() <= DW_REL * np.abs(ref).max()
    one_dx, one_dk = dx((g_big, k_big)), dk((x_big, g_big))
    assert not np.allclose(one_dx, rdx, **K1_TOL), np.abs(one_dx - rdx).max()
    assert np.abs(one_dk - rdk).max() > DW_REL * np.abs(rdk).max()


def _dw_gemm(x, gp, mode):
    """dk as the card's float32 K4 forms it, in float64: per tap (tz, ty)
    one GEMM of M rows (tx, C_in) in the packed row order m = tx * C_in + i
    (x[z + tz - p, h + ty, w + tx, i]) by N = C_out columns of g' over
    K = the output voxels."""
    p = conv_mod.MODES[mode]
    d_out, h_out, w_out, co = gp.shape[1:]
    ci = x.shape[-1]
    xz = np.pad(np.asarray(x, np.float64),
                ((0, 0), (p, p), (0, 0), (0, 0), (0, 0)))
    b_mat = np.asarray(gp, np.float64).reshape(-1, co)
    dk = np.zeros((3, 3, 3, ci, co))
    for tz in range(3):
        for ty in range(3):
            a_mat = np.stack([xz[:, tz:tz + d_out, ty:ty + h_out,
                                 tx:tx + w_out] for tx in range(3)], axis=-2)
            dk[tz, ty] = (a_mat.reshape(-1, 3 * ci).T @ b_mat).reshape(
                3, ci, co)
    return dk



@pytest.mark.parametrize("ci, co, mode, act, bias_kind, input_grad", [
    (2, 16, "v", "leaky_relu", "vector", False),  # L1: the entry conv
    (32, 32, "v", "leaky_relu", "vector", True),  # L4's and L8's widths
    (48, 16, "v", "leaky_relu", "vector", True),  # L9's
    (32, 64, "s", "elu", "plane_table", True),
    (3, 4, "v", "leaky_relu", "vector", True)],
    ids=["2-16-dw-only", "32-32", "48-16", "32-64-s", "3-4"])
def test_conv3x3_bwd_dw_3xtf32_matches_s2d_vjp(ci, co, mode, act, bias_kind,
                                               input_grad, monkeypatch):
    """The arithmetic of the card's float32 K4
    (``csrc/conv3x3_bwd_dw_f32_tc.cu``): g' = g * act'(y) formed in float32;
    x and g' each split into big = tf32(v) and small = tf32(v - big); dk
    as x * g' taken as small_x * big_g + big_x * small_g + big_x * big_g
    (the products exact, summed in float64 here), by the kernel's GEMM (M
    rows (tx, C_in), as the kernel packs them for C_in <= 5); db the sum of
    big + small of g'.  That holds to ``jax.vjp`` of the JAX package's
    float32 ``s2d_conv`` on its split ``_dw_kernel`` (the budget forced to
    0) or, for the entry conv, its dW-only path (``input_grad=False``), in
    interpret mode: dk and db within ``DW_REL`` of max|ref|.  One TF32
    product (big_x * big_g) fails dk's limit at every case, so the limit
    tells the two designs apart; db has no product, so no such contrast."""
    table = bias_kind == "plane_table"
    rs = np.random.RandomState(29)
    x = rs.uniform(-1.0, 1.0, (1, 5, 6, 6, ci)).astype(np.float32)
    bnd = (27 * ci) ** -0.5
    k = rs.uniform(-bnd, bnd, (3, 3, 3, ci, co)).astype(np.float32)
    bias = rs.uniform(-0.1, 0.1, co).astype(np.float32)
    d_out = 5 if mode == "s" else 3
    if table:
        scale = rs.uniform(0.5, 1.5, ci).astype(np.float32)
        shift = rs.uniform(-0.5, 0.5, ci).astype(np.float32)
        k, bias = (np.array(a) for a in jax_fold_bn_zsame(
            jnp.asarray(k), jnp.asarray(bias), jnp.asarray(scale),
            jnp.asarray(shift), d_out))
    g = rs.uniform(-1.0, 1.0, (1, d_out, 4, 4, co)).astype(np.float32)
    monkeypatch.setattr(s2d, "_BWD_FUSED_VMEM_BUDGET", 0)
    jax.clear_caches()
    try:
        y, _, rdk, rdb = _jax_grads(x, k, bias, g, mode, act,
                                    input_grad=input_grad)
    finally:
        jax.clear_caches()

    gp = conv_mod._masked_cotangent(torch.from_numpy(g), torch.tensor(y),
                                    act, ALPHA[act]).numpy()
    (g_big, g_small), (x_big, x_small) = (
        (_tf32(v), _tf32(v - _tf32(v))) for v in (gp, x))
    three = (_dw_gemm(x_small, g_big, mode) + _dw_gemm(x_big, g_small, mode)
             + _dw_gemm(x_big, g_big, mode))
    gsum = g_big.astype(np.float64) + g_small
    db = gsum.sum(axis=(0, 2, 3)) if table else gsum.sum(axis=(0, 1, 2, 3))
    assert three.shape == rdk.shape and db.shape == rdb.shape
    for got, ref in ((three, rdk), (db, rdb)):
        assert np.abs(got - ref).max() <= DW_REL * np.abs(ref).max()
    one = _dw_gemm(x_big, g_big, mode)
    assert np.abs(one - rdk).max() > DW_REL * np.abs(rdk).max()


@pytest.mark.parametrize("mode, dtype", [
    ("v", "float32"), ("s", "float32"), ("v", "bfloat16"), ("s", "bfloat16")],
    ids=["v", "s", "v-bfloat16", "s-bfloat16"])
def test_conv3x3_data_input_takes_dw_only(mode, dtype):
    """An input without grad (the entry conv on data) gives the kernel and
    bias gradients of JAX's ``input_grad=False`` conv and no dx.  bfloat16
    at the entry conv's widths (2 -> 16), against the s2d conv on
    ``s2d_pack(x, bfloat16)``: both sides form g' in bfloat16 and sum in
    float32, so dk and db agree to float32 reordering."""
    co = 16 if dtype == "bfloat16" else 5
    x, k, bias, g = _case(5, mode, "vector", ci=2, co=co)
    if dtype == "bfloat16":
        bf = jnp.bfloat16

        def f(k, bias):
            s = s2d_pack(jnp.asarray(x), dtype=bf)
            return s2d_unpack(s2d_conv(s, k, bias, act="leaky_relu",
                                       alpha=0.01, modes=(mode, "v", "v"),
                                       input_grad=False))

        _, vjp = jax.vjp(f, jnp.asarray(k), jnp.asarray(bias))
        rdk, rdb = (np.asarray(a, np.float32)
                    for a in vjp(jnp.asarray(g).astype(bf)))
    else:
        _, _, rdk, rdb = _jax_grads(x, k, bias, g, mode, "leaky_relu",
                                    input_grad=False)
    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(tdt)
    kt, bt = (torch.from_numpy(a).requires_grad_() for a in (k, bias))
    y = Conv3x3Fn.apply(xt, kt, bt, "leaky_relu", 0.01, mode)
    assert y.dtype == tdt
    y.backward(torch.from_numpy(g).to(tdt))
    assert xt.grad is None
    _assert_close(kt.grad.numpy(), rdk, "dk")
    _assert_close(bt.grad.numpy(), rdb, "db")


def test_conv3x3_leaky_relu_grad_at_zero_output():
    """At y == 0 exactly the JAX rule takes alpha (the test is y > 0)."""
    x = torch.zeros(1, 3, 3, 3, 1)
    k = torch.ones(3, 3, 3, 1, 1, requires_grad=True)
    b = torch.zeros(1, requires_grad=True)
    y = Conv3x3Fn.apply(x, k, b, "leaky_relu", 0.25, "v")
    assert float(y.detach()) == 0.0
    y.backward(torch.ones_like(y))
    assert float(b.grad) == pytest.approx(0.25)


def test_conv3x3_fn_gradcheck_float64():
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.rand(1, 4, 4, 5, 2)).requires_grad_()
    k = torch.from_numpy(rs.rand(3, 3, 3, 2, 3) - 0.5).requires_grad_()
    b = torch.from_numpy(rs.rand(3) - 0.5).requires_grad_()
    for act, mode in (("leaky_relu", "v"), ("elu", "s")):
        assert torch.autograd.gradcheck(
            lambda x, k, b: Conv3x3Fn.apply(x, k, b, act, 0.3, mode),
            (x, k, b))


def test_bwd_route_at_reference_width():
    """The fused / split rule on the reference U-Net's ten convs (channels
    2 16 32 64 32 16 32 2): K4 alone on the entry conv, K2 on L2, L3, L10,
    K3 + K4 on L4-L9."""
    layers = [(2, 16), (16, 16), (16, 32), (32, 32), (32, 64), (64, 64),
              (96, 32), (32, 32), (48, 16), (16, 16)]
    routes = [bwd_route(ci, co, i > 0) for i, (ci, co) in enumerate(layers)]
    assert routes == ["dw", "fused", "fused", "split", "split", "split",
                      "split", "split", "split", "fused"]


@pytest.mark.parametrize("c_in, c_out, route", [
    (3, 4, "fused"), (1, 32, "fused"), (17, 16, "fused"), (16, 17, "fused"),
    (17, 17, "split"), (3, 40, "split"), (33, 1, "split")])
def test_bwd_route_counts_channels_padded_to_16(c_in, c_out, route):
    """The fused route takes the shapes whose dW block, channels padded to
    16, is at most 64 KB: (16, 16), (16, 32) or (32, 16) after padding,
    the bfloat16 K2's bound."""
    assert bwd_route(c_in, c_out) == route


@pytest.mark.parametrize("bad", ["g_shape", "y_shape", "kernel_shape",
                                 "act", "mode"])
def test_conv3x3_bwd_rejects_bad_arguments(bad):
    x = torch.zeros(1, 5, 5, 5, 2)
    k = torch.zeros(3, 3, 3, 2, 4)
    g = y = torch.zeros(1, 3, 3, 3, 4)
    kw = dict(act="none", mode="v")
    if bad == "g_shape":
        g = torch.zeros(1, 3, 3, 3, 5)
    elif bad == "y_shape":
        y = torch.zeros(1, 4, 3, 3, 4)
    elif bad == "kernel_shape":
        k = torch.zeros(3, 3, 3, 3, 4)
    elif bad == "act":
        kw["act"] = "relu"
    else:
        kw["mode"] = "x"
    with pytest.raises(ValueError):
        conv3x3_bwd_fused(x, g, y, k, **kw)
    with pytest.raises(ValueError):
        conv3x3_bwd_dx(g, y, k, x.shape, **kw)
    if bad != "kernel_shape":
        with pytest.raises(ValueError):
            conv3x3_bwd_dw(x, g, y, **kw)
