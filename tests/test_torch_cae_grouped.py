"""Port parity for grouped BN and structure batching
(``STROKE_TPU_CAE_BATCH=1``): ``BatchNorm(x, groups)`` and
``BnConvActBlock(x, groups)`` against the JAX package's grouped layers on
its lax path, run in float64 (``_Float64Numpy`` in place of the layers
module's ``jnp``), and the port's CAE step with the switch on against the
port's step with it off.

Limits: float64, 1e-12 (outputs, affine, running statistics; a gradient
1e-12 of its tensor's max|ref|).  The grouped moments are per group, so
G calls of one group each give the same function: the grouped BN is held
to those chained calls of the port's own ungrouped BN too.  The grouped
block's entry conv (C_in 1, data input) applies the per-group affine to
its input, so BN's scale and bias reach the loss through the conv's dx:
their gradients must be non-zero and equal JAX's lax path (the JAX s2d
path gives them zero; ``ROADMAP.md`` §3)."""

import contextlib
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stroke_prediction_tpu.models import layers as jax_layers
from stroke_prediction_tpu_torch.inference import cae_dto_from_batch
from stroke_prediction_tpu_torch.models import layers
from stroke_prediction_tpu_torch.models.cae3d import (
    Cae3D, Dec3D, Enc3D, structure_batching)
from stroke_prediction_tpu_torch.ops import conv3x3
from stroke_prediction_tpu_torch.train.cae_learners import cae_loss

from test_torch_cae_train_step import CHANNELS, _batch
from test_torch_train import _Float64Numpy

torch.set_num_threads(1)

TOL = 1e-12
SWITCH = "STROKE_TPU_CAE_BATCH"
# name -> (C_in, C_out, port keyword arguments); the JAX block takes the
# same strides and padding
BLOCKS = {
    "zsame": (3, 5, {"padding": (1, 0, 0)}),
    "valid": (3, 5, {}),
    "stride2": (3, 5, {"strides": (2, 2, 2), "padding": (1, 1, 1)}),
    "entry": (1, 4, {"padding": (1, 0, 0)}),
}


@contextlib.contextmanager
def _jax64():
    """The JAX layers in float64 (x64 on, ``jnp.float32`` read as float64)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_layers, "jnp", _Float64Numpy())
        jax.config.update("jax_enable_x64", True)
        try:
            yield
        finally:
            jax.config.update("jax_enable_x64", False)


def _close(got, want, what, rel=False):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = np.abs(want).max() if rel else 1.0
    err = np.abs(got - want).max()
    assert err <= TOL * max(scale, 1e-300), (what, err, scale)


def _bn_inputs(groups, rs):
    x = rs.standard_normal((2 * groups, 3, 4, 5, 3)) * 1.5 + 0.7
    w = rs.standard_normal(x.shape)
    scale, bias = rs.rand(3) + 0.5, rs.standard_normal(3)
    mean, var = rs.standard_normal(3) * 0.1, rs.rand(3) + 0.5
    return x, w, scale, bias, mean, var


def _port_bn(scale, bias, mean, var):
    bn = layers.BatchNorm(3).double().train()
    with torch.no_grad():
        for name, v in (("scale", scale), ("bias", bias), ("mean", mean),
                        ("var", var)):
            getattr(bn, name).copy_(torch.from_numpy(v))
    return bn


def _port_bn_step(bn, x, w, groups, chained=False):
    """(output, d x, d scale, d bias, running mean, running var) of
    ``sum(bn(x) * w)``: one grouped call, or ``groups`` calls of one group
    each (``chained``)."""
    xt = torch.from_numpy(x).requires_grad_(True)
    if chained:
        y = torch.cat([bn(part) for part in xt.chunk(groups)])
    else:
        y = bn(xt, groups)
    (y * torch.from_numpy(w)).sum().backward()
    return tuple(t.detach().numpy() for t in (
        y, xt.grad, bn.scale.grad, bn.bias.grad, bn.mean, bn.var))


@pytest.mark.parametrize("groups", [2, 3, 4])
def test_grouped_batchnorm_matches_jax(groups):
    """Per-group moments (through the affine), the (G, C) affine, the
    output, the chained running statistics and the gradients to x, scale
    and bias, against JAX's ``BatchNorm(groups=G)`` and against G chained
    calls of the port's ungrouped BN."""
    x, w, scale, bias, mean, var = _bn_inputs(groups, np.random.RandomState(
        groups))
    variables = {"params": {"BatchNorm_0": {"scale": scale, "bias": bias}},
                 "batch_stats": {"BatchNorm_0": {"mean": mean, "var": var}}}
    with _jax64():
        ref = jax_layers.BatchNorm(compute_dtype=jnp.float64)

        def loss(x_, params):
            y, mut = ref.apply({**variables, "params": params}, x_, False,
                               groups=groups, mutable=["batch_stats"])
            return jnp.sum(y * w), (y, mut["batch_stats"]["BatchNorm_0"])

        (_, (y_ref, stats)), (dx_ref, dp_ref) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(jnp.asarray(x),
                                                variables["params"])
        (s_ref, t_ref), _ = ref.apply(variables, jnp.asarray(x), False,
                                      fold=True, groups=groups,
                                      mutable=["batch_stats"])

    bn = _port_bn(scale, bias, mean, var)
    with torch.no_grad():
        s, t = copy.deepcopy(bn).affine(torch.from_numpy(x), groups)
    assert s.shape == t.shape == (groups, 3)
    _close(s, s_ref, "scale'")
    _close(t, t_ref, "shift'")
    got = _port_bn_step(bn, x, w, groups)
    want = (y_ref, dx_ref, dp_ref["BatchNorm_0"]["scale"],
            dp_ref["BatchNorm_0"]["bias"], stats["mean"], stats["var"])
    names = ("y", "dx", "dscale", "dbias", "mean", "var")
    for name, g, r in zip(names, got, want):
        _close(g, r, name, rel=name.startswith("d"))
    chained = _port_bn_step(_port_bn(scale, bias, mean, var), x, w, groups,
                            chained=True)
    for name, g, r in zip(names, got, chained):
        _close(g, r, f"chained {name}", rel=name.startswith("d"))


def test_grouped_batchnorm_refuses_uneven_groups():
    bn = layers.BatchNorm(3).train()
    with pytest.raises(ValueError, match="3 groups"):
        bn(torch.zeros(4, 3, 3, 3, 3), 3)


def _block_variables(c_in, c_out, rs):
    return {"params": {
        "BatchNorm_0": {"BatchNorm_0": {
            "scale": rs.rand(c_in) + 0.5, "bias": rs.standard_normal(c_in)}},
        "Conv3d_0": {"kernel": rs.standard_normal((3, 3, 3, c_in, c_out))
                     * 0.3, "bias": rs.standard_normal(c_out) * 0.1}},
        "batch_stats": {"BatchNorm_0": {"BatchNorm_0": {
            "mean": np.zeros(c_in), "var": np.ones(c_in)}}}}


@pytest.mark.parametrize("name", list(BLOCKS))
def test_grouped_block_matches_jax(name):
    """A grouped BN -> 3^3 conv -> ELU block (G = 3) against JAX's grouped
    ``BnConvActBlock`` on its lax path: the output, the gradients to the
    input (but at the entry, whose input is data), the kernel, the bias
    and BN's scale and bias, and the running statistics.  The entry block
    casts to ``conv_dtype`` after its moments; its BN's gradients are
    non-zero."""
    c_in, c_out, kw = BLOCKS[name]
    groups, entry = 3, name == "entry"
    rs = np.random.RandomState(len(name))
    x = rs.rand(2 * groups, 6, 9, 9, c_in) if entry else (
        rs.standard_normal((2 * groups, 6, 9, 9, c_in)))
    variables = _block_variables(c_in, c_out, rs)
    block = layers.BnConvActBlock(c_in, c_out, act="elu", act_param=1.0,
                                  **kw).double().train()
    if entry:
        block.conv_dtype = torch.float64
    p, st = variables["params"], variables["batch_stats"]
    bnp = p["BatchNorm_0"]["BatchNorm_0"]
    state = {"bn.scale": bnp["scale"], "bn.bias": bnp["bias"],
             "bn.mean": st["BatchNorm_0"]["BatchNorm_0"]["mean"],
             "bn.var": st["BatchNorm_0"]["BatchNorm_0"]["var"],
             "conv.kernel": p["Conv3d_0"]["kernel"],
             "conv.bias": p["Conv3d_0"]["bias"]}
    block.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    xt = torch.from_numpy(x).requires_grad_(not entry)
    y = block(xt, groups)
    w = rs.standard_normal(tuple(y.shape))
    (y * torch.from_numpy(w)).sum().backward()

    with _jax64():
        ref = jax_layers.BnConvActBlock(
            c_out, act="elu", act_param=1.0, compute_dtype=jnp.float64,
            input_grad=not entry, **kw)

        def loss(x_, params):
            out, mut = ref.apply({"params": params, "batch_stats": st}, x_,
                                 True, groups, mutable=["batch_stats"])
            return jnp.sum(out * w), (out, mut["batch_stats"])

        (_, (y_ref, stats)), (dx_ref, dp_ref) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(jnp.asarray(x), p)
    _close(y.detach(), y_ref, "y")
    if not entry:
        _close(xt.grad, dx_ref, "dx", rel=True)
    dbn = dp_ref["BatchNorm_0"]["BatchNorm_0"]
    for key, ref_grad in (("bn.scale", dbn["scale"]), ("bn.bias", dbn["bias"]),
                          ("conv.kernel", dp_ref["Conv3d_0"]["kernel"]),
                          ("conv.bias", dp_ref["Conv3d_0"]["bias"])):
        got = dict(block.named_parameters())[key].grad
        _close(got, ref_grad, f"d {key}", rel=True)
        if key.startswith("bn."):
            assert float(got.abs().max()) > 0, key
    bst = stats["BatchNorm_0"]["BatchNorm_0"]
    _close(block.bn.mean, bst["mean"], "mean")
    _close(block.bn.var, bst["var"], "var")


def _count_kernel_calls(monkeypatch):
    """Count the calls of the four conv wrappers (their plain versions run
    on the CPU) -> the live counts, by wrapper name."""
    counts = {}
    for fn in conv3x3.KERNEL_WRAPPERS:
        def counted(*args, _fn=fn, **kw):
            counts[_fn.__name__] = counts.get(_fn.__name__, 0) + 1
            return _fn(*args, **kw)
        monkeypatch.setattr(conv3x3, fn.__name__, counted)
    return counts


def _cae_step(model, labels, clinical, factor):
    """One training-mode forward over the gtruth branch, ``cae_loss`` and
    backward -> (reconstructions, gradients, buffers)."""
    model.train()
    dto = model(cae_dto_from_batch(None, labels, clinical))
    cae_loss(dto, factor).backward()
    rec = dto.reconstructions.gtruth
    return ({f: getattr(rec, f).detach() for f in
             ("core", "penu", "lesion", "interpolation")},
            {k: p.grad for k, p in model.named_parameters()},
            {k: b.clone() for k, b in model.named_buffers()})


def test_structure_batching_equals_sequential_passes(monkeypatch):
    """The port with the switch on equals the port with it off (float64,
    one phase-1 step at factor 0.4, batch 1): the reconstructions, every
    gradient (the entry BN's non-zero) and the running statistics, which
    chain in stacking order as the sequential passes chain them in call
    order.  Launches: 3 + 4 passes of K1, the folded entry conv's backward
    K4 alone, against one encode and one decode, the entry's backward the
    fused K2 (dx for the grouped affine)."""
    labels, clinical = _batch()
    labels = torch.from_numpy(labels[:1]).double()
    clinical = torch.from_numpy(clinical[:1]).double()
    gen = torch.Generator().manual_seed(3)
    base = Cae3D(Enc3D(CHANNELS, 5, generator=gen,
                       compute_dtype=torch.float64),
                 Dec3D(CHANNELS, 5, generator=gen,
                       compute_dtype=torch.float64)).double()
    runs = {}
    for switch in ("0", "1"):
        monkeypatch.setenv(SWITCH, switch)
        assert structure_batching() == (switch == "1")
        with monkeypatch.context() as mp:
            counts = _count_kernel_calls(mp)
            runs[switch] = _cae_step(copy.deepcopy(base), labels, clinical,
                                     0.4)
        runs[switch] += (counts,)
    (rec0, grads0, bufs0, counts0), (rec1, grads1, bufs1, counts1) = (
        runs["0"], runs["1"])
    for key in rec0:
        _close(rec1[key], rec0[key], key)
    for key in grads0:
        _close(grads1[key], grads0[key], key, rel=True)
    for key in bufs0:
        _close(bufs1[key], bufs0[key], key)
    for key in ("enc.encoder.blocks.0.bn.scale",
                "enc.encoder.blocks.0.bn.bias"):
        assert float(grads1[key].abs().max()) > 0, key
    # CHANNELS are all <= 16 wide: every backward with dx takes K2
    assert counts0 == {"conv3x3": 45, "conv3x3_bwd_fused": 42,
                       "conv3x3_bwd_dw": 3}
    assert counts1 == {"conv3x3": 13, "conv3x3_bwd_fused": 13}


def test_stacked_passes_split_back_by_rows(monkeypatch):
    """In evaluation the stacked pass takes structures of different
    batches (the curve sweep's one-row core and penumbra beside its
    interpolations) and splits them back by their rows; in training a
    grouped pass refuses them."""
    monkeypatch.setenv(SWITCH, "1")
    gen = torch.Generator().manual_seed(4)
    dec = Dec3D(CHANNELS, 5, generator=gen, compute_dtype=torch.float64)
    dec.double().eval()
    rs = np.random.RandomState(0)
    zs = [torch.from_numpy(rs.standard_normal((n, 1, 3, 3, CHANNELS[5])))
          for n in (1, 1, 3)]
    with torch.no_grad():
        stacked = dec._decode_many([zs[0], None, zs[1], zs[2]])
        monkeypatch.setenv(SWITCH, "0")
        serial = dec._decode_many([zs[0], None, zs[1], zs[2]])
    assert stacked[1] is None and serial[1] is None
    for got, want in zip(stacked[::2] + stacked[3:], serial[::2] +
                         serial[3:]):
        _close(got, want, "reconstruction")
    monkeypatch.setenv(SWITCH, "1")
    dec.train()
    with pytest.raises(ValueError, match="equal batches"):
        dec._decode_many(zs)
