"""Port parity: the gradient of ``max_pool3d`` (ops/pooling.py) against the
JAX package's equality-mask backward on inputs with tied maxima, where every
tied maximum takes the window's full gradient (``torch.amax``'s own backward
would split it evenly).  Exact: the gradient is a selection, no arithmetic."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stroke_prediction_tpu.ops import pooling as jax_pooling
from stroke_prediction_tpu_torch.ops import pooling

torch.set_num_threads(1)


def _tied(shape, seed):
    """Values on a coarse grid of 3 levels: most windows hold ties."""
    rs = np.random.RandomState(seed)
    return rs.randint(0, 3, size=shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(1, 4, 6, 8, 2), (2, 5, 7, 6, 3)])
def test_max_pool3d_grad_with_ties_matches_jax(shape):
    x = _tied(shape, 0)
    rs = np.random.RandomState(1)
    y_shape = shape[:1] + tuple(v // 2 for v in shape[1:4]) + shape[4:]
    g = rs.rand(*y_shape).astype(np.float32)
    _, vjp = jax.vjp(jax_pooling.max_pool3d, jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])

    xt = torch.from_numpy(x).requires_grad_()
    pooling.max_pool3d(xt).backward(torch.from_numpy(g))
    got = xt.grad.numpy()
    assert (want > 0).sum() > np.prod(y_shape)     # ties are present
    np.testing.assert_array_equal(got, want)
    # floor-cropped tails take no gradient
    for ax in (1, 2, 3):
        if shape[ax] % 2:
            tail = np.take(got, [shape[ax] - 1], axis=ax)
            assert not tail.any()


def test_max_pool3d_grad_bfloat16_ties():
    x = _tied((1, 4, 4, 4, 2), 2)
    g = np.random.RandomState(3).rand(1, 2, 2, 2, 2).astype(np.float32)
    _, vjp = jax.vjp(jax_pooling.max_pool3d, jnp.asarray(x, jnp.bfloat16))
    want = np.asarray(vjp(jnp.asarray(g, jnp.bfloat16))[0], np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    y = pooling.max_pool3d(xt)
    assert y.dtype == torch.bfloat16
    y.backward(torch.from_numpy(g).to(torch.bfloat16))
    assert xt.grad.dtype == torch.bfloat16
    np.testing.assert_array_equal(xt.grad.float().numpy(), want)
