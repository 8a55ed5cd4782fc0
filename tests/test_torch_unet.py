"""Port parity: the U-Net (models/unet3d.py) with weights carried across
from the JAX model by models/convert.py, and the plain ops it is built from
(upsample, crop, pool, zoom), against the JAX package on the CPU (lax path).

Probabilities agree to 1e-5: float32 on both sides, BN folded into the conv
on the port versus applied before it in JAX."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stroke_prediction_tpu.models.unet3d import Unet3D as JaxUnet3D
from stroke_prediction_tpu.models.unet3d import (
    unet_output_spatial as jax_unet_output_spatial)
from stroke_prediction_tpu.ops import pooling as jax_pooling
from stroke_prediction_tpu.ops import resize as jax_resize
from stroke_prediction_tpu_torch.models.convert import (
    unet_state_from_jax, unet_state_to_jax)
from stroke_prediction_tpu_torch.models.unet3d import (
    Unet3D, unet_output_spatial)
from stroke_prediction_tpu_torch.ops import pooling, resize

torch.set_num_threads(1)

CHANNELS = (2, 4, 6, 8, 6, 4, 6, 2)


@pytest.mark.parametrize("spatial,out", [
    ((68, 104, 104), (28, 64, 64)),
    ((68, 168, 168), (28, 128, 128)),
    ((44, 44, 44), (4, 4, 4)),
])
def test_unet_output_spatial_goldens(spatial, out):
    assert unet_output_spatial(spatial) == out
    assert jax_unet_output_spatial(spatial) == out


def _random_variables(tree, rs, path=()):
    """Random flax variables of the given shapes: torch-style uniform conv
    weights and non-trivial BN parameters and running statistics (init has
    scale 1, bias 0, mean 0, var 1, which would hide a wrong fold)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _random_variables(v, rs, path + (k,))
        elif k == "var":
            out[k] = rs.uniform(0.5, 1.5, v.shape)
        elif k == "scale":
            out[k] = rs.uniform(0.7, 1.3, v.shape)
        elif "BatchNorm_0" in path:                      # mean, bias
            out[k] = rs.uniform(-0.3, 0.3, v.shape)
        else:                                            # conv kernel, bias
            bound = 1.0 / np.sqrt(np.prod(tree["kernel"].shape[:-1]))
            out[k] = rs.uniform(-bound, bound, v.shape)
        if not isinstance(v, dict):
            out[k] = out[k].astype(np.float32)
    return out


@pytest.fixture(scope="module")
def jax_unet():
    model = JaxUnet3D(channels=CHANNELS)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 44, 44, 44, 2)), train=False))
    return model, _random_variables(shapes, np.random.RandomState(0))


def test_unet3d_matches_jax(jax_unet):
    model, variables = jax_unet
    x = np.random.RandomState(1).rand(1, 46, 45, 44, 2).astype(np.float32)
    want = np.asarray(model.apply(variables, jnp.asarray(x), train=False))

    port = Unet3D(CHANNELS).eval()
    port.load_state_dict(unet_state_from_jax(variables))
    with torch.inference_mode():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1,) + unet_output_spatial(
        x.shape[1:4]) + (2,)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_state_dict_round_trip(jax_unet):
    _, variables = jax_unet
    sd = unet_state_from_jax(variables)
    assert set(sd) == set(Unet3D(CHANNELS).state_dict())
    back = unet_state_to_jax(sd)
    flat_a = jax.tree_util.tree_leaves_with_path(variables)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)


def test_unet3d_refuses_training_mode():
    with pytest.raises(NotImplementedError):
        Unet3D(CHANNELS)(torch.zeros(1, 44, 44, 44, 2))


def test_unet3d_seeded_init_is_reproducible():
    a = Unet3D(CHANNELS, generator=torch.Generator().manual_seed(3))
    b = Unet3D(CHANNELS, generator=torch.Generator().manual_seed(3))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    k = a.blocks[0].layers[0].conv.kernel.detach()
    bound = 1.0 / np.sqrt(27 * 2)
    assert float(k.abs().max()) <= bound and float(k.std()) > 0.2 * bound


def _x(shape, seed=0):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def test_upsample2x_trilinear_matches_jax():
    x = _x((2, 3, 4, 5, 3))
    got = resize.upsample2x_trilinear(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_resize.upsample2x_trilinear(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_center_crop_matches_jax():
    x = _x((1, 9, 10, 11, 2))
    got = resize.center_crop(torch.from_numpy(x), (4, 7, 6)).numpy()
    want = np.asarray(jax_resize.center_crop(jnp.asarray(x), (4, 7, 6)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(1, 6, 8, 10, 3), (2, 7, 9, 5, 2)])
def test_max_pool3d_matches_jax(shape):
    x = _x(shape)
    got = pooling.max_pool3d(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_pooling.max_pool3d(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("factor,order", [(0.5, 1), (0.5, 0), (2.0, 1)])
def test_zoom_inplane_matches_jax(factor, order):
    x = _x((1, 3, 10, 12, 2))
    got = resize.zoom_inplane(torch.from_numpy(x), factor, order).numpy()
    want = np.asarray(jax_resize.zoom_inplane(jnp.asarray(x), factor, order))
    np.testing.assert_allclose(got, want, atol=1e-6)
    # the numpy (X, Y, Z) form used by the data and NIfTI layers
    xyz = x[0, :, :, :, 0].transpose(2, 1, 0)
    got_np = resize.zoom_inplane_xyz(xyz, factor, order)
    np.testing.assert_allclose(got_np, want[0, :, :, :, 0].transpose(2, 1, 0),
                               atol=1e-6)
