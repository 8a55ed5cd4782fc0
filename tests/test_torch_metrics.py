"""Port parity: binary measures and the Dice loss (eval/metrics.py) against
the JAX package.  Counts are exact, so Dice / precision / sensitivity /
specificity agree to 1e-6; HD and ASSD (sums of float32 distances in
another order) to 1e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stroke_prediction_tpu.eval import metrics as jax_metrics
from stroke_prediction_tpu_torch.eval import metrics

torch.set_num_threads(1)

FIELDS = ("dc", "precision", "sensitivity", "specificity")


def _blob(shape, center, r, rs, noise=0.25):
    grids = np.ogrid[tuple(slice(0, s) for s in shape)]
    d2 = sum((g - c) ** 2 for g, c in zip(grids, center))
    return np.clip((d2 <= r * r) + noise * rs.randn(*shape), 0, 1).astype(
        np.float32)


def _pair(seed, spatial=(10, 12, 14)):
    rs = np.random.RandomState(seed)
    a = _blob(spatial, (5, 6, 7), 4, rs)
    b = _blob(spatial, (4, 6, 8), 3.5, rs)
    return a, b


def _assert_match(got, want):
    for f in FIELDS:
        assert float(getattr(got, f)) == pytest.approx(
            float(getattr(want, f)), abs=1e-6), f
    for f in ("hd", "assd"):
        g, w = float(getattr(got, f)), float(getattr(want, f))
        if np.isinf(w):
            assert np.isinf(g), f
        else:
            assert g == pytest.approx(w, abs=1e-4), f


@pytest.mark.parametrize("layout", ["dhw", "dhwc", "bdhwc"])
def test_binary_measures_matches_jax(layout):
    a, b = _pair(0)
    if layout == "dhwc":
        a, b = a[..., None], b[..., None]
    elif layout == "bdhwc":
        a2, b2 = _pair(1)
        a = np.stack([a, a2])[..., None]
        b = np.stack([b, b2])[..., None]
    got = metrics.binary_measures(torch.from_numpy(a), torch.from_numpy(b))
    want = jax_metrics.binary_measures(jnp.asarray(a), jnp.asarray(b))
    _assert_match(got, want)
    assert 0 < float(got.hd) < 20


@pytest.mark.parametrize("empty", ["result", "target", "both"])
def test_binary_measures_empty_mask_gives_inf(empty):
    a, b = _pair(2)
    if empty in ("result", "both"):
        a = np.zeros_like(a)
    if empty in ("target", "both"):
        b = np.zeros_like(b)
    got = metrics.binary_measures_host(a, b)
    want = jax_metrics.binary_measures_host(a, b)
    _assert_match(got, want)
    assert np.isinf(got.hd) and np.isinf(got.assd)


def test_binary_measures_host_returns_floats():
    a, b = _pair(3)
    got = metrics.binary_measures_host(a, b)
    assert all(isinstance(getattr(got, f), float) for f in FIELDS)
    assert got.prc_euclidean_distance == pytest.approx(
        np.sqrt((1 - got.precision) ** 2 + (1 - got.sensitivity) ** 2))


def test_surface6_matches_jax():
    a, _ = _pair(4)
    m = a > 0.5
    got = metrics._surface6(torch.from_numpy(m)[None])[0].numpy()
    want = np.asarray(jax_metrics._surface6(jnp.asarray(m)))
    np.testing.assert_array_equal(got, want)


def test_surface6_of_a_transposed_mask_is_contiguous_and_matches_jax():
    """The tester's labels arrive with D fastest; the surface mask the EDT
    reads must still be contiguous (its kernels read it in place)."""
    a, _ = _pair(6)
    m = a > 0.5
    transposed = torch.from_numpy(np.ascontiguousarray(m.transpose(2, 1, 0))
                                  ).permute(2, 1, 0)[None]
    assert not transposed.is_contiguous()
    got = metrics._surface6(transposed)
    assert got.is_contiguous()
    want = np.asarray(jax_metrics._surface6(jnp.asarray(m)))
    np.testing.assert_array_equal(got[0].numpy(), want)


def test_batch_dice_loss_matches_jax():
    rs = np.random.RandomState(5)
    out = rs.rand(2, 4, 5, 6, 2).astype(np.float32)
    tgt = (rs.rand(2, 4, 5, 6, 2) > 0.5).astype(np.float32)
    got = metrics.batch_dice_loss(torch.from_numpy(out), torch.from_numpy(tgt),
                                  (0.3, 0.7))
    want = jax_metrics.batch_dice_loss(jnp.asarray(out), jnp.asarray(tgt),
                                       (0.3, 0.7))
    assert float(got) == pytest.approx(float(want), abs=1e-6)
