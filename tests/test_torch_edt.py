"""Port parity: the EDT parabola pass (K5, ops/edt.py) and the distance
transforms built on it, against the JAX package (Pallas kernel in interpret
mode, and the XLA formulation) and scipy.

Squared distances are exact float32 integers, so the parabola passes must
agree exactly; distances are held at atol 1e-4 as tests/test_ops.py holds
the JAX ones."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import distance_transform_edt as scipy_edt

from stroke_prediction_tpu.ops import edt as jax_edt
from stroke_prediction_tpu_torch.ops import edt

torch.set_num_threads(1)


def _f2(seed, shape, with_big_lines=True):
    """Integer squared distances, some lines without a site (_BIG)."""
    rs = np.random.RandomState(seed)
    f2 = rs.randint(0, 60, size=shape).astype(np.float32) ** 2
    if with_big_lines:
        f2[0] = edt._BIG
        f2[..., 1, :] = edt._BIG
    return np.minimum(f2, np.float32(edt._BIG))


@pytest.mark.parametrize("axis", [1, 2])
def test_parabola_pass_matches_jax_pallas_and_xla(axis):
    f2 = _f2(0, (3, 21, 37))
    before = edt.edt_parabola.launches
    got = edt.parabola_pass(torch.from_numpy(f2), axis).numpy()
    assert edt.edt_parabola.launches == before          # CPU: plain path
    pallas = np.asarray(jax_edt._parabola_pass_pallas(jnp.asarray(f2), axis,
                                                      block=16))
    xla = np.asarray(jax_edt._parabola_pass_xla(jnp.asarray(f2), axis))
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, xla)


def test_parabola_plain_chunking_is_exact():
    lines = torch.from_numpy(_f2(1, (130, 19)))
    np.testing.assert_array_equal(edt.edt_parabola_plain(lines, chunk=7),
                                  edt.edt_parabola_plain(lines, chunk=200))


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_nearest_site_dist1d_matches_jax(axis):
    rs = np.random.RandomState(2)
    sites = rs.rand(6, 7, 8) > 0.85
    sites[:, 0, :] = False        # lines without a site along axes 0 and 2
    got = edt._nearest_site_dist1d(torch.from_numpy(sites), axis).numpy()
    want = np.asarray(jax_edt._nearest_site_dist1d(jnp.asarray(sites), axis))
    np.testing.assert_array_equal(got, want)


def _ball(n=14, r2=16, c=7):
    z, y, x = np.ogrid[:n, :n, :n]
    return (((z - c) ** 2 + (y - c) ** 2 + (x - c) ** 2) <= r2).astype(
        np.float32)


def test_distance_transform_edt_matches_jax_and_scipy():
    rs = np.random.RandomState(3)
    vol = _ball() * (rs.rand(14, 14, 14) > 0.1)
    got = edt.distance_transform_edt(torch.from_numpy(vol)).numpy()
    np.testing.assert_allclose(got, scipy_edt(vol), atol=1e-4)
    np.testing.assert_allclose(
        got, np.asarray(jax_edt.distance_transform_edt(jnp.asarray(vol))),
        atol=1e-4)


def test_edt_to_sites_matches_jax_and_scipy():
    rs = np.random.RandomState(4)
    sites = rs.rand(9, 12, 15) > 0.97
    got = edt.edt_to_sites(torch.from_numpy(sites)).numpy()
    np.testing.assert_allclose(got, scipy_edt(~sites), atol=1e-4)
    np.testing.assert_allclose(
        got, np.asarray(jax_edt.edt_to_sites(jnp.asarray(sites))), atol=1e-4)


def test_edt_to_sites_batched_axes_equal_per_volume():
    rs = np.random.RandomState(5)
    sites = rs.rand(3, 6, 8, 9) > 0.9
    sites[1] = False                       # a volume without any site
    batched = edt.edt_to_sites(torch.from_numpy(sites), axes=(1, 2, 3))
    for i in range(3):
        single = edt.edt_to_sites(torch.from_numpy(sites[i]))
        np.testing.assert_array_equal(batched[i].numpy(), single.numpy())
    want = np.asarray(jax_edt.edt_to_sites(jnp.asarray(sites[1])))
    np.testing.assert_array_equal(batched[1].numpy(), want)
    assert np.all(batched[1].numpy() == np.float32(np.sqrt(np.float32(1e12))))


def test_signed_edt_matches_jax():
    vol = _ball(12, 9, 6)
    got = edt.signed_edt(torch.from_numpy(vol)).numpy()
    want = np.asarray(jax_edt.signed_edt(jnp.asarray(vol)))
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert got[6, 6, 6] > 0 and got[0, 0, 0] < 0


# Site masks (N, D, H, W) for the whole-transform tests: odd sizes, an axis
# of length 1, lines and planes without a site, a volume without any site.
_SITE_CASES = ("odd-5x7x33", "d1", "h1", "w1", "empty-columns",
               "empty-planes", "empty-volume")


def _sites(case):
    rs = np.random.RandomState(_SITE_CASES.index(case) + 10)
    shape = {"odd-5x7x33": (2, 5, 7, 33), "d1": (2, 1, 9, 12),
             "h1": (1, 6, 1, 11), "w1": (1, 6, 9, 1),
             "empty-columns": (1, 9, 8, 10), "empty-planes": (1, 7, 10, 9),
             "empty-volume": (2, 5, 6, 7)}[case]
    sites = rs.rand(*shape) < 0.1
    if case == "empty-columns":          # (h, w) columns without a site
        sites[:, :, rs.rand(*shape[2:]) < 0.5] = False
    elif case == "empty-planes":         # a D plane and an H plane
        sites[:, 3] = False
        sites[:, :, 4] = False
    elif case == "empty-volume":
        sites[0] = False
    return sites


@pytest.mark.parametrize("case", _SITE_CASES)
def test_edt_sites_plain_matches_jax_bitwise(case):
    sites = _sites(case)
    got = edt.edt_sites_plain(torch.from_numpy(sites)).numpy()
    want = np.asarray(jax_edt._edt_from_sites(jnp.asarray(sites),
                                              axes=(1, 2, 3)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        edt.edt_to_sites(torch.from_numpy(sites), axes=(1, 2, 3)).numpy(),
        want)
    if case == "empty-volume":
        assert np.all(got[0] == np.float32(np.sqrt(np.float32(1e12))))


def _scan_d_rule(sites):
    """The card's f2 rule along D (kernel A of csrc/edt_sites.cu), in
    numpy: the least (z - d)^2 over the column's sites, else 1e12f."""
    depth = sites.shape[1]
    z = np.arange(depth)
    dist = np.abs(z[:, None] - z[None, :])                    # (d, z)
    best = np.where(sites[:, None], dist[None, :, :, None, None],
                    depth).min(axis=2)
    k = best.astype(np.float32)
    return np.where(best < depth, k * k, np.float32(edt._BIG))


@pytest.mark.parametrize("case", _SITE_CASES)
def test_scan_d_rule_equals_plain_clamped_scan(case):
    sites = _sites(case)
    d = edt._nearest_site_dist1d(torch.from_numpy(sites), 1)
    plain = torch.clamp(d * d, max=edt._BIG).numpy()
    rule = _scan_d_rule(sites)
    assert rule.dtype == plain.dtype == np.float32
    np.testing.assert_array_equal(rule, plain)


def test_cpu_transforms_never_touch_the_kernel_counters():
    sites = torch.from_numpy(_sites("odd-5x7x33"))
    before = (edt.edt_sites.launches, edt.edt_parabola.launches)
    edt.edt_to_sites(sites, axes=(1, 2, 3))
    edt.edt_to_sites(sites[0])
    edt.edt_sites(sites)
    edt.distance_transform_edt(sites[1])
    edt.signed_edt(sites[0].float())
    assert (edt.edt_sites.launches, edt.edt_parabola.launches) == before
