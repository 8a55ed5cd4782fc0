"""Port parity for the signed-distance-map (SDM) baseline: ``eval/sdm.py``
(the artificial core, the dilation, the latent zoom and ``sdm_interpolate``)
and the ``test_sdm_resampling`` CLI, each against the JAX package on the
CPU (its EDT on the XLA path; the port's plain EDT).

``sdm_interpolate`` runs over t in {0, 0.37, 1}, with and without the
latent resample, on a normal case, one with an empty core (the artificial
core stands in) and one with an empty penumbra (``penu < threshold`` has no
zero voxel: the ``_BIG``-scale distances), at (12, 48, 48) and at (12, 41,
47), whose planes undershoot (41 -> 3 -> 36: edge-padded) and overshoot
(47 -> 4 -> 48: cropped) the zoom's round trip.  The EDT terms are exact
(the SDMs without the resample equal, bit for bit, the differences of
JAX's ``distance_transform_edt`` of each mask); the SDM values agree within 1e-5 of max|ref| (the zoom's sums and the
interpolation's products may round apart), and the thresholded masks are
equal except where |ref| <= 1e-5 max|ref|.  The CLI's results lines are
identical and its NIfTI dumps agree within 1e-5."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stroke_prediction_tpu.cli import common as jax_common
from stroke_prediction_tpu.cli import test_sdm_resampling as jax_cli
from stroke_prediction_tpu.data import dataset as jax_dataset
from stroke_prediction_tpu.eval import sdm as jax_sdm
from stroke_prediction_tpu.ops import edt as jax_edt
from stroke_prediction_tpu.utils import args as jax_args
from stroke_prediction_tpu.utils.nifti import read_nifti
from stroke_prediction_tpu_torch.cli import common as port_common
from stroke_prediction_tpu_torch.cli import test_sdm_resampling as port_cli
from stroke_prediction_tpu_torch.eval import sdm
from stroke_prediction_tpu_torch.ops import edt
from stroke_prediction_tpu_torch.utils.args import get_args_sdm

torch.set_num_threads(1)

REL = 1e-5
OUTPUTS = ("recon_core", "recon_intp", "recon_penu", "latent_core",
           "latent_intp", "latent_penu")


def _ball(shape, centre, radii):
    z, y, x = np.ogrid[:shape[0], :shape[1], :shape[2]]
    r2 = sum(((g - c) / r) ** 2 for g, c, r in zip((z, y, x), centre, radii))
    return (r2 <= 1.0).astype(np.float32)


def _case(shape, kind):
    """A soft core inside a soft penumbra (a little noise, so some voxels
    sit near the threshold), or one of them empty."""
    d, h, w = shape
    rs = np.random.RandomState(3)
    penu = _ball(shape, (d / 2, h * 0.45, w * 0.55), (d / 3, h / 3, w / 4))
    core = _ball(shape, (d / 2, h * 0.43, w * 0.52), (d / 6, h / 8, w / 9))
    penu = np.clip(penu + rs.uniform(-0.3, 0.3, shape), 0, 1)
    core = np.clip(core + rs.uniform(-0.3, 0.3, shape), 0, 1) * (penu > 0.5)
    if kind == "empty core":
        core = np.zeros(shape, np.float32)
    elif kind == "empty penumbra":
        penu = np.zeros(shape, np.float32)
    return core.astype(np.float32), penu.astype(np.float32)


def _jax_terms(core, penu, threshold=0.5):
    """The core and penumbra SDMs from JAX's ``distance_transform_edt``
    called on each mask, the differences taken in float32 (JAX's jitted
    ``sdm_interpolate`` fuses the sqrt with them and lands one ulp apart at
    a few voxels)."""
    edt = lambda m: np.asarray(  # noqa: E731
        jax_edt.distance_transform_edt(jnp.asarray(m)))
    penu_bin = penu > threshold
    core_bin = core > threshold
    if not core_bin.any():
        core_bin = np.asarray(jax_sdm._artificial_core(jnp.asarray(penu_bin),
                                                       3))
    return (edt(~core_bin) - edt(core > threshold),
            edt(penu_bin) - edt(penu < threshold))


@pytest.mark.parametrize("shape", [(12, 48, 48), (12, 41, 47)])
@pytest.mark.parametrize("kind", ["normal", "empty core", "empty penumbra"])
@pytest.mark.parametrize("resample", [True, False])
@pytest.mark.parametrize("t", [0.0, 0.37, 1.0])
def test_sdm_interpolate_matches_jax(shape, kind, resample, t):
    core, penu = _case(shape, kind)
    want = [np.asarray(a) for a in jax_sdm.sdm_interpolate(
        jnp.asarray(core), jnp.asarray(penu), t, resample=resample)]
    got = [a.numpy() for a in sdm.sdm_interpolate(
        torch.from_numpy(core), torch.from_numpy(penu), t,
        resample=resample)]
    for name, a, b in zip(OUTPUTS, got, want):
        assert a.shape == b.shape and a.dtype == np.float32, name
        scale = np.abs(b).max()
        assert np.abs(a - b).max() <= REL * scale, (
            name, np.abs(a - b).max() / scale)
        if name.startswith("recon"):
            near = np.abs(b) <= REL * scale
            for ta, tb in ((a > 0, b > 0), (a < 0, b < 0)):
                assert ((ta == tb) | near).all(), name
    if not resample:                 # the EDT terms alone: exact
        np.testing.assert_array_equal(got[0], _jax_terms(core, penu)[0])
        np.testing.assert_array_equal(got[2], _jax_terms(core, penu)[1])
    if kind == "empty penumbra":     # no site in penu < threshold
        assert np.abs(want[2]).max() > 1e5


def test_plain_edt_sqrt_is_correctly_rounded():
    """The port's plain EDT (what the CPU runs, and what the card's kernels
    are held to) against JAX's on a mask whose squared distances reach 267,
    whose float32 sqrt a CPU build of torch rounds one ulp low; and its
    distances are the correctly rounded square roots of integers."""
    mask = np.ones((12, 24, 24), bool)
    mask[0, 0, 0] = False                  # one zero: the only site
    want = np.asarray(jax_edt.distance_transform_edt(jnp.asarray(mask)))
    got = edt.distance_transform_edt(torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, want)
    f2 = np.round(got.astype(np.float64) ** 2)
    assert 267 in f2
    np.testing.assert_array_equal(got, np.sqrt(f2).astype(np.float32))


@pytest.mark.parametrize("shape, centre", [
    ((12, 48, 48), (6, 22, 25)), ((5, 9, 7), (0, 8, 6)),
    ((12, 41, 47), (3, 5, 40))])
def test_artificial_core_matches_jax(shape, centre):
    """The dilated seed at the penumbra's centre of mass, at sizes where
    JAX's float32 coordinate sums are exact (below 2^24); an empty
    penumbra puts it at the origin.  The dilation against scipy's rule."""
    penu = _ball(shape, centre, (2.5, 4.0, 3.0)) > 0.5
    for mask in (penu, np.zeros(shape, bool)):
        want = np.asarray(jax_sdm._artificial_core(jnp.asarray(mask), 3))
        got = sdm._artificial_core(torch.from_numpy(mask), 3).numpy()
        np.testing.assert_array_equal(got, want)
        assert 0 < got.sum() <= 63          # the 3-step cross's volume
    seed = np.zeros(shape, bool)
    seed[centre] = True
    want = np.asarray(jax_sdm._binary_dilation_cross(jnp.asarray(seed), 2))
    np.testing.assert_array_equal(
        sdm._binary_dilation_cross(torch.from_numpy(seed), 2).numpy(), want)


def test_artificial_core_centre_is_exact_at_full_size():
    """At 28 x 128 x 128 the coordinate sums exceed 2^24, where float32
    sums round by their order; the port's are exact, so its centre is the
    float32 quotient of the exact sums, truncated."""
    shape = (28, 128, 128)
    penu = np.zeros(shape, bool)
    penu[3:27, 10:121, 31:128] = True
    penu &= _ball(shape, (14.3, 70.6, 60.2), (9, 30, 25)) < 0.5
    idx = np.nonzero(penu)
    sums = [int(np.sum(i, dtype=np.int64)) for i in idx]
    assert max(sums) > 2 ** 24
    n = np.float32(penu.sum())
    centre = tuple(int(np.float32(s) / n) for s in sums)
    got = sdm._artificial_core(torch.from_numpy(penu), 0).numpy()
    assert list(zip(*np.nonzero(got))) == [centre]


@pytest.mark.parametrize("plane, factor, out", [
    ((48, 41), 1 / 12, (4, 3)), ((4, 3), 12.0, (48, 36))])
def test_zoom_latent_matches_jax(plane, factor, out):
    vol = np.random.RandomState(2).standard_normal((3, *plane)).astype(
        np.float32)
    want = np.asarray(jax_sdm._zoom_latent(jnp.asarray(vol), factor))
    got = sdm._zoom_latent(torch.from_numpy(vol), factor).numpy()
    assert got.shape == want.shape == (3, *out)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_sdm_args_match_jax(monkeypatch):
    monkeypatch.setattr("sys.argv", ["prog", "--synthetic"])
    want = vars(jax_args.get_args_sdm())
    got = vars(get_args_sdm(["--synthetic", "--device", "cpu"]))
    assert got.pop("device") == "cpu"
    assert got == want
    assert get_args_sdm([]).device == "cuda"


@pytest.mark.parametrize("groundtruth", ["1", "0"])
def test_cli_matches_jax(tmp_path, capsys, monkeypatch, groundtruth):
    """Both packages' CLIs on three synthetic cases (96 x 96 x 12, resampled
    to 48 x 48 x 12, the latent 4 x 4): the results lines identical, the
    four dumps per case within 1e-5, the same console lines per case."""
    common = ["--synthetic", "--xyoriginal", "96", "--zsize", "12",
              "--fold", "0", "1", "2", "--seed", "5", "--groundtruth",
              groundtruth]

    def jax_provider(**kw):
        return jax_dataset.SyntheticCaseProvider(
            **{**kw, "cache_dir": str(tmp_path / "jax_cache")})

    monkeypatch.setattr(jax_common, "SyntheticCaseProvider", jax_provider)
    jax_base = str(tmp_path / "jax")
    monkeypatch.setattr("sys.argv", ["prog", *common, "--outbasepath",
                                     jax_base])
    jax_cli.infer(jax_args.get_args_sdm())
    jax_out = capsys.readouterr().out

    monkeypatch.setattr(port_common, "synthetic_cache_dir",
                        lambda: str(tmp_path / "port_cache"))
    port_base = str(tmp_path / "port")
    seconds = port_cli.infer(get_args_sdm(
        common + ["--outbasepath", port_base, "--device", "cpu"]))
    port_out = capsys.readouterr().out

    def lines(base):
        with open(base + "_sdm_results.txt") as f:
            return f.read().splitlines()

    assert len(lines(jax_base)) == 3
    assert lines(port_base) == lines(jax_base)
    assert [c for c, _, _ in seconds] == [
        int(ln.split()[2]) for ln in lines(port_base)]

    def case_lines(out):
        return [ln for ln in out.splitlines() if "TO-->TR" in ln]

    assert case_lines(port_out) == case_lines(jax_out)
    for cid, _, _ in seconds:
        for part in ("_lesion", "_fuctgt", "_core", "_penu"):
            got, aff = read_nifti(f"{port_base}_{cid}{part}.nii.gz")
            want, aff_want = read_nifti(f"{jax_base}_{cid}{part}.nii.gz")
            assert got.shape == want.shape == (96, 96, 12)
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
            np.testing.assert_array_equal(aff, aff_want)
    assert os.listdir(tmp_path / "port_cache")
