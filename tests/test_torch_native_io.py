"""Port parity for the native NIfTI codec (utils/native_io.py, built from
the port's own ``utils/csrc/stroke_io.cpp``) and for ``utils/nifti.py``'s
use of it: round trips of ``.nii.gz`` and ``.nii`` (float32, and int16
with a scale), its files against the JAX package's pure-Python reader and
writer both ways, the pure-Python fallback and its gzip level.

Each test builds the codec into its own ``tmp_path`` (or uses the port's
default build in ``build/torch_native/``); the JAX package's ``native/``
is neither built nor read."""

import gzip
import os

import numpy as np
import pytest

from stroke_prediction_tpu.utils.nifti import read_nifti as jax_read
from stroke_prediction_tpu.utils.nifti import write_nifti as jax_write
from stroke_prediction_tpu_torch.utils import native_io, nifti


@pytest.fixture(scope="module")
def codec(tmp_path_factory):
    c = native_io.NativeCodec(tmp_path_factory.mktemp("native_build"))
    assert c.available, c.error
    return c


def _vol(shape=(9, 7, 5), seed=0):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _affine():
    a = np.diag([2.0, 2.0, 5.0, 1.0]).astype(np.float32)
    a[:3, 3] = [1, 2, 3]
    return a


def test_build_is_keyed_and_atomic(tmp_path):
    """The library lands under its source hash, with no temporary file
    left, and a second build reuses it."""
    so = native_io.build(tmp_path)
    assert so == native_io.library_path(tmp_path) and so.exists()
    assert os.listdir(tmp_path) == [so.name]
    mtime = so.stat().st_mtime_ns
    assert native_io.build(tmp_path) == so
    assert so.stat().st_mtime_ns == mtime


@pytest.mark.parametrize("name", ["n.nii.gz", "n.nii"])
def test_native_round_trip(codec, tmp_path, name):
    vol, aff = _vol(), _affine()
    path = str(tmp_path / name)
    assert codec.write_nifti(path, vol, aff)
    data, a = codec.read_nifti(path)
    assert data.dtype == np.float32
    np.testing.assert_array_equal(data, vol)
    np.testing.assert_array_equal(a, aff)


def test_native_reads_int16_scaled(codec, tmp_path):
    """An int16 volume with scl_slope / scl_inter (written by the
    pure-Python writer, then patched) reads back scaled."""
    vol = np.arange(-12, 12, dtype=np.int16).reshape(2, 3, 4)
    path = tmp_path / "i.nii"
    nifti.write_nifti(str(path), vol)
    raw = bytearray(path.read_bytes())
    raw[112:120] = np.asarray([0.5, 3.0], "<f4").tobytes()
    path.write_bytes(bytes(raw))
    path = str(path)
    data, _ = codec.read_nifti(path)
    np.testing.assert_array_equal(data, vol.astype(np.float32) * 0.5 + 3.0)
    want, _ = nifti.read_nifti(path)
    np.testing.assert_array_equal(data, want.astype(np.float32))


@pytest.mark.parametrize("name", ["j.nii.gz", "j.nii"])
def test_native_writes_read_in_jax(codec, tmp_path, name):
    """The port's native files in the JAX package's pure-Python reader."""
    vol, aff = _vol((12, 10, 6), 1), _affine()
    path = str(tmp_path / name)
    assert codec.write_nifti(path, vol, aff)
    data, a = jax_read(path)
    np.testing.assert_array_equal(data, vol)
    np.testing.assert_array_equal(a, aff)


@pytest.mark.parametrize("dtype", [np.float32, np.int16, np.uint8])
def test_jax_writes_read_natively(codec, tmp_path, dtype):
    """The JAX package's pure-Python files in the port's native reader."""
    vol = (_vol((8, 6, 4), 2) * 50).astype(dtype)
    path = str(tmp_path / "w.nii.gz")
    jax_write(path, vol, _affine())
    data, a = codec.read_nifti(path)
    np.testing.assert_array_equal(data, vol.astype(np.float32))
    np.testing.assert_array_equal(a, _affine())


def test_nifti_uses_the_native_codec(tmp_path, monkeypatch):
    """``save_nifti`` / ``load_volume`` / ``load_affine`` go through the
    native codec where it is available, and through the pure-Python one
    where not; the two files hold the same volume."""
    vol, aff = _vol((10, 8, 6), 3), _affine()
    calls = []
    real = native_io.write_nifti
    monkeypatch.setattr(native_io, "write_nifti",
                        lambda *a: calls.append(a[0]) or real(*a))
    nifti.save_nifti(str(tmp_path / "n.nii.gz"), vol, aff)
    assert native_io.available() and native_io.build_error() is None
    assert calls == [str(tmp_path / "n.nii.gz")]
    monkeypatch.setattr(native_io, "write_nifti", lambda *a: False)
    monkeypatch.setattr(native_io, "read_nifti", lambda path: None)
    nifti.save_nifti(str(tmp_path / "p.nii.gz"), vol, aff)
    for name in ("n.nii.gz", "p.nii.gz"):
        np.testing.assert_array_equal(
            nifti.load_volume(str(tmp_path / name)), vol)
        np.testing.assert_array_equal(
            nifti.load_affine(str(tmp_path / name)), aff)
    np.testing.assert_array_equal(jax_read(str(tmp_path / "p.nii.gz"))[0],
                                  vol)


def test_both_codecs_gzip_at_level_6(codec, tmp_path):
    """The pure-Python writer compresses at the native codec's level 6: the
    gzip header's XFL byte is 0 for both (2 marks level 9, the gzip
    module's default), and the payloads are equal."""
    vol = _vol((20, 16, 8), 4)
    native, plain = tmp_path / "n.nii.gz", tmp_path / "p.nii.gz"
    assert codec.write_nifti(str(native), vol, _affine())
    nifti.write_nifti(str(plain), vol, _affine())
    nine = tmp_path / "nine.gz"
    nine.write_bytes(gzip.compress(b"x"))
    assert nine.read_bytes()[8] == 2
    for path in (native, plain):
        assert path.read_bytes()[8] == 0, path
    assert (gzip.decompress(native.read_bytes())[352:]
            == gzip.decompress(plain.read_bytes())[352:])


def test_unbuildable_codec_reports_why(tmp_path, monkeypatch):
    """Without a compiler the codec is unavailable, says why, and reads and
    writes nothing."""
    monkeypatch.setattr(native_io.shutil, "which", lambda name: None)
    c = native_io.NativeCodec(tmp_path)
    assert not c.available and "g++ not found" in c.error
    assert c.read_nifti(str(tmp_path / "x.nii")) is None
    assert not c.write_nifti(str(tmp_path / "x.nii"), _vol())
