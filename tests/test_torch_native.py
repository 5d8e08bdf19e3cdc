"""The port's native NIfTI feeder (``native/feeder.py`` on
``native/nifti_feeder.cc``) against JAX's ``native.feeder`` on the CPU, bit
for bit: the read of ``.nii`` and ``.nii.gz`` files of several data types,
the MR and CT preprocess and the nearest label resize; and the g++ build
(``native/build.py``), which raises on a compile error."""

import numpy as np
import pytest

try:  # the JAX reference; the GPU machine has no JAX and runs only `-m cuda`
    from protosam_tpu.data.nifti import NiftiImage, write_nii
    from protosam_tpu.native import feeder as jfeeder
except ImportError:
    pass

from protosam_tpu_torch.native import build, feeder


@pytest.fixture(scope="module")
def volumes(tmp_path_factory):
    d = tmp_path_factory.mktemp("nifti")
    rng = np.random.default_rng(0)
    arr = rng.normal(100, 25, (5, 40, 52)).astype(np.float32)
    for name, a in (("f32.nii.gz", arr), ("f32.nii", arr),
                    ("i16.nii.gz", arr.astype(np.int16)),
                    ("u8.nii", np.clip(arr, 0, 255).astype(np.uint8)),
                    ("f64.nii.gz", arr.astype(np.float64))):
        write_nii(NiftiImage(a, spacing=(1.5, 1.25, 5.0)), d / name)
    return d, arr


@pytest.mark.parametrize("name", ["f32.nii.gz", "f32.nii", "i16.nii.gz",
                                  "u8.nii", "f64.nii.gz"])
def test_read_matches_jax(volumes, name):
    d, _ = volumes
    calls = feeder.calls
    got, spacing = feeder.read_volume_native(str(d / name))
    want, jspacing = jfeeder.read_volume_native(str(d / name))
    assert got.dtype == np.float32 and got.shape == (5, 40, 52)
    np.testing.assert_array_equal(got, want)
    assert spacing == jspacing
    assert feeder.calls == calls + 1


@pytest.mark.parametrize("modality,size", [("MR", 64), ("CT", 48),
                                           ("MR", 33)])
def test_preprocess_matches_jax(volumes, modality, size):
    _, arr = volumes
    got = feeder.preprocess_volume_native(arr, size, modality, ct_mean=100.0,
                                          ct_std=25.0)
    want = jfeeder.preprocess_volume_native(arr, size, modality,
                                            ct_mean=100.0, ct_std=25.0)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size", [64, 29])
def test_resize_labels_matches_jax(volumes, size):
    _, arr = volumes
    lbl = np.digitize(arr, [80, 100, 120]).astype(np.float32)
    np.testing.assert_array_equal(feeder.resize_labels_native(lbl, size),
                                  jfeeder.resize_labels_native(lbl, size))


def test_read_refuses_a_file_that_is_not_nifti(tmp_path):
    bad = tmp_path / "bad.nii"
    bad.write_bytes(b"\x00" * 400)
    with pytest.raises(IOError, match="code 2"):
        feeder.read_volume_native(str(bad))
    short = tmp_path / "short.nii"
    short.write_bytes(b"\x00" * 100)
    with pytest.raises(IOError, match="code 1"):
        feeder.read_volume_native(str(short))


def test_build_is_keyed_and_raises_on_a_compile_error(tmp_path,
                                                      monkeypatch):
    """The library path follows the source's hash; a source that does not
    compile raises with g++'s message and leaves no library behind."""
    assert feeder.native_available()
    path = build.library_path("nifti_feeder")
    assert path.exists() and path.parent == build.BUILD_DIR
    monkeypatch.setattr(build, "NATIVE_DIR", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    (tmp_path / "broken.cc").write_text("int f() { return undeclared; }\n")
    first = build.library_path("broken")
    with pytest.raises(RuntimeError, match="undeclared"):
        build.build("broken")
    assert not first.exists()
    (tmp_path / "broken.cc").write_text("int f() { return 1; }\n")
    assert build.library_path("broken") != first
    assert build.build("broken").exists()
