"""tpuseg_torch.data.native_loader, the port's native image loader built
from its own source (tpuseg_torch/native/tpuseg_loader.cpp), against
tpuseg's NativeImageLoader on the same JPEG and PNG files: bit-equal,
stretched and letterboxed. Its PIL path (where the library does not build)
against the native one."""
import time

import numpy as np
import pytest
from PIL import Image

from tpuseg.data.native_loader import NativeImageLoader as JLoader
from tpuseg_torch.data import native_loader as NL

ROOT = NL.SOURCE.parents[2]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Four JPEGs and two PNGs of assorted sizes, landscape and portrait."""
    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(0)
    paths = []
    for i, (h, w) in enumerate([(60, 80), (73, 87), (97, 61), (41, 41),
                                (50, 40), (33, 70)]):
        low = rng.uniform(0, 255, (h // 8 + 1, w // 8 + 1, 3))
        img = np.clip(np.kron(low, np.ones((8, 8, 1)))[:h, :w]
                      + rng.normal(0, 25, (h, w, 3)), 0, 255).astype(np.uint8)
        p = str(d / (f"im{i}.jpg" if i < 4 else f"im{i}.png"))
        Image.fromarray(img).save(p)
        paths.append(p)
    return paths


def test_builds_from_its_own_source_into_build(tmp_path, monkeypatch):
    assert NL.SOURCE == ROOT / "tpuseg_torch" / "native" / "tpuseg_loader.cpp"
    assert NL.BUILD_ROOT == ROOT / "build" / "tpuseg_torch" / "native"
    monkeypatch.setattr(NL, "BUILD_ROOT", tmp_path / "native")
    t0 = time.perf_counter()
    lib = NL.build()
    seconds = time.perf_counter() - t0
    print(f"first build of the native loader: {seconds:.2f} s (CPU, g++)")
    assert lib.exists() and lib.parent.parent == tmp_path / "native"
    assert (lib.parent / "build.log").read_text().startswith("g++ ")
    assert NL.build() == lib  # built once per source hash


@pytest.mark.parametrize("keep_aspect", [False, True])
@pytest.mark.parametrize("out_hw", [(64, 64), (48, 96), (550, 550)])
def test_native_loader_equals_tpuseg(files, out_hw, keep_aspect):
    got_loader = NL.NativeImageLoader(2)
    assert got_loader.is_native
    want_loader = JLoader(2)
    assert want_loader.is_native
    got, got_hw = got_loader.load_batch(files, *out_hw, keep_aspect)
    want, want_hw = want_loader.load_batch(files, *out_hw, keep_aspect)
    assert got.shape == (len(files), *out_hw, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_hw, want_hw)
    if keep_aspect:
        assert tuple(got[0, 0, 0]) == (128, 128, 128)  # the grey border
    # the PIL path, where the library does not build: the same sizes, the
    # same pixels to one level (g++ fuses some of the resize's multiply-adds)
    pil = NL.NativeImageLoader(2)
    pil._native = False
    alt, alt_hw = pil.load_batch(files, *out_hw, keep_aspect)
    np.testing.assert_array_equal(alt_hw, got_hw)
    assert np.abs(alt.astype(int) - got).max() <= 1
    assert (alt != got).mean() < 1e-3


def test_native_loader_at_the_images_own_size_is_the_decode(files):
    from tpuseg_torch.data.image_io import load_image_rgb

    for loader in (NL.NativeImageLoader(1), NL.NativeImageLoader(1)):
        for p in files:
            img = load_image_rgb(p, ignore_orientation=True)
            out, hw = loader.load_batch([p], *img.shape[:2])
            np.testing.assert_array_equal(out[0], img)
            assert tuple(hw[0]) == img.shape[:2]
        loader._native = False  # the second pass: the PIL path


def test_missing_file_and_the_one_based_failure_index(files, tmp_path):
    import ctypes

    lib = NL._get_lib()
    missing = str(tmp_path / "nope.jpg")
    paths = files[:2] + [missing]
    handle = lib.nl_create(2)
    try:
        out = np.empty((3, 16, 16, 3), np.uint8)
        hw = np.empty((3, 2), np.int32)
        arr = (ctypes.c_char_p * 3)(*[p.encode() for p in paths])
        rc = lib.nl_load_batch(
            handle, arr, 3, 16, 16, 0,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            hw.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    finally:
        lib.nl_destroy(handle)
    assert rc == 3  # the third path, counted from 1
    loader = NL.NativeImageLoader(1)
    with pytest.warns(UserWarning, match="native decode failed"):
        with pytest.raises(OSError):
            loader.load_batch([missing], 32, 32)
