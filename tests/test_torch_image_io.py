"""tpuseg_torch.data.image_io, the port's own copy of the image decode and
encode (PIL; the port does not use cv2), against tpuseg's load_image_bgr
(cv2 where installed), and with cv2 hidden."""
import builtins

import numpy as np
import pytest

from tpuseg.data.image_io import load_image_bgr as j_load
from tpuseg_torch.data import image_io


@pytest.fixture
def no_cv2(monkeypatch):
    real_import = builtins.__import__

    def fake_import(name, *args, **kwargs):
        if name == "cv2":
            raise ImportError("cv2 hidden")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", fake_import)


def _image(rng):
    return rng.integers(0, 256, (37, 53, 3)).astype(np.uint8)


def test_png_round_trip_matches_jax_loader(rng, tmp_path):
    img = _image(rng)
    path = str(tmp_path / "a.png")
    image_io.save_image_bgr(path, img)
    got = image_io.load_image_bgr(path)
    assert got.dtype == np.uint8 and got.shape == img.shape
    np.testing.assert_array_equal(got, img)  # PNG is lossless
    np.testing.assert_array_equal(got, j_load(path))


def test_pil_path_matches_cv2_path(rng, tmp_path, no_cv2):
    img = _image(rng)
    path = str(tmp_path / "b.png")
    image_io.save_image_bgr(path, img)  # through PIL
    got = image_io.load_image_bgr(path)  # through PIL
    np.testing.assert_array_equal(got, img)
    assert got.flags["C_CONTIGUOUS"]
