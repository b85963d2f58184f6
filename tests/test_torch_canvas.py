"""The R-CNN predictors' canvas (``tpuseg_torch/kernels/canvas.py``): its
plain version against the host's ``preprocess_image_bgr`` bit for bit,
and (marked ``cuda``) the kernel against the plain version. This file
imports no jax, so on a machine without jax it runs without the
repository's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_canvas.py
"""
import numpy as np
import pytest
import torch

from tpuseg_torch import kernels
from tpuseg_torch.engine.maskrcnn_engine import (canvas_geometry,
                                                 preprocess_image_bgr)
from tpuseg_torch.kernels.canvas import build_canvas, resize_taps
from tpuseg_torch.models.vitdet import ViTDetConfig
from tpuseg_torch.ops.preprocess import DETECTRON_PIXEL_MEAN_BGR

torch.set_num_threads(2)

# (frames' (h, w), min_size, max_size); one canvas orientation a case
CASES = {
    "upscale_vitdet": ([(480, 640)], 1024, 1024),
    "upscale_800": ([(480, 640)], 800, 1333),
    "downscale": ([(1080, 1920)], 800, 1333),
    "downscale_wide": ([(300, 2000)], 800, 1333),
    "extreme_aspect": ([(100, 3000)], 800, 1333),
    "identity": ([(800, 1066)], 800, 1333),
    "portrait": ([(640, 480)], 800, 1333),
    "tiny": ([(37, 50)], 800, 1333),
    "batch_of_two": ([(480, 640), (600, 900)], 800, 1333),
}
_VITDET = ViTDetConfig()
NORMS = {"bgr_mean": None, "rgb_norm": (_VITDET.pixel_mean, _VITDET.pixel_std)}


# cases whose frames are BGR arrays; the others' first frame is a reversed
# view of an RGB array, as the stream hands them over, and their second
# (the batch's) a BGR array
BGR_ARRAYS = {"identity", "portrait"}


def _frames(name):
    rng = np.random.default_rng(len(name))
    shapes = CASES[name][0]
    imgs = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in shapes]
    if name not in BGR_ARRAYS:
        imgs[0] = imgs[0][:, :, ::-1]
    return imgs


def _case(name, norm, device):
    """(frames, the host's canvases [B, 3, Hc, Wc], the wrapper's canvas
    with one blank canvas after the frames, bytes it sent)."""
    _, lo, hi = CASES[name]
    imgs = _frames(name)
    rgb_norm = NORMS[norm]
    want, sizes = [], []
    for img in imgs:
        canvas, hw, _ = preprocess_image_bgr(img, lo, hi, rgb_norm)
        assert canvas_geometry(*img.shape[:2], lo, hi) == (hw, canvas.shape[:2])
        want.append(torch.from_numpy(canvas).permute(2, 0, 1))
        sizes.append(hw)
    mean, std = rgb_norm or (DETECTRON_PIXEL_MEAN_BGR, None)
    got, sent = build_canvas(imgs, sizes, tuple(want[0].shape[1:]), mean, std,
                             blank=1, device=device)
    return imgs, torch.stack(want), got, sent


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("norm", list(NORMS))
@pytest.mark.parametrize("name", list(CASES))
def test_plain_canvas_equals_the_host(name, norm):
    """On the CPU the wrapper's plain version gives the host's canvases
    to the bit (Pillow's resize, the f32 normalisation, the zero padding),
    the blank canvas all zeros; nothing is launched or sent."""
    before = kernels.launch_counts()["canvas"]
    _, want, got, sent = _case(name, norm, "cpu")
    assert kernels.launch_counts()["canvas"] == before and sent == 0
    assert got.dtype == torch.float32 and got.shape[0] == len(want) + 1
    assert torch.equal(_bits(got[:-1]), _bits(want))
    assert not got[-1].any()


def test_resize_taps_sum_to_one_and_stay_inside():
    """Each output's weights sum to 2^22 within the rounding of its taps,
    and its taps lie inside the source axis."""
    for n_in, n_out in ((640, 1024), (1920, 1333), (3000, 1333), (37, 800),
                        (800, 800)):
        t = resize_taps(n_in, n_out).astype(np.int64)
        first, count, k = t[:, 0], t[:, 1], t[:, 2:]
        assert (first >= 0).all() and (count >= 1).all()
        assert (first + count <= n_in).all()
        assert (np.abs(k.sum(1) - (1 << 22)) <= k.shape[1]).all()


def test_canvas_wrapper_rejects_bad_inputs():
    img = np.zeros((48, 64, 3), np.uint8)
    mean = DETECTRON_PIXEL_MEAN_BGR
    with pytest.raises(ValueError):  # f32 frames
        build_canvas([img.astype(np.float32)], [(48, 64)], (64, 64), mean)
    with pytest.raises(ValueError):  # a frame as a tensor
        build_canvas([torch.from_numpy(img)], [(48, 64)], (64, 64), mean)
    with pytest.raises(ValueError):  # one band
        build_canvas([img[:, :, 0]], [(48, 64)], (64, 64), mean)
    with pytest.raises(ValueError):  # a size past the canvas
        build_canvas([img], [(48, 65)], (64, 64), mean)
    with pytest.raises(ValueError):  # sizes for another number of frames
        build_canvas([img], [(48, 64)] * 2, (64, 64), mean)
    with pytest.raises(ValueError):  # no kernel or plain path there
        build_canvas([img], [(48, 64)], (64, 64), mean, device="meta")


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("norm", list(NORMS))
@pytest.mark.parametrize("name", list(CASES))
def test_canvas_kernel_matches_plain(name, norm):
    """One launch a batch, the frames and their tap tables sent, and the
    canvases equal to the plain version's on the card and on the host bit
    for bit, the blank canvas zeros."""
    dev = _device()
    before = kernels.launch_counts()["canvas"]
    imgs, want, got, sent = _case(name, norm, dev)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["canvas"] == before + 1
    frames = sum(img.nbytes for img in imgs)
    assert frames < sent < frames + 64 * 1024 * len(imgs)  # + tap tables
    with kernels.force_plain():
        _, _, on_card, _ = _case(name, norm, dev)
    assert kernels.launch_counts()["canvas"] == before + 1
    host = torch.cat([want, torch.zeros_like(want[:1])])
    assert torch.equal(_bits(got.cpu()), _bits(host))
    assert torch.equal(_bits(on_card.cpu()), _bits(host))


@pytest.mark.cuda
def test_canvas_wrapper_rejects_bad_inputs_on_the_card():
    dev = _device()
    img = np.zeros((48, 64, 3), np.uint8)
    mean = DETECTRON_PIXEL_MEAN_BGR
    with pytest.raises(ValueError):  # a frame already on the card
        build_canvas([torch.from_numpy(img).to(dev)], [(48, 64)], (64, 64),
                     mean, device=dev)
    with pytest.raises(ValueError):  # int16 frames
        build_canvas([img.astype(np.int16)], [(48, 64)], (64, 64), mean,
                     device=dev)
