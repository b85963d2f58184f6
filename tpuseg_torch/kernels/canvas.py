"""The R-CNN predictors' canvas: the ctypes binding of ``csrc/canvas.cu``
and its plain version. Each BGR uint8 frame is resized as Pillow's
``Image.resize(..., Image.BILINEAR)`` resizes 8-bit bands, normalised in
f32 and padded with zeros into an NCHW canvas, bit for bit as
``engine/maskrcnn_engine.py::preprocess_image_bgr`` builds it on the host.

Pillow's arithmetic (``libImaging/Resample.c``): per axis, each output
index has a run of source indices and integer weights of 22 fractional bits
(:func:`resize_taps`, from the host's doubles); the horizontal pass runs
first into a uint8 image, the vertical pass reads it, each computing
``clip((2^21 + sum(pixel * weight)) >> 22, 0, 255)`` in integers; an axis
that keeps its size is not resampled.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from tpuseg_torch import kernels as K

BITS = 22  # Pillow's PRECISION_BITS for 8-bit bands
DESC_WORDS = 9  # int64 words of an image's descriptor in the upload
ALIGN = 16


@functools.lru_cache(maxsize=64)
def resize_taps(n_in: int, n_out: int) -> np.ndarray:
    """Pillow's BILINEAR coefficients of one axis as int32 [n_out, 2 + K]:
    each output's first source index, its number of taps, then the taps'
    weights (zeros past that number). An axis that keeps its size gets one
    tap of weight 1 (Pillow skips its pass; the result is the same)."""
    i = np.arange(n_out)
    if n_in == n_out:
        return np.stack([i, np.ones_like(i), np.full_like(i, 1 << BITS)],
                        1).astype(np.int32)
    # precompute_coeffs in doubles, operation for operation
    scale = n_in / n_out
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale  # the bilinear filter's support is 1
    ss = 1.0 / filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (i + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    n = np.minimum((center + support + 0.5).astype(np.int64), n_in) - xmin
    w = np.zeros((n_out, ksize))
    ww = np.zeros(n_out)
    for j in range(ksize):  # the sum in Pillow's order
        x = np.abs((j + xmin - center + 0.5) * ss)
        w[:, j] = np.where((j < n) & (x < 1.0), 1.0 - x, 0.0)
        ww += w[:, j]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None],
                 w)
    k = (0.5 + w * (1 << BITS)).astype(np.int32)  # normalize_coeffs_8bpc
    return np.concatenate([xmin[:, None], n[:, None], k], 1).astype(np.int32)


def _resample_axis(img: torch.Tensor, axis: int, n_out: int) -> torch.Tensor:
    """One of Pillow's passes over ``axis`` (0 rows, 1 columns) of a uint8
    [H, W, 3] image, in int32 on the image's device."""
    taps = torch.from_numpy(resize_taps(img.shape[axis], n_out)).to(img.device)
    first, weights = taps[:, 0].long(), taps[:, 2:]
    acc = torch.full([n_out if a == axis else s
                      for a, s in enumerate(img.shape)], 1 << (BITS - 1),
                     dtype=torch.int32, device=img.device)
    last = img.shape[axis] - 1
    for j in range(weights.shape[1]):
        k = weights[:, j]
        src = img.index_select(axis, (first + j).clamp(max=last)).int()
        acc += src * (k[:, None, None] if axis == 0 else k[None, :, None])
    return (acc >> BITS).clamp(0, 255).to(torch.uint8)


def resize_plain(img: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """uint8 [h, w, 3] -> uint8 [th, tw, 3]: Pillow's BILINEAR resize of
    8-bit bands, the horizontal pass first."""
    if tw != img.shape[1]:
        img = _resample_axis(img, 1, tw)
    if th != img.shape[0]:
        img = _resample_axis(img, 0, th)
    return img


def canvas_plain(frames: list, sizes: list, canvas_hw: tuple, mean,
                 std=None, blank: int = 0) -> torch.Tensor:
    """BGR uint8 frames [h, w, 3] (torch, on one device) -> f32 [B + blank,
    3, Hc, Wc] on that device: each frame resized to its (th, tw) of
    ``sizes``, then BGR less ``mean``, or with ``std``, RGB as (x - mean) /
    std, at the canvas' top left; zeros elsewhere and in the ``blank``
    canvases at the end. Divides by a tensor on the frames' device (CUDA
    PyTorch divides by a Python scalar as a multiplication)."""
    dev = frames[0].device if frames else torch.device("cpu")
    out = torch.zeros((len(frames) + blank, 3, *canvas_hw),
                      dtype=torch.float32, device=dev)
    mean_t = torch.tensor(mean, dtype=torch.float32, device=dev)
    std_t = None if std is None else torch.tensor(std, dtype=torch.float32,
                                                  device=dev)
    for i, (img, (th, tw)) in enumerate(zip(frames, sizes)):
        x = resize_plain(img, th, tw).float()
        x = x - mean_t if std_t is None else (x.flip(-1) - mean_t) / std_t
        out[i, :, :th, :tw] = x.permute(2, 0, 1)
    return out


def _check(imgs_bgr: list, sizes: list, canvas_hw: tuple, blank: int):
    if len(imgs_bgr) != len(sizes):
        raise ValueError(f"canvas: {len(imgs_bgr)} frames, {len(sizes)} sizes")
    hc, wc = canvas_hw
    if not (1 <= hc and 1 <= wc and hc * wc < 2 ** 31
            and 1 <= len(imgs_bgr) + blank <= 65535 and blank >= 0):
        raise ValueError(f"canvas: {len(imgs_bgr)} + {blank} canvases of "
                         f"{hc}x{wc}")
    for img, (th, tw) in zip(imgs_bgr, sizes):
        if (not isinstance(img, np.ndarray) or img.dtype != np.uint8
                or img.ndim != 3 or img.shape[2] != 3 or 0 in img.shape):
            raise ValueError("canvas: frames must be host numpy uint8 [h, w, "
                             f"3], got {type(img).__name__} "
                             f"{getattr(img, 'dtype', '')} "
                             f"{tuple(getattr(img, 'shape', ()))}")
        if not (1 <= th <= hc and 1 <= tw <= wc):
            raise ValueError(f"canvas: a frame resized to {th}x{tw} does "
                             f"not fit the {hc}x{wc} canvas")


def _stored(img: np.ndarray) -> tuple:
    """(the array whose bytes go up, 1 if its channels are RGB): a BGR
    view of an RGB array (``rgb[:, :, ::-1]``) goes up as the RGB array,
    which copies as one block, where the view copies byte by byte."""
    rgb = img[:, :, ::-1]
    return (rgb, 1) if rgb.flags.c_contiguous else (img, 0)


def _pack(imgs_bgr: list, sizes: list, blank: int) -> torch.Tensor:
    """The one pinned upload of a batch: B + blank descriptors of int64
    [frame offset, w, th, tw, x taps offset, y taps offset, x taps row
    length, y taps row length, 1 if the frame is stored RGB] (th = tw =
    0: a blank canvas), then each frame's two tap tables
    (:func:`resize_taps`) and its pixels, every part at a 16-byte
    boundary."""
    def at(n):  # the next part's offset, n bytes after the current one
        nonlocal end
        start = end
        end += -(-n // ALIGN) * ALIGN
        return start

    end = 0
    at(8 * DESC_WORDS * (len(imgs_bgr) + blank))
    desc = np.zeros((len(imgs_bgr) + blank, DESC_WORDS), np.int64)
    parts = []
    for i, (img, (th, tw)) in enumerate(zip(imgs_bgr, sizes)):
        h, w = img.shape[:2]
        xt, yt = resize_taps(w, tw), resize_taps(h, th)
        pixels, rgb = _stored(img)
        xo, yo, fo = at(xt.nbytes), at(yt.nbytes), at(img.nbytes)
        desc[i] = (fo, w, th, tw, xo, yo, xt.shape[1], yt.shape[1], rgb)
        parts += [(xo, xt), (yo, yt), (fo, pixels)]
    buf = torch.empty(end, dtype=torch.uint8, pin_memory=True)
    host = buf.numpy()
    host[:desc.nbytes] = desc.view(np.uint8).ravel()
    for off, a in parts:
        np.copyto(host[off:off + a.nbytes].view(a.dtype).reshape(a.shape), a)
    return buf


def build_canvas(imgs_bgr: list, sizes: list, canvas_hw: tuple, mean,
                 std=None, blank: int = 0, device="cpu") -> tuple:
    """Host BGR uint8 frames [h, w, 3] (numpy, any strides), each with its
    (th, tw) -> (f32 canvases [B + blank, 3, Hc, Wc] on ``device``, bytes
    sent to it), as :func:`canvas_plain`. On a CUDA device the frames go up
    as uint8, with their tap tables, in one pinned buffer, and the kernel
    builds the canvases there (one launch); on the host, or under
    ``kernels.force_plain``, the plain version builds them from the frames
    on ``device``."""
    _check(imgs_bgr, sizes, canvas_hw, blank)
    device = torch.device(device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"canvas: no kernel or plain path for {device}")
    if not K.use_kernel(device):
        frames = [torch.from_numpy(np.ascontiguousarray(img)).to(device)
                  for img in imgs_bgr]
        sent = sum(f.nbytes for f in frames) if device.type == "cuda" else 0
        return canvas_plain(frames, sizes, canvas_hw, mean, std, blank), sent
    packed = _pack(imgs_bgr, sizes, blank)
    buf = packed.to(device, non_blocking=True)
    b = len(imgs_bgr) + blank
    out = torch.empty((b, 3, *canvas_hw), dtype=torch.float32, device=device)
    f = ctypes.c_float
    norm = [*map(f, mean), *map(f, std if std is not None else (1.0,) * 3)]
    with torch.cuda.device(device):
        status = K.library().tpuseg_canvas_f32(
            buf.data_ptr(), b, *canvas_hw, *norm, int(std is not None),
            out.data_ptr(), K.stream_ptr(device))
    K.check_status(status, "canvas kernel")
    K.count_launch("canvas")
    return out, packed.nbytes
