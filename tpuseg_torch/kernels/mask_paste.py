"""YOLACT's mask paste: the ctypes binding of ``csrc/mask_paste.cu`` and
its plain version. The kept detections' prototype-resolution masks are
upsampled to the image with half-pixel bilinear interpolation and
binarised at 0.5, as uint8."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from tpuseg_torch import kernels as K


def paste_masks_plain(masks: torch.Tensor, index: torch.Tensor, h: int,
                      w: int) -> torch.Tensor:
    """The host engine's arithmetic: ``F.interpolate`` (bilinear,
    ``align_corners=False``) of the kept masks, then ``> 0.5``."""
    kept = masks[index].contiguous()
    if len(kept):
        kept = F.interpolate(kept[:, None].float(), size=(h, w),
                             mode="bilinear", align_corners=False)[:, 0]
    return (kept > 0.5).to(torch.uint8).reshape(-1, h, w)


def paste_masks(masks: torch.Tensor, index, h: int, w: int) -> torch.Tensor:
    """masks [M, S, S] f32 (any strides), ``index`` the kept slots [n]
    (integers on the host) -> [n, h, w] uint8 on the masks' device: the
    kernel for CUDA masks, :func:`paste_masks_plain` for CPU ones."""
    index = torch.as_tensor(index, dtype=torch.int64)
    if index.device.type != "cpu" or index.ndim != 1:
        raise ValueError(f"mask_paste: index {tuple(index.shape)} on "
                         f"{index.device}, expected [n] on the host")
    m = masks.shape[0]
    if len(index) and not 0 <= int(index.min()) <= int(index.max()) < m:
        raise ValueError(f"mask_paste: index outside the {m} slots")
    if not K.use_kernel(masks):
        return paste_masks_plain(masks, index, h, w)
    dev = masks.device
    if masks.dtype != torch.float32 or masks.ndim != 3 \
            or masks.shape[1] != masks.shape[2]:
        raise ValueError(f"mask_paste kernel: masks {masks.dtype} "
                         f"{tuple(masks.shape)}, expected f32 [M, S, S]")
    n, s = len(index), masks.shape[1]
    if n > 65535 or s > 1024 or h < 1 or not 1 <= w <= 16384:
        # the grid's masks; a strip of one row in shared memory
        raise ValueError(f"mask_paste kernel: {n} masks of {s}x{s} to "
                         f"{h}x{w}: at most 65535 masks, S <= 1024, "
                         "1 <= W <= 16384")
    out = torch.empty((n, h, w), dtype=torch.uint8, device=dev)
    if n:
        slots = index.to(dev)
        with torch.cuda.device(dev):
            status = K.library().tpuseg_mask_paste_f32(
                masks.data_ptr(), *masks.stride(), slots.data_ptr(), n, s, h,
                w, out.data_ptr(), K.stream_ptr(dev))
        K.check_status(status, "mask_paste kernel")
        K.count_launch("mask_paste")
    return out
