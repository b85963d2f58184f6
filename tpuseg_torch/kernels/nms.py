"""ctypes binding of the NMS kernel (``csrc/nms.cu``).

The score sort is plain torch in :func:`tpuseg_torch.ops.nms.nms_mask_batch`;
the kernel reads the boxes through its order and writes the keep mask back
in the boxes' own order.
"""
from __future__ import annotations

import ctypes

import torch

from tpuseg_torch import kernels as K


def mask_words(b: int, n: int) -> int:
    """u64 words of the kernel's suppression mask: the 64-word tiles on and
    above the diagonal of each image's ceil(N/64) x ceil(N/64) tile grid."""
    nb = -(-n // 64)
    return b * nb * (nb + 1) // 2 * 64


def nms_keep(boxes: torch.Tensor, order: torch.Tensor, svalid: torch.Tensor,
             iou_threshold: float, to_remove: float = 0.0) -> torch.Tensor:
    """Greedy NMS: boxes [B, N, 4] f32 in their own order, ``order`` [B, N]
    int64 (each image's indices in descending score), ``svalid`` [B, N]
    bool in that sorted order -> keep [B, N] bool in the boxes' own order."""
    dev = boxes.device
    if dev.type != "cuda":
        raise ValueError(f"nms kernel: boxes on {dev}, expected a CUDA device")
    K.check_tensor(boxes, "boxes", device=dev, dtypes=(torch.float32,),
                   ndim=3, align=16)
    K.check_tensor(order, "order", device=dev, dtypes=(torch.int64,), ndim=2)
    K.check_tensor(svalid, "valid", device=dev, dtypes=(torch.bool,), ndim=2)
    b, n = svalid.shape
    if boxes.shape != (b, n, 4) or order.shape != (b, n):
        raise ValueError(f"nms kernel: boxes {tuple(boxes.shape)}, order "
                         f"{tuple(order.shape)}, valid {tuple(svalid.shape)}")
    if b > 65535:
        raise ValueError(f"nms kernel: {b} images, at most 65535")
    keep = torch.empty((b, n), dtype=torch.bool, device=dev)
    if b == 0 or n == 0:
        return keep
    mask = torch.empty(mask_words(b, n), dtype=torch.int64, device=dev)
    lib = K.library()
    with torch.cuda.device(dev):
        status = lib.tpuseg_nms_mask(
            boxes.data_ptr(), order.data_ptr(), svalid.data_ptr(),
            mask.data_ptr(), keep.data_ptr(), b, n,
            ctypes.c_float(iou_threshold), ctypes.c_float(to_remove),
            K.stream_ptr(dev))
    K.check_status(status, "nms kernel")
    K.count_launch("nms")
    return keep
