"""ctypes binding of the NMS kernel (``csrc/nms.cu``).

Takes score-sorted boxes; the sort and the scatter back to the original
order are plain torch in :func:`tpuseg_torch.ops.nms.nms_mask_batch`.
"""
from __future__ import annotations

import ctypes

import torch

from tpuseg_torch import kernels as K


def nms_keep_sorted(sboxes: torch.Tensor, svalid: torch.Tensor,
                    iou_threshold: float, to_remove: float = 0.0) -> torch.Tensor:
    """Greedy NMS over score-sorted boxes: [B, N, 4] f32, [B, N] bool ->
    keep [B, N] bool, in the sorted order."""
    dev = sboxes.device
    if dev.type != "cuda":
        raise ValueError(f"nms kernel: boxes on {dev}, expected a CUDA device")
    K.check_tensor(sboxes, "boxes", device=dev, dtypes=(torch.float32,),
                   ndim=3, align=16)
    K.check_tensor(svalid, "valid", device=dev, dtypes=(torch.bool,), ndim=2)
    b, n = svalid.shape
    if sboxes.shape != (b, n, 4):
        raise ValueError(f"nms kernel: boxes {tuple(sboxes.shape)} vs valid "
                         f"{tuple(svalid.shape)}")
    keep = torch.empty((b, n), dtype=torch.bool, device=dev)
    if b == 0 or n == 0:
        return keep
    mask = torch.empty((b, n, -(-n // 64)), dtype=torch.int64, device=dev)
    lib = K.library()
    with torch.cuda.device(dev):
        status = lib.tpuseg_nms_mask(
            sboxes.data_ptr(), svalid.data_ptr(), mask.data_ptr(),
            keep.data_ptr(), b, n, ctypes.c_float(iou_threshold),
            ctypes.c_float(to_remove), K.stream_ptr(dev))
    K.check_status(status, "nms kernel")
    K.LAUNCHES["nms"] += 1
    return keep
