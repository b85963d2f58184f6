"""ctypes binding of the multi-level RoIAlign forward kernel
(``csrc/roi_align.cu``)."""
from __future__ import annotations

import ctypes

import torch

from tpuseg_torch import kernels as K

_ENTRY = {torch.float32: "tpuseg_roi_align_f32",
          torch.bfloat16: "tpuseg_roi_align_bf16"}


def multilevel_roi_align(feats, boxes: torch.Tensor, batch_idx: torch.Tensor,
                         levels: torch.Tensor, output_size: int,
                         sampling_ratio: int, strides) -> torch.Tensor:
    """feats: up to 4 [B, C, H_l, W_l] levels in ``torch.channels_last``
    memory format (f32 or bf16); boxes [N, 4] f32; batch_idx, levels [N]
    int32. -> [N, C, P, P] in the feature dtype, channels-last storage."""
    f0 = feats[0]
    dev = f0.device
    if dev.type != "cuda":
        raise ValueError(f"roi_align kernel: features on {dev}, expected CUDA")
    if not 1 <= len(feats) <= 4 or len(strides) != len(feats):
        raise ValueError(f"roi_align kernel: {len(feats)} levels, "
                         f"{len(strides)} strides (1 to 4 levels)")
    for i, f in enumerate(feats):
        K.check_tensor(f, f"feats[{i}]", device=dev, dtypes=tuple(_ENTRY),
                       ndim=4, channels_last=True)
        if f.dtype != f0.dtype or f.shape[:2] != f0.shape[:2]:
            raise ValueError(f"roi_align kernel: level {i} is {f.dtype} "
                             f"{tuple(f.shape)}, level 0 {f0.dtype} "
                             f"{tuple(f0.shape)}")
    K.check_tensor(boxes, "boxes", device=dev, dtypes=(torch.float32,),
                   ndim=2, align=16)
    K.check_tensor(batch_idx, "batch_idx", device=dev, dtypes=(torch.int32,),
                   ndim=1)
    K.check_tensor(levels, "levels", device=dev, dtypes=(torch.int32,), ndim=1)
    n = boxes.shape[0]
    if boxes.shape[1] != 4 or batch_idx.shape[0] != n or levels.shape[0] != n:
        raise ValueError(f"roi_align kernel: boxes {tuple(boxes.shape)}, "
                         f"batch_idx {tuple(batch_idx.shape)}, levels "
                         f"{tuple(levels.shape)}")
    b, c = f0.shape[:2]
    p, s = output_size, sampling_ratio
    out = torch.empty((n, p, p, c), dtype=f0.dtype, device=dev)
    if n == 0:
        return out.permute(0, 3, 1, 2)
    nl = len(feats)
    data = (ctypes.c_void_p * nl)(*(f.data_ptr() for f in feats))
    heights = (ctypes.c_int * nl)(*(f.shape[2] for f in feats))
    widths = (ctypes.c_int * nl)(*(f.shape[3] for f in feats))
    scales = (ctypes.c_float * nl)(*(1.0 / st for st in strides))
    fn = getattr(K.library(), _ENTRY[f0.dtype])
    with torch.cuda.device(dev):
        status = fn(ctypes.addressof(data), ctypes.addressof(heights),
                    ctypes.addressof(widths), ctypes.addressof(scales), nl, b,
                    c, boxes.data_ptr(), batch_idx.data_ptr(),
                    levels.data_ptr(), n, p, s, out.data_ptr(),
                    K.stream_ptr(dev))
    K.check_status(status, "roi_align kernel")
    K.LAUNCHES["roi_align"] += 1
    return out.permute(0, 3, 1, 2)
