"""ctypes bindings of the multi-level RoIAlign forward kernel
(``csrc/roi_align.cu``) and its backward (``csrc/roi_align_bwd.cu``)."""
from __future__ import annotations

import ctypes

import torch

from tpuseg_torch import kernels as K

_ENTRY = {torch.float32: "tpuseg_roi_align_f32",
          torch.bfloat16: "tpuseg_roi_align_bf16"}
_ENTRY_BWD = {torch.float32: "tpuseg_roi_align_bwd_f32",
              torch.bfloat16: "tpuseg_roi_align_bwd_bf16"}


def _check_rois(boxes, batch_idx, levels, dev) -> int:
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
    return n


def _pyramid_args(ptrs, level_hw, strides) -> tuple:
    """Host arrays of the C entry points: level pointers, heights, widths,
    scales (kept alive by the caller while the launch is issued)."""
    nl = len(ptrs)
    if not 1 <= nl <= 4 or len(strides) != nl:
        raise ValueError(f"roi_align kernel: {nl} levels, {len(strides)} "
                         "strides (1 to 4 levels)")
    return ((ctypes.c_void_p * nl)(*ptrs),
            (ctypes.c_int * nl)(*(h for h, _ in level_hw)),
            (ctypes.c_int * nl)(*(w for _, w in level_hw)),
            (ctypes.c_float * nl)(*(1.0 / st for st in strides)))


def _launch(entry, arrays, b, c, boxes, batch_idx, levels, n, p, s, tensor,
            dev, *flags) -> None:
    fn = getattr(K.library(), entry)
    with torch.cuda.device(dev):
        status = fn(*(ctypes.addressof(a) for a in arrays), len(arrays[0]),
                    b, c, boxes.data_ptr(), batch_idx.data_ptr(),
                    levels.data_ptr(), n, p, s, tensor.data_ptr(), *flags,
                    K.stream_ptr(dev))
    K.check_status(status, entry)


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
    for i, f in enumerate(feats):
        K.check_tensor(f, f"feats[{i}]", device=dev, dtypes=tuple(_ENTRY),
                       ndim=4, channels_last=True)
        if f.dtype != f0.dtype or f.shape[:2] != f0.shape[:2]:
            raise ValueError(f"roi_align kernel: level {i} is {f.dtype} "
                             f"{tuple(f.shape)}, level 0 {f0.dtype} "
                             f"{tuple(f0.shape)}")
    n = _check_rois(boxes, batch_idx, levels, dev)
    arrays = _pyramid_args([f.data_ptr() for f in feats],
                           [tuple(f.shape[2:]) for f in feats], strides)
    b, c = f0.shape[:2]
    p, s = output_size, sampling_ratio
    out = torch.empty((n, p, p, c), dtype=f0.dtype, device=dev)
    if n:
        _launch(_ENTRY[f0.dtype], arrays, b, c, boxes, batch_idx, levels, n,
                p, s, out, dev)
        K.LAUNCHES["roi_align"] += 1
    return out.permute(0, 3, 1, 2)


def multilevel_roi_align_backward(grad: torch.Tensor, boxes: torch.Tensor,
                                  batch_idx: torch.Tensor,
                                  levels: torch.Tensor, feat_shapes,
                                  dtype: torch.dtype, output_size: int,
                                  sampling_ratio: int, strides,
                                  merge: bool = True) -> tuple:
    """grad: d(pooled) [N, C, P, P], f32 or bf16, contiguous or
    channels-last (the kernel reads either layout); ``feat_shapes`` the
    levels' [B, C, H_l, W_l]; boxes, batch_idx, levels as the forward.
    ``merge=False`` adds every corner straight into the buffers, without
    summing a roi's adds in shared memory first (to time and test the
    kernel's direct branch on any rois).
    -> per-level d(feats) [B, C, H_l, W_l] in ``dtype`` (channels-last
    storage), accumulated in zeroed f32 buffers and cast once."""
    dev = grad.device
    if dev.type != "cuda":
        raise ValueError(f"roi_align_bwd kernel: grad on {dev}, expected CUDA")
    nchw = grad.is_contiguous()
    K.check_tensor(grad, "grad", device=dev, dtypes=tuple(_ENTRY_BWD), ndim=4,
                   channels_last=not nchw)
    if dtype not in _ENTRY:
        raise ValueError(f"roi_align_bwd kernel: feature dtype {dtype}")
    n = _check_rois(boxes, batch_idx, levels, dev)
    b, c = feat_shapes[0][:2]
    p, s = output_size, sampling_ratio
    if grad.shape != (n, c, p, p) or any(tuple(sh[:2]) != (b, c)
                                         for sh in feat_shapes):
        raise ValueError(f"roi_align_bwd kernel: grad {tuple(grad.shape)}, "
                         f"levels {[tuple(sh) for sh in feat_shapes]}")
    # one zeroed f32 buffer for all levels (one fill, one cast)
    sizes = [b * sh[2] * sh[3] * c for sh in feat_shapes]
    acc = torch.zeros(sum(sizes), dtype=torch.float32, device=dev)
    parts = acc.split(sizes)
    arrays = _pyramid_args([a.data_ptr() for a in parts],
                           [tuple(sh[2:]) for sh in feat_shapes], strides)
    if n:
        _launch(_ENTRY_BWD[grad.dtype], arrays, b, c, boxes, batch_idx,
                levels, n, p, s, grad, dev, int(nchw), int(merge))
        K.LAUNCHES["roi_align_bwd"] += 1
    return tuple(a.view(b, sh[2], sh[3], c).permute(0, 3, 1, 2)
                 for a, sh in zip(acc.to(dtype).split(sizes), feat_shapes))
