"""ctypes bindings of the DCN sampling kernel (``csrc/dcn_sample.cu``) and
its backward (``csrc/dcn_sample_bwd.cu``)."""
from __future__ import annotations

import torch

from tpuseg_torch import kernels as K

_ENTRY = {torch.float32: "tpuseg_dcn_sample_f32",
          torch.bfloat16: "tpuseg_dcn_sample_bf16"}
_ENTRY_BWD = {torch.float32: "tpuseg_dcn_sample_bwd_f32",
              torch.bfloat16: "tpuseg_dcn_sample_bwd_bf16"}


def _check_points(feats, sy, sx, m, name: str) -> int:
    """Raise unless feats [B, C, H, W] is channels-last f32 or bf16 on a
    CUDA device and sy, sx, m (or None) are f32 [B, S] there; -> S."""
    dev = feats.device
    if dev.type != "cuda":
        raise ValueError(f"{name} kernel: features on {dev}, expected CUDA")
    K.check_tensor(feats, "feats", device=dev, dtypes=tuple(_ENTRY), ndim=4,
                   channels_last=True)
    for arg, t in (("sy", sy), ("sx", sx), ("m", m)):
        if t is None:
            continue
        K.check_tensor(t, arg, device=dev, dtypes=(torch.float32,), ndim=2)
        if t.shape[0] != feats.shape[0] or t.shape != sy.shape:
            raise ValueError(f"{name} kernel: {arg} {tuple(t.shape)}, sy "
                             f"{tuple(sy.shape)}, feats {tuple(feats.shape)}")
    s = sy.shape[1]
    if s >= 2 ** 31:  # passed as a C int
        raise ValueError(f"{name} kernel: {s} samples per image")
    return s


def sample_points(feats: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor,
                  m: torch.Tensor | None = None) -> torch.Tensor:
    """feats [B, C, H, W] in ``torch.channels_last`` memory format (f32 or
    bf16); sy, sx and m (or None) [B, S] f32 contiguous -> [B, S, C] in the
    feature dtype: ``ops/sampling.py::sample_points_plain``'s function."""
    s = _check_points(feats, sy, sx, m, "dcn_sample")
    b, c, h, w = feats.shape
    dev = feats.device
    out = torch.empty((b, s, c), dtype=feats.dtype, device=dev)
    if b * s * c:
        fn = getattr(K.library(), _ENTRY[feats.dtype])
        with torch.cuda.device(dev):
            status = fn(feats.data_ptr(), sy.data_ptr(), sx.data_ptr(),
                        None if m is None else m.data_ptr(), b, h, w, c, s,
                        out.data_ptr(), K.stream_ptr(dev))
        K.check_status(status, "dcn_sample kernel")
        K.LAUNCHES["dcn_sample"] += 1
    return out


def sample_points_backward(grad: torch.Tensor, feats: torch.Tensor,
                           sy: torch.Tensor, sx: torch.Tensor,
                           m: torch.Tensor | None = None,
                           feats_grad: bool = True,
                           coords_grad: bool = True) -> tuple:
    """grad: d(sampled) [B, S, C] contiguous in the feature dtype; feats,
    sy, sx, m as :func:`sample_points`. -> (d feats [B, C, H, W] in the
    feature dtype, channels-last storage, accumulated in a zeroed f32
    buffer and cast once; d sy, d sx, d m [B, S] f32), each None where not
    asked for (``feats_grad``, ``coords_grad``; d m also without ``m``):
    ``ops/sampling.py::sample_points_backward_plain``'s function."""
    s = _check_points(feats, sy, sx, m, "dcn_sample_bwd")
    b, c, h, w = feats.shape
    dev = feats.device
    K.check_tensor(grad, "grad", device=dev, dtypes=(feats.dtype,), ndim=3)
    if grad.shape != (b, s, c):
        raise ValueError(f"dcn_sample_bwd kernel: grad {tuple(grad.shape)}, "
                         f"feats {tuple(feats.shape)}, {s} samples")
    acc = (torch.zeros((b, h, w, c), dtype=torch.float32, device=dev)
           if feats_grad else None)
    dsy, dsx, dm = (None,) * 3
    if coords_grad:
        dsy, dsx = (torch.empty((b, s), dtype=torch.float32, device=dev)
                    for _ in range(2))
        dm = None if m is None else torch.empty_like(dsy)
    if b * s and (feats_grad or coords_grad):
        fn = getattr(K.library(), _ENTRY_BWD[feats.dtype])
        ptr = [None if t is None else t.data_ptr()
               for t in (acc, dsy, dsx, dm)]
        with torch.cuda.device(dev):
            status = fn(feats.data_ptr(), sy.data_ptr(), sx.data_ptr(),
                        None if m is None else m.data_ptr(), grad.data_ptr(),
                        b, h, w, c, s, *ptr, K.stream_ptr(dev))
        K.check_status(status, "dcn_sample_bwd kernel")
        K.LAUNCHES["dcn_sample_bwd"] += 1
    df = None if acc is None else acc.permute(0, 3, 1, 2).to(feats.dtype)
    return df, dsy, dsx, dm
