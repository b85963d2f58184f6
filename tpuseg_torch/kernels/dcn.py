"""ctypes binding of the DCN sampling kernel (``csrc/dcn_sample.cu``)."""
from __future__ import annotations

import torch

from tpuseg_torch import kernels as K

_ENTRY = {torch.float32: "tpuseg_dcn_sample_f32",
          torch.bfloat16: "tpuseg_dcn_sample_bf16"}


def sample_points(feats: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor,
                  m: torch.Tensor | None = None) -> torch.Tensor:
    """feats [B, C, H, W] in ``torch.channels_last`` memory format (f32 or
    bf16); sy, sx and m (or None) [B, S] f32 contiguous -> [B, S, C] in the
    feature dtype: ``ops/sampling.py::sample_points_plain``'s function."""
    dev = feats.device
    if dev.type != "cuda":
        raise ValueError(f"dcn_sample kernel: features on {dev}, "
                         "expected CUDA")
    K.check_tensor(feats, "feats", device=dev, dtypes=tuple(_ENTRY), ndim=4,
                   channels_last=True)
    b, c, h, w = feats.shape
    for name, t in (("sy", sy), ("sx", sx), ("m", m)):
        if t is None:
            continue
        K.check_tensor(t, name, device=dev, dtypes=(torch.float32,), ndim=2)
        if t.shape[0] != b or t.shape != sy.shape:
            raise ValueError(f"dcn_sample kernel: {name} {tuple(t.shape)}, sy "
                             f"{tuple(sy.shape)}, feats {tuple(feats.shape)}")
    s = sy.shape[1]
    if s >= 2 ** 31:  # passed as a C int
        raise ValueError(f"dcn_sample kernel: {s} samples per image")
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
