"""Records, in a traced run, what each call of the port's kernel entry
points (``tpuseg_torch/kernels/*.py``) was given, so that a roofline
reader can work out the call's least time from its shapes afterwards. Only
small tensors are kept (the rois, the sample coordinates), and of the DCN
sampler only the first KEEP calls (13 a YOLACT++ forward, the same
geometries each time); ``counts`` has every call."""
from __future__ import annotations

import functools

KEEP = {"roi_align": 1 << 30, "roi_align_bwd": 1 << 30, "dcn_sample": 65}


def record(calls: dict, counts: dict):
    """Wrap the entry points; -> an undo function. ``calls`` gets
    ``roi_align``, ``roi_align_bwd`` and ``dcn_sample`` lists of what was
    kept, ``counts`` the number of calls of each."""
    from tpuseg_torch.kernels import dcn as KD
    from tpuseg_torch.kernels import roi_align as KR

    undo = []

    def wrap(owner, attr, key, keep):
        fn = getattr(owner, attr)
        rec = calls.setdefault(key, [])

        counts[key] = 0

        @functools.wraps(fn)
        def run(*args, **kwargs):
            counts[key] += 1
            if len(rec) < KEEP[key]:
                rec.append(keep(*args, **kwargs))
            return fn(*args, **kwargs)

        setattr(owner, attr, run)
        undo.append((owner, attr, fn))

    def roi_fwd(feats, boxes, batch_idx, levels, p, s, strides, *_, **__):
        return {"level_hw": [tuple(f.shape[2:]) for f in feats],
                "c": feats[0].shape[1], "itemsize": feats[0].element_size(),
                "boxes": boxes.detach().clone(), "bidx": batch_idx.clone(),
                "levels": levels.clone(), "p": p, "s": s,
                "strides": tuple(strides)}

    def roi_bwd(grad, boxes, batch_idx, levels, feat_shapes, dtype, p, s,
                strides, *_, **__):
        # the gradient is added into f32 buffers whatever the dtype
        return {"level_hw": [tuple(sh[2:]) for sh in feat_shapes],
                "c": feat_shapes[0][1], "itemsize": 4,
                "pooled_itemsize": grad.element_size(),
                "boxes": boxes.detach().clone(), "bidx": batch_idx.clone(),
                "levels": levels.clone(), "p": p, "s": s,
                "strides": tuple(strides)}

    def dcn_fwd(feats, sy, sx, m=None, *_, **__):
        return {"shape": tuple(feats.shape), "itemsize": feats.element_size(),
                "sy": sy.detach().clone(), "sx": sx.detach().clone()}

    wrap(KR, "multilevel_roi_align", "roi_align", roi_fwd)
    wrap(KR, "multilevel_roi_align_backward", "roi_align_bwd", roi_bwd)
    wrap(KD, "sample_points", "dcn_sample", dcn_fwd)

    def restore():
        for owner, attr, fn in reversed(undo):
            setattr(owner, attr, fn)

    return restore
