"""Faults planted under the timed path, each with pytest's ``monkeypatch``,
for the tests that see ``correct`` come out false. A fault of the kernels
is planted in the kernel's entry point, which runs on the card alone."""
from __future__ import annotations

import torch


def state_unchanged(mp) -> None:
    """Every step leaves the parameters as they were (a zero lr)."""
    from tpuseg_torch.engine import detectron_train_loop as TL

    set_lr = TL.set_lr
    mp.setattr(TL, "set_lr", lambda opt, lr: set_lr(opt, 0.0))


def half_batch(mp, from_call: int = 1) -> None:
    """From the ``from_call``-th step on, the losses of the first half of
    the batch alone, their mean taken over it."""
    from tpuseg_torch.engine import detectron_train_loop as TL

    losses = TL.train_losses
    calls = [0]

    def half(model, images, image_hw, targets, generator=None):
        calls[0] += 1
        if calls[0] < from_call:
            return losses(model, images, image_hw, targets, generator)
        k = images.shape[0] // 2
        return losses(model, images[:k], image_hw[:k],
                      {n: t[:k] for n, t in targets.items()}, generator)

    mp.setattr(TL, "train_losses", half)


def roi_level_below(mp) -> None:
    """K2: each roi pooled from the pyramid level below its own."""
    from tpuseg_torch.kernels import roi_align as KR

    fn = KR.multilevel_roi_align

    def fault(feats, boxes, batch_idx, levels, *args, **kwargs):
        return fn(feats, boxes, batch_idx, (levels - 1).clamp(min=0), *args,
                  **kwargs)

    mp.setattr(KR, "multilevel_roi_align", fault)


def roi_grad_second_image_left_out(mp) -> None:
    """K3: the gradient of the batch's second image's rois left out."""
    from tpuseg_torch.kernels import roi_align as KR

    fn = KR.multilevel_roi_align_backward

    def fault(grad, boxes, batch_idx, *args, **kwargs):
        keep = (batch_idx == 0).to(grad.dtype)[:, None, None, None]
        return fn(grad * keep, boxes, batch_idx, *args, **kwargs)

    mp.setattr(KR, "multilevel_roi_align_backward", fault)


def classes_moved(mp) -> None:
    """An answer altered where it is produced: each detection's class
    moved by one."""
    from tpuseg_torch.engine.yolact_engine import YolactPredictor

    post = YolactPredictor.postprocess_image

    def altered(self, det_i, h, w, score_threshold=0.0):
        out = post(self, det_i, h, w, score_threshold)
        out["classes"] = (out["classes"] + 1) % 80
        return out

    mp.setattr(YolactPredictor, "postprocess_image", altered)


class _NearestUpsampling:
    """``torch.nn.functional`` with ``interpolate`` taking the nearest
    pixel."""

    def __getattr__(self, name):
        return getattr(torch.nn.functional, name)

    @staticmethod
    def interpolate(x, size=None, mode="nearest", align_corners=None, **kw):
        return torch.nn.functional.interpolate(x, size=size, mode="nearest",
                                               **kw)


def masks_nearest(mp) -> None:
    """The host's mask upsampling takes the nearest prototype pixel where
    it interpolates bilinearly."""
    from tpuseg_torch.engine import yolact_engine

    mp.setattr(yolact_engine, "F", _NearestUpsampling())
