"""The plain reference of Mask R-CNN inference as a user of the predictor
receives each image, written from maskrcnn-benchmark's
``modeling/roi_heads/box_head/inference.py::PostProcessor`` (softmax, box
decode with weights (10, 10, 5, 5), clip, per-class NMS at 0.5 over the
scores past 0.05, the best ``detections_per_img`` kept by ``kthvalue``),
``mask_head/inference.py::Masker`` (``paste_mask_in_image``: the 28x28
mask zero-padded by one, its box expanded by the same factor and truncated
to integers, a half-pixel bilinear resize, a 0.5 threshold) and
``demo/predictor.py::COCODemo`` (the boxes resized to the image before the
paste). The RPN proposals, the pooler and the NMS are ``frozen/``'s plain
ones; the model is any of ``frozen/``'s R-CNNs with ``backbone``,
``rpn.head``, ``roi_heads.box`` and ``roi_heads.mask``. Float32 with TF32
off under ``reference/exact.py``; it imports nothing of the port.

Preprocessing (maskrcnn-benchmark's and detectron2's test resize, PIL
bilinear on uint8): the short side to ``min_size``, the long side at most
``max_size``, on a (min_size, ceil64(max_size)) canvas or its transpose,
zero past the image; BGR less the Caffe2 mean, or RGB as (x - mean) / std.

:func:`class_calibration` calibrates the benchmark's random class layer:
each class's logit centred and all scaled to one spread over the
calibration images' proposals, then the background logit shifted
(:func:`background_shift`) until no image sends more than ``most``
class-box candidates past the score gate to the final NMS.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import boxes as box_ops
from . import maskrcnn as M
from . import nms as nms_ops

CAFFE2_MEAN_BGR = (102.9801, 115.9465, 122.7717)


def canvas(img_rgb: np.ndarray, min_size: int, max_size: int,
           rgb_norm=None) -> tuple:
    """uint8 RGB [h, w, 3] -> (float32 [3, Hc, Wc] canvas, (th, tw))."""
    from PIL import Image

    h, w = img_rgb.shape[:2]
    size = min_size
    if max(h, w) / min(h, w) * size > max_size:
        size = int(round(max_size * min(h, w) / max(h, w)))
    if (w <= h and w == size) or (h <= w and h == size):
        th, tw = h, w
    elif w < h:
        th, tw = int(size * h / w), size
    else:
        th, tw = size, int(size * w / h)
    long_edge = -(-max_size // 64) * 64
    th, tw = min(th, long_edge), min(tw, long_edge)
    hc, wc = (min_size, long_edge) if tw >= th else (long_edge, min_size)
    img = (img_rgb if (th, tw) == (h, w) else np.asarray(
        Image.fromarray(np.ascontiguousarray(img_rgb)).resize(
            (tw, th), Image.BILINEAR))).astype(np.float32)
    if rgb_norm is None:
        img = img[:, :, ::-1] - np.asarray(CAFFE2_MEAN_BGR, np.float32)
    else:
        mean, std = (np.asarray(v, np.float32) for v in rgb_norm)
        img = (img - mean) / std
    out = np.zeros((hc, wc, 3), np.float32)
    out[:th, :tw] = img
    return out.transpose(2, 0, 1).copy(), (th, tw)


def proposals_and_features(model, image: torch.Tensor, hw: tuple) -> tuple:
    """One canvas [3, Hc, Wc] -> (the valid proposals [P, 4], P2..P5)."""
    cfg = model.cfg
    canvas_hw = tuple(image.shape[-2:])
    pyramid = model.backbone(image[None])
    logits, deltas = model.rpn.head(pyramid)
    anchors = M._anchors_on(cfg, canvas_hw[0], canvas_hw[1], image.device)
    image_hw = torch.tensor([hw], dtype=torch.int64, device=image.device)
    props, _, valid = M.rpn_proposals(logits, deltas, anchors, image_hw, cfg,
                                      canvas_hw)
    return props[0][valid[0]], pyramid[:4]


def pool(model, feats, boxes: torch.Tensor, resolution: int):
    return M.pooled_roi_features(
        feats, boxes, torch.zeros(len(boxes), dtype=torch.int64,
                                  device=boxes.device),
        resolution, model.cfg.pooler_sampling_ratio)


def class_logits(model, image: torch.Tensor, hw: tuple) -> torch.Tensor:
    """The box head's class logits [P, K] of one canvas's proposals."""
    props, feats = proposals_and_features(model, image, hw)
    return model.roi_heads.box(pool(model, feats, props,
                                    model.cfg.pooler_resolution))[0]


def detect(model, image: torch.Tensor, hw: tuple) -> dict:
    """PostProcessor and the mask head on one canvas -> boxes [n, 4] in
    canvas pixels, scores, labels (1..K-1), mask probabilities [n, 28, 28]."""
    cfg = model.cfg
    props, feats = proposals_and_features(model, image, hw)
    logits, regression = model.roi_heads.box(
        pool(model, feats, props, cfg.pooler_resolution))
    prob = F.softmax(logits, -1)
    k = prob.shape[1]
    boxes = box_ops.decode_boxes(regression, props,
                                 weights=cfg.box_reg_weights).reshape(-1, k, 4)
    th, tw = hw
    boxes = torch.stack([boxes[..., 0].clamp(0, tw - 1),
                         boxes[..., 1].clamp(0, th - 1),
                         boxes[..., 2].clamp(0, tw - 1),
                         boxes[..., 3].clamp(0, th - 1)], -1)
    out_b, out_s, out_l = [], [], []
    for j in range(1, k):
        inds = torch.nonzero(prob[:, j] > cfg.score_thresh).squeeze(1)
        if len(inds) == 0:
            continue
        bj, sj = boxes[inds, j], prob[inds, j]
        keep = nms_ops.nms_mask(bj[None], sj[None], cfg.nms_thresh,
                                to_remove=1.0)[0]
        out_b.append(bj[keep])
        out_s.append(sj[keep])
        out_l.append(torch.full((int(keep.sum()),), j, dtype=torch.int64,
                                device=image.device))
    if out_b:
        det_b, det_s, det_l = (torch.cat(t) for t in (out_b, out_s, out_l))
    else:
        det_b = boxes.new_zeros((0, 4))
        det_s = prob.new_zeros((0,))
        det_l = torch.zeros((0,), dtype=torch.int64, device=image.device)
    n = len(det_s)
    if n > cfg.detections_per_img > 0:
        thresh, _ = torch.kthvalue(det_s.cpu(), n - cfg.detections_per_img + 1)
        keep = det_s >= thresh.item()
        det_b, det_s, det_l = det_b[keep], det_s[keep], det_l[keep]
    masks = torch.sigmoid(model.roi_heads.mask(
        pool(model, feats, det_b, cfg.mask_resolution), det_l))
    return {"boxes": det_b, "scores": det_s, "labels": det_l, "masks": masks}


def paste_mask_in_image(mask: torch.Tensor, box: torch.Tensor, im_h: int,
                        im_w: int, thresh: float = 0.5,
                        padding: int = 1) -> torch.Tensor:
    m = mask.shape[-1]
    scale = float(m + 2 * padding) / m
    padded = mask.new_zeros((1, 1, m + 2 * padding, m + 2 * padding))
    padded[:, :, padding:-padding, padding:-padding] = mask
    w_half = (box[2] - box[0]) * .5 * scale
    h_half = (box[3] - box[1]) * .5 * scale
    x_c = (box[2] + box[0]) * .5
    y_c = (box[3] + box[1]) * .5
    box = torch.stack([x_c - w_half, y_c - h_half, x_c + w_half,
                       y_c + h_half]).to(torch.int32).tolist()
    w = max(box[2] - box[0] + 1, 1)
    h = max(box[3] - box[1] + 1, 1)
    resized = F.interpolate(padded.float(), size=(h, w), mode="bilinear",
                            align_corners=False)[0, 0] > thresh
    im_mask = torch.zeros((im_h, im_w), dtype=torch.uint8,
                          device=mask.device)
    x0, x1 = max(box[0], 0), min(box[2] + 1, im_w)
    y0, y1 = max(box[1], 0), min(box[3] + 1, im_h)
    if x1 > x0 and y1 > y0:
        im_mask[y0:y1, x0:x1] = resized[y0 - box[1]:y1 - box[1],
                                        x0 - box[0]:x1 - box[0]]
    return im_mask


def postprocess(det: dict, hw: tuple, h: int, w: int) -> dict:
    """Canvas detections -> what the user receives for an h x w image
    (boxes resized by w / tw and h / th, then the masks pasted), and
    ``cell``: the 28x28 grid's cell of the largest kept box, in pixels."""
    th, tw = hw
    boxes = det["boxes"] * torch.tensor([w / tw, h / th, w / tw, h / th],
                                        device=det["boxes"].device)
    masks = [paste_mask_in_image(m, b, h, w)
             for m, b in zip(det["masks"], boxes)]
    masks = (torch.stack(masks) if masks else
             torch.zeros((0, h, w), dtype=torch.uint8))
    ext = boxes[:, 2:] - boxes[:, :2]
    big = int(torch.argmax(ext.prod(1))) if len(ext) else None
    cell = ((float(ext[big, 1]) / det["masks"].shape[-2],
             float(ext[big, 0]) / det["masks"].shape[-1])
            if big is not None else (1.0, 1.0))
    return {"boxes": boxes.cpu().numpy(),
            "scores": det["scores"].cpu().numpy(),
            "classes": (det["labels"] - 1).cpu().numpy(),
            "masks": masks.cpu().numpy(), "cell": cell}


def requests(model, frames: list, min_size: int, max_size: int, dev,
             rgb_norm=None):
    """Each uint8 RGB frame -> its detections, one frame at a time (a
    generator: a frame's masks take up to 100 x h x w bytes)."""
    for img in frames:
        x, hw = canvas(img, min_size, max_size, rgb_norm)
        det = detect(model, torch.from_numpy(x).to(dev), hw)
        yield postprocess(det, hw, img.shape[0], img.shape[1])


def background_shift(logits: list, score_thresh: float, most: int,
                     grid=np.arange(-30.0, 120.0, 0.05)) -> float:
    """The least shift of the background logit (on ``grid``) after which
    no image sends more than ``most`` class-box pairs with a foreground
    score past ``score_thresh`` to the final NMS; ``logits`` the images'
    [P, K] class logits. The count falls as the shift grows, so this is
    the shift that keeps the most detections within ``most``."""
    gate = float(np.log(score_thresh))
    counts = []
    for lg in logits:
        lg = lg.double()
        fg = lg[:, 1:]
        lse = torch.logsumexp(fg, -1)
        n = []
        for part in np.array_split(grid, max(1, len(grid) // 100)):
            d = torch.as_tensor(part, dtype=torch.float64, device=lg.device)
            denom = torch.logaddexp(lg[None, :, 0] + d[:, None], lse[None])
            n.append(((fg[None] - denom[..., None]) > gate).sum((1, 2)))
        counts.append(torch.cat(n))
    ok = (torch.stack(counts) <= most).all(0)  # [grid]
    if not bool(ok.any()):
        raise AssertionError(f"no background shift keeps {most} candidates "
                             "an image")
    return float(grid[int(torch.nonzero(ok)[0])])


def class_calibration(logits: list, bias: torch.Tensor, score_thresh: float,
                      spread: float = 2.0, most: int = 300) -> tuple:
    """-> (scale, new bias [K]) of the class layer whose bias is ``bias``
    and whose logits on the calibration images' proposals are ``logits``
    ([P, K] each): the weights times ``scale`` and the new bias give each
    class a mean logit of 0 over those proposals (the background's then
    shifted by :func:`background_shift`) and the foreground logits a
    standard deviation about their classes' means of ``spread``, whatever
    the features' scale."""
    b = bias.double().to(logits[0].device)
    z = [lg.double() - b for lg in logits]  # the weights' part
    mu = torch.cat(z).mean(0)
    scale = spread / float((torch.cat(z)[:, 1:] - mu[1:]).std())
    centred = [(zi - mu) * scale for zi in z]
    new_bias = -mu * scale
    new_bias[0] += background_shift(centred, score_thresh, most)
    return scale, new_bias.float()

