"""The detectron family's predictor and COCO evaluation (port of
``tpuseg/engine/maskrcnn_engine.py``; detectron.jittor COCODemo /
tools/test_net.py parity): Mask R-CNN and Faster R-CNN R-50/101-FPN
(``variant="fpn"``) and R-50/101-C4 (``"c4"``), RetinaNet R-50-FPN
(``"retinanet"``) and ViTDet-B Mask R-CNN (``"vitdet"``, inference).

Host side: shortest-edge-800 resize (PIL bilinear, only when the size
changes), BGR mean subtraction, placement on one of two static canvases
(landscape 800x1344, portrait 1344x800); ViTDet's config asks for its own
sizes (1024, on a 1024x1024 canvas) and RGB normalised by a mean and std.
Device side: the model's forward on ``device``. Post: the masks (28x28
FPN, 14x14 C4) pasted into image coordinates with upstream Masker
semantics; boxes-only models give no ``masks``. :func:`evaluate_coco`
scores a dataset with the port's COCOeval (``tpuseg_torch/eval``).

On a CUDA predictor the canvas is built on the card instead
(``kernels/canvas.py``): each uint8 frame goes up as it is, pinned, and
one kernel resizes it bit-equal to PIL's bilinear, normalises it and pads
it into the NCHW canvas; the host computes only the sizes
(:func:`canvas_geometry`). A CPU predictor builds it on the host
(:func:`preprocess_image_bgr`).

``run_on_bgr_images`` marks the program's spans ``predictor.request``,
``predictor.canvas``, ``predictor.run`` (the forward's issue),
``predictor.paste`` and ``predictor.download``, and counts
``predictor.images``, ``predictor.masks``, ``predictor.download_bytes``,
``predictor.upload_bytes`` and ``predictor.canvases_on_device``, under the
YOLACT predictor's names where it has them (``utils/timer.py``).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from tpuseg_torch.kernels import canvas as CV
from tpuseg_torch.models import maskrcnn as M
from tpuseg_torch.models import maskrcnn_c4 as C4
from tpuseg_torch.models import retinanet as RN
from tpuseg_torch.models import vitdet as VD
from tpuseg_torch.ops.preprocess import (DETECTRON_PIXEL_MEAN_BGR,
                                         detectron_target_size)
from tpuseg_torch.parallel.inference import ShardedInference
from tpuseg_torch.parallel.mesh import resolve_devices
from tpuseg_torch.utils import timer

# variant -> (model module, its config class); each module has
# build_model and forward_inference, and all but vitdet forward_train_losses.
# vitdet comes before fpn, since ViTDet's config extends the FPN one
VARIANTS = {"vitdet": (VD, VD.ViTDetConfig), "fpn": (M, M.MaskRCNNConfig),
            "c4": (C4, C4.MaskRCNNC4Config),
            "retinanet": (RN, RN.RetinaNetConfig)}


def variant_of(cfg) -> str:
    """The variant whose config class ``cfg`` is."""
    for variant, (_, config) in VARIANTS.items():
        if isinstance(cfg, config):
            return variant
    raise TypeError(f"not a detectron model config: {type(cfg).__name__}")


def model_module(cfg):
    """The module of ``cfg``'s variant: maskrcnn, maskrcnn_c4 or
    retinanet."""
    return VARIANTS[variant_of(cfg)][0]


def build_model(cfg, generator: torch.Generator | None = None):
    """The model of ``cfg``'s variant (its module's ``build_model``)."""
    return model_module(cfg).build_model(cfg, generator)


def preprocess_image_bgr(img_bgr: np.ndarray, min_size=800, max_size=1333,
                         rgb_norm: tuple | None = None):
    """-> (canvas float32 [Hc, Wc, 3], (th, tw) real size, (sy, sx) scales).

    The canvas is (min_size, ceil64(max_size)) or its transpose. PIL is
    imported only when the image must be resized. The pixels are BGR less
    maskrcnn-benchmark's mean, or with ``rgb_norm`` (mean, std), RGB as
    (x - mean) / std; the padding is 0 either way.
    """
    h, w = img_bgr.shape[:2]
    th, tw = detectron_target_size(h, w, min_size, max_size)
    long_edge = -(-max_size // 64) * 64
    # extreme aspect ratios can round the long edge past max_size
    th, tw = min(th, long_edge), min(tw, long_edge)
    canvas_hw = (min_size, long_edge) if tw >= th else (long_edge, min_size)
    if (th, tw) == (h, w):
        resized = img_bgr
    else:
        from PIL import Image

        pil = Image.fromarray(np.ascontiguousarray(img_bgr[:, :, ::-1]))
        resized = np.asarray(pil.resize((tw, th), Image.BILINEAR))[:, :, ::-1]
    canvas = np.zeros((*canvas_hw, 3), np.float32)
    if rgb_norm is None:
        canvas[:th, :tw] = resized.astype(np.float32) - np.asarray(
            DETECTRON_PIXEL_MEAN_BGR, np.float32)
    else:
        mean, std = (np.asarray(v, np.float32) for v in rgb_norm)
        rgb = resized[:, :, ::-1].astype(np.float32)
        canvas[:th, :tw] = (rgb - mean) / std
    return canvas, (th, tw), (th / h, tw / w)


def canvas_geometry(h: int, w: int, min_size=800, max_size=1333) -> tuple:
    """:func:`preprocess_image_bgr`'s sizes alone: an h x w image ->
    ((th, tw) its resized size, (Hc, Wc) its canvas)."""
    th, tw = detectron_target_size(h, w, min_size, max_size)
    long_edge = -(-max_size // 64) * 64
    th, tw = min(th, long_edge), min(tw, long_edge)
    return (th, tw), ((min_size, long_edge) if tw >= th
                      else (long_edge, min_size))


def paste_masks(masks28: torch.Tensor, boxes: torch.Tensor, im_h: int,
                im_w: int, thresh: float = 0.5, padding: int = 1) -> torch.Tensor:
    """Masker: [n, 28, 28] probabilities and [n, 4] image-coordinate boxes
    -> [n, im_h, im_w] uint8 masks on the masks' device.

    Each mask is zero-padded by ``padding``, its box expanded by the same
    factor and truncated to integers, the mask resized to the box with
    bilinear interpolation (half-pixel centres, as upstream's
    ``F.interpolate(align_corners=False)``), thresholded at ``thresh`` and
    placed, clipped to the image.
    """
    n, m = masks28.shape[0], masks28.shape[-1]
    out = torch.zeros((n, im_h, im_w), dtype=torch.uint8, device=masks28.device)
    if n == 0:
        return out
    padded = F.pad(masks28.float(), (padding,) * 4)
    scale = (m + 2 * padding) / m
    boxes = boxes.float()
    w_half = (boxes[:, 2] - boxes[:, 0]) * 0.5 * scale
    h_half = (boxes[:, 3] - boxes[:, 1]) * 0.5 * scale
    x_c = (boxes[:, 2] + boxes[:, 0]) * 0.5
    y_c = (boxes[:, 3] + boxes[:, 1]) * 0.5
    ebox = torch.stack([x_c - w_half, y_c - h_half, x_c + w_half,
                        y_c + h_half], 1).to(torch.int64).tolist()
    for i, (ex0, ey0, ex1, ey1) in enumerate(ebox):
        w = max(ex1 - ex0 + 1, 1)
        h = max(ey1 - ey0 + 1, 1)
        resized = F.interpolate(padded[i][None, None], size=(h, w),
                                mode="bilinear", align_corners=False)[0, 0]
        x0, x1 = max(ex0, 0), min(ex1 + 1, im_w)
        y0, y1 = max(ey0, 0), min(ey1 + 1, im_h)
        if x1 > x0 and y1 > y0:
            out[i, y0:y1, x0:x1] = (
                resized[y0 - ey0:y1 - ey0, x0 - ex0:x1 - ex0] > thresh)
    return out


class MaskRCNNPredictor:
    """COCODemo-equivalent programmatic API on ``device``.

    ``variant`` "fpn" (Mask R-CNN or, with ``mask_on=False``, Faster R-CNN
    R-50/101-FPN), "c4" (the same over R-50/101-C4) or "retinanet"; a
    ``cfg`` or a ``model`` passed in decides it instead. Weights: an
    upstream ``.pth`` (``weights``), a ready ``model``, or random weights
    from a ``torch.Generator`` seeded with ``seed`` (a ``model`` passed in
    is moved and cast in place). ``dtype`` is the
    model's (f32 or bf16): its floating tensors and the images are cast to
    it, and the floating outputs come back in f32, as in the JAX
    predictor. ``devices`` (``parallel/mesh.py::resolve_devices``): more
    than one shards each batch across a replica per device, the batch
    padded with blank canvases to a multiple of their number, as tpuseg's.
    The image sizes default to the config's test sizes where it has them
    (ViTDet's 1024), else 800 and 1333.
    """

    def __init__(self, cfg=None, weights: str | None = None, model=None,
                 confidence_threshold: float = 0.5,
                 min_image_size: int | None = None,
                 max_image_size: int | None = None, device="cuda",
                 seed: int = 0, variant: str = "fpn",
                 dtype: torch.dtype = torch.float32, devices=None):
        if (torch.device(device).type == "cuda"
                and not torch.cuda.is_available()):
            raise RuntimeError("device 'cuda' requested but CUDA is unavailable")
        device_list = resolve_devices(devices, device)
        self.device = device_list[0]
        self.n_devices = len(device_list)
        if model is None:
            cfg = cfg or VARIANTS[variant][1]()
            if weights:
                from tpuseg_torch.weights.detectron_map import (
                    load_detectron_weights)

                model = load_detectron_weights(weights, build_model(cfg))
            else:
                model = build_model(cfg, torch.Generator().manual_seed(seed))
        self.model = model.to(self.device, dtype).eval()
        self.dtype = dtype
        self.cfg = self.model.cfg
        self.variant = variant_of(self.cfg)
        self._forward = model_module(self.cfg).forward_inference
        self.confidence_threshold = confidence_threshold
        self.min_image_size = min_image_size or getattr(
            self.cfg, "min_size_test", 800)
        self.max_image_size = max_image_size or getattr(
            self.cfg, "max_size_test", 1333)
        self.rgb_norm = ((self.cfg.pixel_mean, self.cfg.pixel_std)
                         if hasattr(self.cfg, "pixel_std") else None)
        self._sharded = (ShardedInference(self._run, self.model, device_list,
                                          n_batch_args=2)
                         if self.n_devices > 1 else None)

    def _run(self, model, images: torch.Tensor, image_hw: torch.Tensor):
        out = self._forward(model, images.to(self.dtype), image_hw)
        return {k: v.float() if v.is_floating_point() else v
                for k, v in out.items()}

    def forward(self, images: torch.Tensor, image_hw: torch.Tensor) -> dict:
        """The model's ``forward_inference`` on canvases [B, 3, Hc, Wc]
        cast to the predictor's dtype -> padded detections, floating ones
        in f32 (with several devices: B must divide across them)."""
        with timer.span("predictor.run"):
            if self._sharded is not None:
                return self._sharded(images, image_hw)
            return self._run(self.model, images, image_hw)

    def run_on_bgr_image(self, img_bgr: np.ndarray) -> dict:
        """Single image -> final detections in original-image coords."""
        return self.run_on_bgr_images([img_bgr])[0]

    def run_on_bgr_images(self, imgs_bgr: list) -> list:
        """Batched inference; the images must share one canvas orientation.
        Returns, per image, numpy ``boxes``, ``scores``, ``classes`` (0-based)
        and, where the model has a mask head, ``masks`` [n, h, w] uint8."""
        with timer.span("predictor.request"):
            with timer.span("predictor.canvas"):
                images, hws = self._canvases(imgs_bgr)
            scales = [(th / img.shape[0], tw / img.shape[1])
                      for (th, tw), img in zip(hws, imgs_bgr)]
            image_hw = torch.tensor(hws, dtype=torch.int64,
                                    device=self.device)
            with torch.inference_mode():
                out = self.forward(images, image_hw)
                results = []
                for i, img in enumerate(imgs_bgr):
                    h, w = img.shape[:2]
                    with timer.span("predictor.paste"):
                        valid = out["valid"][i]
                        sy, sx = scales[i]
                        boxes = out["boxes"][i][valid].clone()
                        boxes[:, 0::2] = (boxes[:, 0::2] / sx).clamp(0, w - 1)
                        boxes[:, 1::2] = (boxes[:, 1::2] / sy).clamp(0, h - 1)
                        res = {"boxes": boxes,
                               "scores": out["scores"][i][valid],
                               "classes": out["classes"][i][valid]}
                        if "masks" in out:  # none for Faster R-CNN, RetinaNet
                            res["masks"] = paste_masks(
                                out["masks"][i][valid], boxes, h, w)
                    with timer.span("predictor.download"):
                        res = {k: v.cpu().numpy() for k, v in res.items()}
                    timer.count("predictor.download_bytes",
                                sum(v.nbytes for v in res.values()))
                    results.append(res)
        timer.count("predictor.images", len(results))
        timer.count("predictor.masks", sum(len(r["scores"]) for r in results))
        return results

    def _canvases(self, imgs_bgr: list) -> tuple:
        """The batch's canvases on the device, f32 [B + pad, 3, Hc, Wc],
        and each canvas' real (h, w). The shards must divide across the
        devices: blank canvases of size 1 x 1 fill the batch (1 image on 8
        devices pads to 8)."""
        geometry = [canvas_geometry(*img.shape[:2], self.min_image_size,
                                    self.max_image_size) for img in imgs_bgr]
        if len({chw for _, chw in geometry}) != 1:
            raise ValueError("a batch must share one canvas orientation")
        hws = [hw for hw, _ in geometry]
        pad = (-len(imgs_bgr)) % self.n_devices
        if self.device.type == "cuda":
            mean, std = self.rgb_norm or (DETECTRON_PIXEL_MEAN_BGR, None)
            images, sent = CV.build_canvas(imgs_bgr, hws, geometry[0][1],
                                           mean, std, pad, self.device)
            timer.count("predictor.canvases_on_device", len(imgs_bgr))
        else:
            canvases = [preprocess_image_bgr(img, self.min_image_size,
                                             self.max_image_size,
                                             self.rgb_norm)[0]
                        for img in imgs_bgr]
            canvases += [np.zeros_like(canvases[0])] * pad
            images = torch.from_numpy(np.stack(canvases).transpose(
                0, 3, 1, 2).copy()).to(self.device)
            sent = images.nbytes
        timer.count("predictor.upload_bytes", sent)
        return images, hws + [(1, 1)] * pad

    def select_top_predictions(self, preds: dict) -> dict:
        keep = preds["scores"] >= self.confidence_threshold
        order = np.argsort(-preds["scores"][keep], kind="stable")
        return {k: v[keep][order] for k, v in preds.items()}


# ---------------------------------------------------------------------------
# Config-file dispatch (yacs tree -> model config -> predictor)
# ---------------------------------------------------------------------------


def _cfg_get(node, path: str, default):
    """Dotted-path lookup into a ConfigNode/dict tree with a default."""
    cur = node
    for part in path.split("."):
        try:
            cur = cur[part]
        except (KeyError, TypeError):
            return default
    return cur


def model_config_from_node(node) -> tuple:
    """yacs-style tree (a ConfigNode after ``merge_from_file``) ->
    (variant, model config), as tpuseg's: MODEL.META_ARCHITECTURE
    "RetinaNet" is RetinaNet, a CONV_BODY ending in "-C4" the C4 models,
    else the FPN ones; the depth from the CONV_BODY, MODEL.MASK_ON (False:
    Faster R-CNN), NUM_CLASSES, the RPN top-N constants and C4's pooler
    sampling ratio, or RetinaNet's PRE_NMS_TOP_N, INFERENCE_TH and NMS_TH
    from the yaml."""
    def get(path, default):
        return _cfg_get(node, path, default)

    conv_body = get("MODEL.BACKBONE.CONV_BODY", "R-50-FPN")
    num_classes = int(get("MODEL.ROI_BOX_HEAD.NUM_CLASSES", 81))
    mask_on = bool(get("MODEL.MASK_ON", True))
    depth = 101 if "101" in conv_body else 50
    if get("MODEL.META_ARCHITECTURE", "GeneralizedRCNN") == "RetinaNet":
        return "retinanet", RN.RetinaNetConfig(
            depth=depth,
            num_classes=int(get("MODEL.RETINANET.NUM_CLASSES", num_classes)),
            pre_nms_top_n=int(get("MODEL.RETINANET.PRE_NMS_TOP_N", 1000)),
            score_thresh=float(get("MODEL.RETINANET.INFERENCE_TH", 0.05)),
            nms_thresh=float(get("MODEL.RETINANET.NMS_TH", 0.4)))
    if conv_body.endswith("-C4"):
        return "c4", C4.MaskRCNNC4Config(
            depth=depth,
            rpn_pre_nms_top_n=int(get("MODEL.RPN.PRE_NMS_TOP_N_TEST", 6000)),
            rpn_post_nms_top_n=int(get("MODEL.RPN.POST_NMS_TOP_N_TEST", 1000)),
            rpn_pre_nms_top_n_train=int(
                get("MODEL.RPN.PRE_NMS_TOP_N_TRAIN", 12000)),
            rpn_post_nms_top_n_train=int(
                get("MODEL.RPN.POST_NMS_TOP_N_TRAIN", 2000)),
            pooler_sampling_ratio=int(
                get("MODEL.ROI_BOX_HEAD.POOLER_SAMPLING_RATIO", 0)),
            num_classes=num_classes, mask_on=mask_on)
    return "fpn", M.MaskRCNNConfig(
        depth=depth,
        rpn_pre_nms_top_n=int(get("MODEL.RPN.PRE_NMS_TOP_N_TEST", 1000)),
        rpn_post_nms_top_n=int(get("MODEL.RPN.POST_NMS_TOP_N_TEST", 1000)),
        fpn_post_nms_top_n=int(get("MODEL.RPN.FPN_POST_NMS_TOP_N_TEST", 1000)),
        fpn_post_nms_top_n_train=int(
            get("MODEL.RPN.FPN_POST_NMS_TOP_N_TRAIN", 2000)),
        num_classes=num_classes, mask_on=mask_on)


def build_predictor_from_cfg(node, **kw) -> MaskRCNNPredictor:
    """ConfigNode -> MaskRCNNPredictor for its variant and model config,
    with MODEL.WEIGHT and INPUT.{MIN,MAX}_SIZE_TEST; ``kw`` goes to the
    predictor (``device``, ``devices``, ``confidence_threshold``,
    ``dtype``)."""
    _, cfg = model_config_from_node(node)
    return MaskRCNNPredictor(
        cfg=cfg,
        weights=_cfg_get(node, "MODEL.WEIGHT", "") or None,
        min_image_size=int(_cfg_get(node, "INPUT.MIN_SIZE_TEST", 800)),
        max_image_size=int(_cfg_get(node, "INPUT.MAX_SIZE_TEST", 1333)),
        **kw)


# ---------------------------------------------------------------------------
# COCO evaluation loop (tools/test_net.py parity)
# ---------------------------------------------------------------------------

# contiguous class id (0-based, no bg) -> COCO category id
COCO_CATEGORY_IDS = [
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 14, 15, 16, 17, 18, 19, 20, 21,
    22, 23, 24, 25, 27, 28, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42,
    43, 44, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61,
    62, 63, 64, 65, 67, 70, 72, 73, 74, 75, 76, 77, 78, 79, 80, 81, 82, 84,
    85, 86, 87, 88, 89, 90,
]


def evaluate_coco(predictor: MaskRCNNPredictor, dataset, max_images=None,
                  progress=True, batch_size: int = 1) -> dict:
    """COCO bbox + segm evaluation with the port's COCOeval -> {iou_type:
    the 12 stats}.

    ``batch_size`` > 1 buckets images by orientation (each bucket shares a
    canvas) and runs one forward per bucket batch; the leftovers of each
    bucket run one by one. A predictor is anything with
    ``run_on_bgr_image`` and ``run_on_bgr_images``. Boxes are written as
    ``[x1, y1, x2 - x1 + 1, y2 - y1 + 1]`` (upstream's TO_REMOVE = 1).
    """
    import time

    from tpuseg_torch.data.image_io import resize_bilinear_u8
    from tpuseg_torch.eval import rle as rle_mod
    from tpuseg_torch.eval.cocoeval import COCOeval

    ids = dataset.image_ids
    if max_images:
        ids = ids[:max_images]
    results = []
    t0 = time.perf_counter()
    n = 0

    def load_bgr(iid):
        img = dataset.load_image(iid)[:, :, ::-1]
        info = dataset.coco.imgs[iid]
        if img.shape[:2] != (info["height"], info["width"]):
            # load_image decodes in the annotation frame (EXIF ignored), so
            # a mismatch means the json metadata itself is wrong; conform
            # the pixels so the image lands in the right orientation bucket
            # and scores in the annotation frame
            img = resize_bilinear_u8(img, info["height"], info["width"])
        return img

    def consume(batch_ids):
        nonlocal n
        imgs = [load_bgr(i) for i in batch_ids]
        if len(imgs) == 1:  # single-image path (also duck-typed oracles)
            preds_list = [predictor.run_on_bgr_image(imgs[0])]
        else:
            preds_list = predictor.run_on_bgr_images(imgs)
        for iid, preds in zip(batch_ids, preds_list):
            for i in range(len(preds["scores"])):
                x1, y1, x2, y2 = preds["boxes"][i]
                det = {
                    "image_id": int(iid),
                    "category_id": COCO_CATEGORY_IDS[int(preds["classes"][i])],
                    "bbox": [float(x1), float(y1), float(x2 - x1 + 1),
                             float(y2 - y1 + 1)],
                    "score": float(preds["scores"][i]),
                }
                if "masks" in preds:
                    det["segmentation"] = rle_mod.encode(preds["masks"][i])
                results.append(det)
            n += 1
            if progress and n % 20 == 0:
                print(f"\r{n}/{len(ids)} "
                      f"({n / (time.perf_counter() - t0):.2f} img/s)",
                      end="", flush=True)

    buckets: dict[bool, list] = {True: [], False: []}
    for iid in ids:
        info = dataset.coco.imgs[iid]
        landscape = info["width"] >= info["height"]
        buckets[landscape].append(iid)
        if len(buckets[landscape]) == batch_size:
            consume(buckets[landscape])
            buckets[landscape] = []
    for rest in buckets.values():
        for iid in rest:  # leftovers run singly (different pad would skew)
            consume([iid])
    if progress:
        print()
    stats = {}
    has_masks = any("segmentation" in r for r in results)
    for iou_type in ("bbox", "segm") if has_masks else ("bbox",):
        print(f"== {iou_type} ==")
        E = COCOeval(dataset.coco, dataset.coco.loadRes(results), iou_type)
        E.evaluate()
        E.accumulate()
        E.summarize()
        stats[iou_type] = E.stats
    return stats
