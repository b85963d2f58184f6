"""YOLOv3 predictor, training step and COCO evaluation (port of
``tpuseg/engine/yolo_engine.py`` and of the step ``tools/yolo_train.py``
builds; yolo.jittor detect.py, test.py and train.py).

:class:`YoloPredictor` letterboxes a zero-padded uint8 batch on the device
(``ops/preprocess.py::letterbox_preprocess``, f32), runs the model in
``dtype`` and decodes in f32: one NMS kernel launch a batch on the card.
:class:`YoloTrainer` is the training step: train-mode BatchNorm, SGD with
momentum 0.9 and weight decay 5e-4 on every parameter (BatchNorm's running
statistics are buffers, which SGD never sees), and the 1000-step burn-in
lr * min(1, (it + 1) / 1000). :func:`evaluate_coco_boxes` runs COCOeval on
bbox over a dataset on one static canvas.
"""
from __future__ import annotations

import numpy as np
import torch

from tpuseg_torch.data.image_io import resize_bilinear_u8
from tpuseg_torch.models import yolov3 as Y
from tpuseg_torch.models.yolov3_loss import total_loss
from tpuseg_torch.ops.preprocess import letterbox_preprocess

MOMENTUM = 0.9
WEIGHT_DECAY = 5e-4
BURN_IN = 1000


def unletterbox_boxes(boxes: np.ndarray, h: int, w: int,
                      input_size: int) -> np.ndarray:
    """Boxes in ``input_size`` letterbox coordinates -> the original
    image's pixels, clipped to the image (detect.py's undo-letterbox)."""
    scale = input_size / max(h, w)
    pad_x = (input_size - w * scale) / 2
    pad_y = (input_size - h * scale) / 2
    out = boxes.copy()
    out[:, 0::2] = np.clip((out[:, 0::2] - pad_x) / scale, 0, w)
    out[:, 1::2] = np.clip((out[:, 1::2] - pad_y) / scale, 0, h)
    return out


def load_yolo_state_dict(weights: str, cfg: Y.YoloV3Config) -> dict:
    """A darknet ``.weights`` file (through ``weights/darknet_io.py``), or
    anything else as the JAX package's npz params -> the port's
    state_dict."""
    if weights.endswith(".weights"):
        from tpuseg_torch.weights.darknet_io import load_yolov3_weights

        return load_yolov3_weights(weights, Y.build_model(cfg)).state_dict()
    from tpuseg_torch.weights.from_jax import yolov3_state_dict_from_jax
    from tpuseg_torch.weights.npz_io import load_params_npz

    return yolov3_state_dict_from_jax(load_params_npz(weights))


def build_yolo(cfg: Y.YoloV3Config, state_dict: dict | None,
               weights: str | None) -> Y.YoloV3:
    """A CPU model from a state_dict, a weights file, or random weights
    from a ``torch.Generator`` seeded with 0."""
    if weights:
        state_dict = load_yolo_state_dict(weights, cfg)
    model = Y.build_model(
        cfg, None if state_dict else torch.Generator().manual_seed(0))
    if state_dict:
        model.load_state_dict(state_dict, strict=True)
    return model


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but CUDA is unavailable")
    return device


class YoloPredictor:
    """YOLOv3 inference on ``device``. Weights: a ``state_dict`` (the
    port's keys), a ``weights`` file (darknet ``.weights`` or the JAX
    npz), or random ones. ``dtype`` casts the params and the letterboxed
    images (f32 or bf16), as the JAX predictor does; detections come back
    in f32."""

    def __init__(self, cfg: Y.YoloV3Config | None = None,
                 state_dict: dict | None = None, weights: str | None = None,
                 batch_size: int = 1, dtype: torch.dtype = torch.float32,
                 device="cuda"):
        self.device = _device(device)
        self.cfg = cfg or Y.YoloV3Config()
        self.batch_size = batch_size
        self.dtype = dtype
        self.model = build_yolo(self.cfg, state_dict, weights).to(
            self.device, dtype).eval()

    def detect(self, images_u8: torch.Tensor, hw: torch.Tensor) -> dict:
        """uint8 [B, H, W, 3] and (h, w) [B, 2] on the device -> padded
        detections on the device."""
        x = letterbox_preprocess(images_u8, hw, size=self.cfg.input_size)
        return Y.detect(self.model, x.to(self.dtype), self.cfg)

    def run_batch(self, images_u8_padded: np.ndarray, hw: np.ndarray) -> dict:
        """uint8 RGB [B, H, W, 3] zero-padded to one canvas, each image's
        (h, w) [B, 2] -> numpy {boxes [B, max_det, 4] letterbox px,
        scores, classes, valid}."""
        images = np.require(images_u8_padded, requirements="W")
        with torch.inference_mode():
            out = self.detect(torch.from_numpy(images).to(self.device),
                              torch.as_tensor(hw).to(self.device))
            return {k: v.cpu().numpy() for k, v in out.items()}

    def unletterbox(self, boxes: np.ndarray, h: int, w: int) -> np.ndarray:
        return unletterbox_boxes(boxes, h, w, self.cfg.input_size)


class YoloTrainer:
    """The YOLOv3 training step on ``device`` (``tools/yolo_train.py``'s):
    a model built from ``state_dict``/``weights`` or random weights, SGD
    at ``lr`` with the burn-in."""

    def __init__(self, cfg: Y.YoloV3Config | None = None,
                 state_dict: dict | None = None, weights: str | None = None,
                 lr: float = 1e-3, device="cuda"):
        self.device = _device(device)
        self.cfg = cfg or Y.YoloV3Config()
        self.base_lr = lr
        self.model = build_yolo(self.cfg, state_dict, weights).to(self.device)
        self.optimizer = torch.optim.SGD(
            self.model.parameters(), lr=lr, momentum=MOMENTUM,
            weight_decay=WEIGHT_DECAY)

    def losses(self, images_u8, hw, gt_boxes, gt_classes) -> dict:
        """The training forward, the model in train mode: uint8 [B, H, W,
        3] on a canvas, (h, w) [B, 2], gt boxes [B, G, 4] in letterbox px,
        classes [B, G] (-1 pads) -> the loss terms."""
        self.model.train()
        param = next(self.model.parameters())
        x = letterbox_preprocess(images_u8.to(self.device),
                                 hw.to(self.device), size=self.cfg.input_size)
        outs = self.model(x.to(param.dtype))
        return total_loss(outs, gt_boxes.to(self.device, param.dtype),
                          gt_classes.to(self.device), self.cfg)

    def train_step(self, images_u8, hw, gt_boxes, gt_classes,
                   it: int) -> dict:
        """One SGD step at iteration ``it`` -> the loss terms before it
        (detached)."""
        losses = self.losses(images_u8, hw, gt_boxes, gt_classes)
        for group in self.optimizer.param_groups:
            group["lr"] = self.base_lr * min(1.0, (it + 1) / BURN_IN)
        self.optimizer.zero_grad(set_to_none=False)
        losses["total"].backward()
        self.optimizer.step()
        return {k: v.detach() for k, v in losses.items()}


def evaluate_coco_boxes(predictor: YoloPredictor, dataset, max_images=None,
                        progress=True):
    """COCOeval on bbox over ``dataset`` (test.py's mAP): the images in
    batches of ``predictor.batch_size`` on one static canvas (the dataset's
    largest height and width, each rounded up to 32), padded slots with
    (h, w) = (1, 1) -> COCOeval's 12 stats."""
    from tpuseg_torch.engine.maskrcnn_engine import COCO_CATEGORY_IDS
    from tpuseg_torch.eval.cocoeval import COCOeval

    ids = dataset.image_ids
    if max_images:
        ids = ids[:max_images]
    bs = predictor.batch_size
    maxh = maxw = 1
    for iid in ids:
        info = dataset.coco.imgs[iid]
        maxh = max(maxh, info["height"])
        maxw = max(maxw, info["width"])
    maxh = -(-maxh // 32) * 32
    maxw = -(-maxw // 32) * 32
    results = []
    for start in range(0, len(ids), bs):
        chunk = ids[start:start + bs]
        imgs = []
        for iid in chunk:
            img = dataset.load_image(iid)
            info = dataset.coco.imgs[iid]
            if img.shape[:2] != (info["height"], info["width"]):
                # a decode that disagrees with the json (EXIF rotation):
                # the annotations live in the json's frame
                img = resize_bilinear_u8(img, info["height"], info["width"])
            imgs.append(img)
        batch = np.zeros((bs, maxh, maxw, 3), np.uint8)
        # padded slots keep hw = (1, 1): (0, 0) makes the letterbox scale
        # infinite and the grid NaN
        hw = np.ones((bs, 2), np.int32)
        for i, img in enumerate(imgs):
            batch[i, :img.shape[0], :img.shape[1]] = img
            hw[i] = img.shape[:2]
        dets = predictor.run_batch(batch, hw)
        for i, iid in enumerate(chunk):
            valid = dets["valid"][i]
            boxes = predictor.unletterbox(dets["boxes"][i][valid],
                                          *imgs[i].shape[:2])
            scores = dets["scores"][i][valid]
            classes = dets["classes"][i][valid]
            for j in range(len(scores)):
                x1, y1, x2, y2 = boxes[j]
                results.append({
                    "image_id": int(iid),
                    "category_id": COCO_CATEGORY_IDS[int(classes[j])],
                    "bbox": [float(x1), float(y1), float(x2 - x1),
                             float(y2 - y1)],
                    "score": float(scores[j]),
                })
        if progress:
            print(f"\r{min(start + bs, len(ids))}/{len(ids)}", end="",
                  flush=True)
    if progress:
        print()
    E = COCOeval(dataset.coco, dataset.coco.loadRes(results), "bbox")
    E.evaluate()
    E.accumulate()
    E.summarize()
    return E.stats
