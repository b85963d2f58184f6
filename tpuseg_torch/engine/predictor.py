"""COCODemo, the reference's predictor facade (port of
``tpuseg/engine/predictor.py``): every yaml in ``configs/``, Mask R-CNN and
Faster R-CNN over FPN or C4 and RetinaNet::

    from tpuseg_torch.engine.predictor import COCODemo
    coco_demo = COCODemo(cfg, confidence_threshold=0.5, device="cuda")
    predictions = coco_demo.run_on_opencv_image(image)  # BGR in, BGR out
"""
from __future__ import annotations

import numpy as np

from tpuseg_torch.engine.maskrcnn_engine import (MaskRCNNPredictor, _cfg_get,
                                                 model_config_from_node)

CATEGORIES = [
    "__background", "person", "bicycle", "car", "motorcycle", "airplane",
    "bus", "train", "truck", "boat", "traffic light", "fire hydrant",
    "stop sign", "parking meter", "bench", "bird", "cat", "dog", "horse",
    "sheep", "cow", "elephant", "bear", "zebra", "giraffe", "backpack",
    "umbrella", "handbag", "tie", "suitcase", "frisbee", "skis", "snowboard",
    "sports ball", "kite", "baseball bat", "baseball glove", "skateboard",
    "surfboard", "tennis racket", "bottle", "wine glass", "cup", "fork",
    "knife", "spoon", "bowl", "banana", "apple", "sandwich", "orange",
    "broccoli", "carrot", "hot dog", "pizza", "donut", "cake", "chair",
    "couch", "potted plant", "bed", "dining table", "toilet", "tv", "laptop",
    "mouse", "remote", "keyboard", "cell phone", "microwave", "oven",
    "toaster", "sink", "refrigerator", "book", "clock", "vase", "scissors",
    "teddy bear", "hair drier", "toothbrush",
]


class COCODemo:
    def __init__(self, cfg=None, min_image_size: int | None = None,
                 confidence_threshold: float = 0.7, weights: str | None = None,
                 device="cuda"):
        """``cfg``: None (Mask R-CNN R-50-FPN defaults) or a ConfigNode,
        which picks the model (see ``model_config_from_node``) and whose
        MODEL.WEIGHT and INPUT sizes are honoured unless overridden."""
        model_cfg, max_size = None, 1333
        if cfg is not None:
            _, model_cfg = model_config_from_node(cfg)
            weights = weights or _cfg_get(cfg, "MODEL.WEIGHT", "") or None
            if min_image_size is None:
                min_image_size = int(_cfg_get(cfg, "INPUT.MIN_SIZE_TEST", 800))
            max_size = int(_cfg_get(cfg, "INPUT.MAX_SIZE_TEST", 1333))
        self.predictor = MaskRCNNPredictor(
            cfg=model_cfg, weights=weights,
            confidence_threshold=confidence_threshold,
            min_image_size=min_image_size or 800, max_image_size=max_size,
            device=device)
        self.confidence_threshold = confidence_threshold

    def compute_prediction(self, image_bgr: np.ndarray) -> dict:
        return self.predictor.run_on_bgr_image(image_bgr)

    def select_top_predictions(self, predictions: dict) -> dict:
        return self.predictor.select_top_predictions(predictions)

    def run_on_opencv_image(self, image_bgr: np.ndarray) -> np.ndarray:
        """BGR image -> BGR image with boxes, labels and (where the model
        has a mask head) masks drawn."""
        from tpuseg_torch.data.image_io import draw_detections

        preds = self.select_top_predictions(self.compute_prediction(image_bgr))
        labels = [f"{CATEGORIES[int(c) + 1]}: {s:.2f}"
                  for c, s in zip(preds["classes"], preds["scores"])]
        return draw_detections(image_bgr, preds["boxes"],
                               preds.get("masks", ()), labels)
