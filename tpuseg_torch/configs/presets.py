"""Model presets (the port's copy of ``tpuseg/configs/presets.py``): the
ViT presets as ConfigNodes in ``engine/config.py``'s registry
(``get_config("vit_b16_config")``), the YOLACT presets as plain dicts.

Upstream's ``--config=<name>_config`` chains (Yolact.jittor
``data/config.py``): a preset is its parent's dict updated with its own
keys; its ``dataset`` names an entry of :data:`DATASETS`.
:func:`yolact_model_config` turns one into a
:class:`~tpuseg_torch.models.yolact.YolactConfig`, :func:`yolact_loss_config`
into a :class:`~tpuseg_torch.models.yolact_loss.YolactLossConfig`.
"""
from __future__ import annotations

from tpuseg_torch.engine.config import ConfigNode, register_config
from tpuseg_torch.models.yolact import YolactConfig
from tpuseg_torch.models.yolact_loss import YolactLossConfig

# ViT (ViT.jittor)
vit_b16_config = register_config("vit_b16_config", ConfigNode({
    "name": "vit_b16", "model": "vit", "image_size": 224, "patch_size": 16,
    "hidden_size": 768, "num_layers": 12, "num_heads": 12, "mlp_dim": 3072,
    "num_classes": 1000}))
vit_l16_config = register_config("vit_l16_config", vit_b16_config.copy({
    "name": "vit_l16", "hidden_size": 1024, "num_layers": 24,
    "num_heads": 16, "mlp_dim": 4096}))

_SCALES = (24, 48, 96, 192, 384)

YOLACT_BASE = {
    "name": "yolact_base",
    "backbone": "resnet101",
    "max_size": 550,
    "num_classes": 81,
    "mask_dim": 32,
    "fpn_channels": 256,
    "conf_thresh": 0.05,
    "nms_thresh": 0.5,
    "nms_top_k": 200,
    "max_num_detections": 100,
    "dataset": "coco2017_dataset",
}

# YOLACT++: DCNv2 backbone, 3 sub-scales per level, non-square anchors,
# mask rescoring
_PLUS = {
    "use_square_anchors": False,
    "scales": tuple(tuple(s * 2 ** (j / 3.0) for j in range(3))
                    for s in _SCALES),
    "dcn_backbone": True,
    "use_maskiou": True,
}

PRESETS = {
    "yolact_base": YOLACT_BASE,
    "yolact_resnet50": {**YOLACT_BASE, "name": "yolact_resnet50",
                        "backbone": "resnet50"},
    "yolact_darknet53": {**YOLACT_BASE, "name": "yolact_darknet53",
                         "backbone": "darknet53"},
    # the anchor scales follow the input size (upstream int(s / 550 * size))
    "yolact_im400": {**YOLACT_BASE, "name": "yolact_im400", "max_size": 400,
                     "scales": tuple(int(s / 550 * 400) for s in _SCALES)},
    "yolact_im700": {**YOLACT_BASE, "name": "yolact_im700", "max_size": 700,
                     "scales": tuple(int(s / 550 * 700) for s in _SCALES),
                     "masks_to_train": 300},
    "yolact_plus_base": {**YOLACT_BASE, **_PLUS, "name": "yolact_plus_base"},
    # resnet50_dcnv2_backbone: R50++ makes every block of stages 2-4
    # deformable
    "yolact_plus_resnet50": {**YOLACT_BASE, **_PLUS,
                             "name": "yolact_plus_resnet50",
                             "backbone": "resnet50"},
}


# dataset presets (yolact data/config.py dataset_base / coco2017_dataset),
# named by each YOLACT preset's "dataset"
DATASET_BASE = {
    "name": "Base Dataset",
    "train_images": "./data/coco/images/",
    "train_info": "path_to_annotation_file",
    "valid_images": "./data/coco/images/",
    "valid_info": "path_to_annotation_file",
    "has_gt": True,
    "class_names": [],
}

DATASETS = {
    "dataset_base": DATASET_BASE,
    "coco2017_dataset": {
        **DATASET_BASE, "name": "COCO 2017",
        "train_images": "./data/coco/train2017/",
        "train_info": "./data/coco/annotations/instances_train2017.json",
        "valid_images": "./data/coco/val2017/",
        "valid_info": "./data/coco/annotations/instances_val2017.json"},
}


def yolact_model_config(preset) -> YolactConfig:
    """A preset (its name, with or without upstream's ``_config`` suffix,
    or its dict) -> YolactConfig."""
    cfg = _preset(preset)
    return YolactConfig(
        backbone=cfg["backbone"], img_size=cfg["max_size"],
        num_classes=cfg["num_classes"], mask_dim=cfg["mask_dim"],
        fpn_channels=cfg["fpn_channels"], conf_thresh=cfg["conf_thresh"],
        nms_iou_thresh=cfg["nms_thresh"], nms_top_k=cfg["nms_top_k"],
        max_num_detections=cfg["max_num_detections"],
        scales=cfg.get("scales", _SCALES),
        use_square_anchors=cfg.get("use_square_anchors", True),
        dcn_backbone=cfg.get("dcn_backbone", False),
        use_maskiou=cfg.get("use_maskiou", False))


def _preset(preset) -> dict:
    return PRESETS[preset.removesuffix("_config")] if isinstance(
        preset, str) else preset


def yolact_loss_config(preset) -> YolactLossConfig:
    """A preset -> the loss's training hyperparameters that vary per preset
    (``masks_to_train``: 300 for im700, else 100; ``use_maskiou`` for ++)."""
    cfg = _preset(preset)
    return YolactLossConfig(masks_to_train=cfg.get("masks_to_train", 100),
                            use_maskiou=cfg.get("use_maskiou", False))
